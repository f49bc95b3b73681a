"""CUDA graphs of launch-bound functions, captured once per shape and replayed.

A function that issues hundreds of small kernels on tensors of a few hundred
thousand elements spends its time in the host's issue, not on the card.
`GraphCache.run(key, fn, make_inputs)` runs such a function as a CUDA graph
(`torch.cuda.graphs`): the same kernels in the same order, issued by one
graph launch.

* The first call with a key returns None, and the caller runs its own eager
  code. That run fills the caller's lazily uploaded constants and creates the
  library handles, none of which may happen during a capture.
* The second call warms `fn` up once on a side stream (the libraries' per
  stream workspaces), captures it on that stream and replays it.
* Later calls replay. A replay copies the inputs into the graph's static input
  buffers, launches the graph on the current stream and returns copies of its
  outputs, so a result the caller keeps (and may feed back in) is never
  overwritten by a later replay of the same graph.

The key must hold everything that changes the captured work besides the
inputs' values: their shapes, dtypes and device, and every Python value `fn`
reads, which the capture bakes in as constants. A tensor that `fn` reads and
that is not among its inputs must live as long as the graph. The cache is
bounded: past `maxsize` keys the least recently used one is dropped, with its
graph and memory; a cache of size 0 never replays.
"""
import threading
from collections import OrderedDict

import torch


class _Graph:
    """One captured call of fn: its static inputs and outputs."""

    def __init__(self, fn, inputs):
        self.inputs = tuple(t.clone() for t in inputs)
        stream = torch.cuda.Stream(device=self.inputs[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's allocations and copies (a pipelined
        # preparation on its own stream) do not end the capture
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.outputs = tuple(fn(*self.inputs))
        torch.cuda.current_stream().wait_stream(stream)

    def replay(self, inputs):
        for static, t in zip(self.inputs, inputs):
            static.copy_(t)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


class GraphCache:
    """Graphs by key, the `maxsize` most recently used (module docstring)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._graphs = OrderedDict()        # key -> _Graph, or None when seen once
        self._lock = threading.Lock()

    def run(self, key, fn, make_inputs):
        """fn(*make_inputs()) replayed as a graph: copies of its outputs, or
        None where the caller runs eagerly (the key's first call). fn takes
        and returns a tuple of CUDA tensors; make_inputs is called only when
        the graph runs."""
        with self._lock:
            if key not in self._graphs:
                if self.maxsize > 0:
                    self._graphs[key] = None
                    self._trim()
                return None
            self._graphs.move_to_end(key)
            inputs = make_inputs()
            graph = self._graphs[key]
            if graph is None:
                graph = self._graphs[key] = _Graph(fn, inputs)
            return graph.replay(inputs)

    def __len__(self) -> int:
        """The number of keys held, seen once or captured."""
        return len(self._graphs)

    def captured(self) -> int:
        """The number of keys that hold a graph."""
        return sum(g is not None for g in self._graphs.values())

    def _trim(self):
        while len(self._graphs) > self.maxsize:
            self._graphs.popitem(last=False)
