"""What the traced run records, from the benchmark's side of the calls into
each layer of the port (nothing in the port is edited):

* host spans: (name, start, end) in the profiler's clock (time.time_ns) around
  calls that the benchmark wraps on the tracker and its module;
* kernel calls: each call of the port's kernel entry points, its name,
  operand shapes and type, timed by CUDA events around its launches, read
  once the window has closed;
* device intervals: every kernel, copy and set kept by torch.profiler over a
  sub-window, as (start, end) nanoseconds, with their names.

Each wrapper is undone by `restore`, so a run leaves the port as it found it.
"""
import functools
import threading
import time

import torch


class Patches:
    """Attribute replacements that `restore` undoes in reverse order."""

    def __init__(self):
        self._saved = []

    def set(self, owner, name, value):
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        while self._saved:
            owner, name, value = self._saved.pop()
            setattr(owner, name, value)


class HostSpans:
    """Host spans in the profiler's clock, kept in memory."""

    def __init__(self):
        self.spans = []         # (name, start_ns, end_ns, thread id)

    def wrap(self, patches: Patches, owner, attr: str, name: str):
        fn = getattr(owner, attr)
        spans = self.spans

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.time_ns(), _thread_id()))
        patches.set(owner, attr, spanned)


def _thread_id():
    return threading.get_ident()


def _shape_of(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else None


class KernelCalls:
    """The port's kernel calls: `wrap` an entry point to take each call's
    kernel, operand shapes, type and `extra` (a function of the call's
    arguments), and `wrap_launch` the one function through which every entry
    point launches (ops/kernels/build.py's `launch`) to put CUDA events
    right around each launch, so that a call's time is its launches' alone,
    not the host's work around them. `read` synchronises and returns the
    calls with their milliseconds."""

    def __init__(self):
        self.calls = []
        self._open = threading.local()

    def wrap(self, patches: Patches, owner, attr: str, kernel: str, extra=None):
        fn = getattr(owner, attr)
        calls, local = self.calls, self._open

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            local.events = events = []
            try:
                out = fn(*args, **kwargs)
            finally:
                local.events = None
            if events:
                x = args[0]
                calls.append((kernel, [_shape_of(a) for a in args], x.dtype,
                              None if extra is None else extra(*args, **kwargs),
                              time.time_ns(), events))
            return out
        patches.set(owner, attr, timed)

    def wrap_launch(self, patches: Patches, owner, attr: str = "launch"):
        fn = getattr(owner, attr)
        local = self._open

        @functools.wraps(fn)
        def launched(*args, **kwargs):
            events = getattr(local, "events", None)
            if events is None:
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out
        patches.set(owner, attr, launched)

    def read(self):
        torch.cuda.synchronize()
        return [dict(kernel=k, shapes=s, dtype=str(d).replace("torch.", ""), extra=e, t_ns=t,
                     ms=sum(a.elapsed_time(b) for a, b in ev))
                for k, s, d, e, t, ev in self.calls]


class DeviceTrace:
    """torch.profiler over a sub-window: start() and stop() on the host;
    `intervals` then holds every device event (kernel, copy, set) as
    (name, start_ns, end_ns), and `kernel_names` the kernels' names."""

    def __init__(self):
        self.prof = None
        self.intervals = []
        self.t0_ns = self.t1_ns = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self):
        if self.prof is None or self.t1_ns is not None:
            return
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        out = []
        for e in events:
            if not str(e.device_type()).endswith("CUDA"):
                continue
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
        self.intervals = sorted(out, key=lambda v: v[1])
        self.prof = None
