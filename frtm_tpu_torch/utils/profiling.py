"""Named phase timers (frtm_tpu/utils/profiling.py).

`PhaseTimer(sync=True)` synchronises the device at both edges of a phase,
so each phase's wall time holds the device work enqueued inside it — and the
host waits for the card at every edge, so nothing overlaps. A timed pass
that is meant to overlap host and device work (the fused tracker's
extract-under-augment) uses `sync=False`: its phases then measure the
host's enqueue time only, and per-phase device time comes from a second,
synchronised pass.

`trace(log_dir)` is the counterpart of frtm_tpu's `xla_trace`: a
torch.profiler session around a block, written to `log_dir` as a
Chrome / Perfetto trace, the program's spans on a track of their own.

The span recorder. The port marks its layer boundaries with `span(name)`
and counts work with `count(name, n)`; both do nothing unless a
`recording()` block is open (on any thread: the recorder is the process's,
as torch.profiler is). While one is, each span keeps its name, its start
and end in `time.time_ns()` (the clock torch.profiler stamps host and device
events in, so spans lie over the device trace as they are), the thread-CPU
nanoseconds its thread spent inside it, the thread, the index in `spans()`
of the span it opened inside on the same thread, and the request it served
(`request(name)`: one sequence tracked; work handed to another thread
carries `current_request()` there, as `span(name, request=...)`). Counters
are integers by request and name. A span never synchronises the device or
reads a tensor, so it times the host's issue alone. `PhaseTimer.phase`
records its phase as a span too. Everything is kept in memory until
`reset()`.
"""
import itertools
import json
import os
import threading
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One recorded span; end_ns and cpu_ns are None while it is open."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    cpu_ns: Optional[int]
    thread: int
    parent: int                 # index in spans() of the enclosing span, -1 at a root
    request: Optional[str]


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0          # recording() blocks open
        self.records = []       # Span fields as lists, filled in when a span closes
        self.counts = defaultdict(int)      # (request, name) -> n
        self.local = threading.local()      # .stack of open span indices, .request
        self.ids = itertools.count()

    def open(self, name):
        """A handle for close(), or None while nothing records."""
        if not self.depth:
            return None
        local = self.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
        rec = [name, time.time_ns(), None, None, threading.get_ident(),
               stack[-1] if stack else -1, getattr(local, "request", None)]
        with self.lock:
            index = len(self.records)
            self.records.append(rec)
        stack.append(index)
        return rec, time.thread_time_ns()

    def close(self, handle, cpu_end_ns=None):
        """Close the span; its thread-CPU time ends at cpu_end_ns (a
        thread_time_ns() reading) where given, else now."""
        rec, c0 = handle
        rec[3] = (time.thread_time_ns() if cpu_end_ns is None else cpu_end_ns) - c0
        rec[2] = time.time_ns()
        self.local.stack.pop()


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "handle", "request", "outer")

    def __init__(self, name, request=None):
        self.name = name
        self.request = request

    def __enter__(self):
        if self.request is not None:
            local = _RECORDER.local
            self.outer = getattr(local, "request", None)
            local.request = self.request
        self.handle = _RECORDER.open(self.name)
        return self

    def __exit__(self, *exc):
        if self.handle is not None:
            _RECORDER.close(self.handle)
        if self.request is not None:
            _RECORDER.local.request = self.outer


class _Request:
    __slots__ = ("name", "outer")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        local = _RECORDER.local
        self.outer = getattr(local, "request", None)
        if self.outer is None:
            local.request = f"{self.name}#{next(_RECORDER.ids)}"
        return self

    def __exit__(self, *exc):
        _RECORDER.local.request = self.outer


_OFF = nullcontext()


@contextmanager
def recording():
    """Record spans and counts while the block runs (blocks nest)."""
    with _RECORDER.lock:
        _RECORDER.depth += 1
    try:
        yield
    finally:
        with _RECORDER.lock:
            _RECORDER.depth -= 1


def span(name: str, request: Optional[str] = None):
    """A context manager that records the block as a span named `name`;
    while nothing records, one shared no-op. With `request` (a
    `current_request()` of another thread), the span and those opened inside
    it on its thread serve that request."""
    return _Span(name, request) if _RECORDER.depth else _OFF


def current_request() -> Optional[str]:
    """The request the calling thread's spans serve now, None outside one."""
    return getattr(_RECORDER.local, "request", None)


def request(name: str):
    """The block's spans and counts serve one request, named `name` and
    numbered apart from every other; inside an open request, that one."""
    return _Request(name) if _RECORDER.depth else _OFF


def count(name: str, n: int = 1):
    if not _RECORDER.depth:
        return
    key = (getattr(_RECORDER.local, "request", None), name)
    with _RECORDER.lock:
        _RECORDER.counts[key] += n


def spans() -> list:
    """Every span recorded since reset(), in the order they opened."""
    with _RECORDER.lock:
        return [Span(*rec) for rec in _RECORDER.records]


def counts(requests=None) -> dict:
    """{name: n} summed over all requests, or over those in `requests`."""
    out = defaultdict(int)
    with _RECORDER.lock:
        for (req, name), n in _RECORDER.counts.items():
            if requests is None or req in requests:
                out[name] += n
    return dict(out)


def reset():
    """Forget every span and count (call it with no span open)."""
    with _RECORDER.lock:
        _RECORDER.records.clear()
        _RECORDER.counts.clear()


class PhaseTimer:
    """Accumulates wall and thread-CPU time per named phase."""

    def __init__(self, sync: bool = True, device=None):
        self.totals = defaultdict(float)
        self.cpu_totals = defaultdict(float)
        self.counts = defaultdict(int)
        device = None if device is None else torch.device(device)
        self._fence = sync and device is not None and device.type == "cuda"
        self.device = device
        self.sync = sync

    def _edge(self):
        if self._fence:
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name):
        """Time the block as phase `name`; where spans are recorded, also a
        span whose thread-CPU time stops before the closing synchronise."""
        self._edge()
        t0 = time.perf_counter()
        c0 = time.thread_time()
        handle = _RECORDER.open(name)
        try:
            yield
        finally:
            if handle is not None:
                cpu_end = time.thread_time_ns()
            self._edge()
            if handle is not None:
                _RECORDER.close(handle, cpu_end)
            self.cpu_totals[name] += time.thread_time() - c0
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            c = self.cpu_totals[name]
            lines.append(f"{name}: {t:.3f}s total, {t / n * 1000:.1f}ms/call x{n}"
                         f" (cpu {c / n * 1000:.1f}ms/call)")
        return "\n".join(lines)

    def stats(self):
        """{phase: {total_s, ms_per_call, cpu_ms_per_call, count}}."""
        return {name: {
            "total_s": self.totals[name],
            "ms_per_call": self.totals[name] / self.counts[name] * 1000.0,
            "cpu_ms_per_call": self.cpu_totals[name] / self.counts[name] * 1000.0,
            "count": self.counts[name],
        } for name in self.totals}

    def reset(self):
        self.totals.clear()
        self.cpu_totals.clear()
        self.counts.clear()


@contextmanager
def count_host_syncs(device):
    """Counts, in the `count` of the object it yields, the operations inside
    the block that make the host wait for the card (a `.item()`, a
    device-to-host copy, a blocking upload): PyTorch's sync debug mode
    reports each as a warning, and `where` lists them as "file:line: message".
    On a CPU device the count stays 0."""
    class Counter:
        count = 0
        where = ()

    counter = Counter()
    device = torch.device(device)
    if device.type != "cuda":
        yield counter
        return
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counter
        finally:
            torch.cuda.set_sync_debug_mode(before)
            # (setting the mode warns once itself, that it is a prototype)
            syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
            counter.count = len(syncs)
            counter.where = tuple(f"{w.filename}:{w.lineno}: {w.message}" for w in syncs)


@contextmanager
def trace(log_dir):
    """Profile the block with torch.profiler and write its trace, viewable
    in Perfetto or chrome://tracing, to <log_dir>/trace.json: the host's
    operators, the card's kernels where a CUDA device is available, and the
    spans the program recorded in the block (the recorder is on for it).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        first = len(_RECORDER.records)
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    _add_spans(path, spans()[first:])


def _add_spans(path, recorded):
    """Append the closed spans to a Chrome trace that torch.profiler wrote,
    as complete events in its time base (microseconds after its
    baseTimeNanoseconds), on a track of each thread's own."""
    doc = json.loads(path.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for thread in sorted({s.thread for s in recorded}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": thread,
                       "args": {"name": f"program spans ({thread})"}})
    for s in recorded:
        if s.end_ns is None:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"request": s.request, "cpu_ms": s.cpu_ns / 1e6}})
    path.write_text(json.dumps(doc))
