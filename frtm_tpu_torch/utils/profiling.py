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
Chrome / Perfetto trace.
"""
import time
import warnings
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch


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
        self._edge()
        t0 = time.perf_counter()
        c0 = time.thread_time()
        try:
            yield
        finally:
            self._edge()
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
    operators, and the card's kernels where a CUDA device is available.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
