"""The label writer (data/image.py::LabelWriter), alone with stand-ins for
the file write and inside the three run_dataset loops (the fused tracker's,
the host-loop Tracker's, the multi-sequence engine's) on the CPU: the files
are byte for byte what the serial `imwrite_indexed` writes of the labels
that tracking returned, and all there when run_dataset returns; a failed
write is raised on the loop's thread and leaves no writer thread alive; the
hand-off waits while the writer holds DEPTH sequences, never more."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from frtm_tpu_torch.data.image import LabelWriter, imwrite_indexed
from frtm_tpu_torch.parallel import multi_sequence
from frtm_tpu_torch.runtime import sequence_tracker
from frtm_tpu_torch.runtime import tracker as host_loop
from frtm_tpu_torch.runtime.tracker import Tracker
from frtm_tpu_torch.utils import profiling
from test_torch_multi_sequence_port import World, sequence

torch.set_num_threads(2)


def writer_threads():
    return [t for t in threading.enumerate() if t.name.startswith("label-writer")]


def random_labels(rng, n, size=(24, 40)):
    return [rng.integers(0, 4, size, dtype=np.uint8) for _ in range(n)]


class Log:
    """A stand-in write: records (path, thread, time) and can wait on a
    gate or sleep first, and raise on one file."""

    def __init__(self, sleep=0.0, gate=None, fail=None):
        self.sleep, self.gate, self.fail = sleep, gate, fail
        self.done = []
        self.lock = threading.Lock()

    def __call__(self, path, labels):
        if self.gate is not None:
            assert self.gate.wait(30)
        time.sleep(self.sleep)
        if self.fail is not None and path.name == self.fail:
            raise OSError(f"no room for {path}")
        with self.lock:
            self.done.append((path, threading.get_ident(), time.perf_counter()))

    def sequences_written(self, files):
        """How many of `files` (a list of each sequence's paths) are written in full."""
        with self.lock:
            done = {p for p, _, _ in self.done}
        return sum(all(p in done for p in paths) for paths in files)


def test_writes_the_files_of_the_serial_writer(tmp_path):
    """Four sequences, one with no frames and one of (H, W, 1) labels."""
    rng = np.random.default_rng(0)
    seqs = {"a": random_labels(rng, 5), "b": [],
            "c": [lb[..., None] for lb in random_labels(rng, 3)], "d": random_labels(rng, 7, (17, 9))}
    with LabelWriter() as writer:
        for name, labels in seqs.items():
            (tmp_path / "bg" / name).mkdir(parents=True)
            writer.put(tmp_path / "bg" / name, labels, [f"{i:05d}" for i in range(len(labels))])
    assert writer_threads() == []
    for name, labels in seqs.items():
        (tmp_path / "serial" / name).mkdir(parents=True)
        for i, lb in enumerate(labels):
            imwrite_indexed(tmp_path / "serial" / name / f"{i:05d}.png", lb)
        got = sorted(p.name for p in (tmp_path / "bg" / name).iterdir())
        assert got == sorted(p.name for p in (tmp_path / "serial" / name).iterdir())
        for f in got:
            assert ((tmp_path / "bg" / name / f).read_bytes()
                    == (tmp_path / "serial" / name / f).read_bytes()), (name, f)


def test_put_waits_while_depth_sequences_are_held(tmp_path):
    """Each write takes 50 ms: the third hand-off waits for the first
    sequence's two files, and no hand-off returns with more than DEPTH
    sequences unwritten. Both threads write."""
    log = Log(sleep=0.05)
    files, held = [], []
    t0 = time.perf_counter()
    with LabelWriter(log) as writer:
        for k in range(5):
            names = [f"{k}.{i}" for i in range(2)]
            files.append([tmp_path / (f + ".png") for f in names])
            writer.put(tmp_path, [None, None], names)
            if k == 2:
                third = time.perf_counter() - t0
            held.append(len(files) - log.sequences_written(files))
    assert writer_threads() == []
    assert LabelWriter.DEPTH == 2 and max(held) <= LabelWriter.DEPTH
    assert third >= 0.05
    assert log.sequences_written(files) == 5
    assert len({thread for _, thread, _ in log.done}) == LabelWriter.THREADS == 2


def test_a_failed_write_is_raised_at_the_next_put_or_the_close(tmp_path):
    log = Log(sleep=0.01, fail="0.1.png")
    with pytest.raises(OSError, match="no room"):
        with LabelWriter(log) as writer:
            for k in range(6):
                writer.put(tmp_path, [None] * 3, [f"{k}.{i}" for i in range(3)])
    assert writer_threads() == []
    # the files after the failure are dropped
    assert len(log.done) < 17
    with pytest.raises(OSError, match="no room"):
        writer.close()
    with pytest.raises(RuntimeError, match="after close"):
        writer.put(tmp_path, [None], ["late"])


def test_the_loops_own_exception_wins_and_the_writes_before_it_finish(tmp_path):
    log = Log(sleep=0.02)
    with pytest.raises(KeyError):
        with LabelWriter(log) as writer:
            writer.put(tmp_path, [None] * 4, list("abcd"))
            raise KeyError("the loop failed")
    assert writer_threads() == [] and len(log.done) == 4
    # the writer failed too: the loop's exception is the one raised
    with pytest.raises(KeyError):
        with LabelWriter(Log(fail="a.png")) as writer:
            writer.put(tmp_path, [None], ["a"])
            time.sleep(0.1)
            raise KeyError("the loop failed")
    assert writer_threads() == []


class ManyThreads(LabelWriter):
    THREADS = 16
    DEPTH = 3


def test_many_threads_lose_no_file_and_no_count(tmp_path):
    """Sixteen threads at a switch interval of a microsecond, 60 sequences
    of 1-12 files: every file written once, nothing held at the end, within
    60 s."""
    written, lock = [], threading.Lock()

    def write(path, labels):
        with lock:
            written.append(path.name)

    out = {}

    def run():
        with ManyThreads(write) as writer:
            for k in range(60):
                n = 1 + k % 12
                writer.put(tmp_path, [None] * n, [f"{k}.{i}" for i in range(n)])
        out["writer"] = writer

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeder = threading.Thread(target=run)
        feeder.start()
        feeder.join(60)
    finally:
        sys.setswitchinterval(before)
    assert not feeder.is_alive() and writer_threads() == []
    want = [f"{k}.{i}.png" for k in range(60) for i in range(1 + k % 12)]
    assert sorted(written) == sorted(want)
    assert out["writer"]._held == 0 and not out["writer"]._todo


# the three loops, each with the module whose imwrite_indexed it calls
LOOPS = {"fused": sequence_tracker, "host": host_loop, "sharded": multi_sequence}


@pytest.fixture(scope="module")
def world():
    return World()


def make(world, loop):
    if loop == "fused":
        return world.fused()
    if loop == "host":
        return Tracker(world.cfgs[()], world.backbone, world.refiners[()], device="cpu")
    return world.sharded()


def returned_labels(tracker, loop):
    """{sequence: labels} as tracking returns them to run_dataset."""
    got = {}
    if loop == "sharded":
        run_group = tracker._run_group

        def spy(*args, **kwargs):
            results = run_group(*args, **kwargs)
            got.update(results)
            return results
        tracker._run_group = spy
    else:
        run_sequence = tracker.run_sequence

        def spy(seq, *args, **kwargs):
            outputs, fps = run_sequence(seq, *args, **kwargs)
            got[seq.name] = [np.array(lb) for lb in outputs]
            return outputs, fps
        tracker.run_sequence = spy
    return got


class Dataset(list):
    name = "synthetic"


def three_sequences():
    return Dataset([sequence(4, 1, 70, "a"), sequence(5, 2, 71, "b"), sequence(3, 1, 72, "c")])


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_run_dataset_writes_the_serial_files(world, tmp_path, loop):
    seqs = three_sequences()
    tracker = make(world, loop)
    labels = returned_labels(tracker, loop)
    tracker.run_dataset(seqs, tmp_path / "out")
    assert writer_threads() == []
    assert sorted(labels) == ["a", "b", "c"]
    for seq in seqs:
        assert len(labels[seq.name]) == len(seq)
        got = sorted(p.name for p in (tmp_path / "out" / seq.name).iterdir())
        assert got == sorted(f + ".png" for f in seq.frame_names)
        for lb, f in zip(labels[seq.name], seq.frame_names):
            serial = tmp_path / "serial.png"
            imwrite_indexed(serial, lb)
            assert (tmp_path / "out" / seq.name / f"{f}.png").read_bytes() \
                == serial.read_bytes(), (loop, seq.name, f)


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_run_dataset_raises_a_failed_write(world, tmp_path, monkeypatch, loop):
    module = LOOPS[loop]
    real = module.imwrite_indexed

    def failing(path, labels):
        if path.parent.name == "b" and path.name == "00002.png":
            raise OSError("disk full")
        real(path, labels)

    monkeypatch.setattr(module, "imwrite_indexed", failing)
    with pytest.raises(OSError, match="disk full"):
        make(world, loop).run_dataset(three_sequences(), tmp_path)
    assert writer_threads() == []


def test_run_dataset_hand_off_waits_for_the_writer(world, tmp_path, monkeypatch):
    """The fused loop with tracking stood in for (each sequence's labels at
    once) and writes that wait on a gate, opened 0.3 s after the third
    sequence's labels are ready: that hand-off waits for it inside its
    `png_write` span, no sequence's tracking starts with more than DEPTH
    sequences unwritten, and every file is written when run_dataset returns."""
    seqs = Dataset(sequence(3, 1, 80 + k, f"s{k}") for k in range(5))
    files = [[tmp_path / s.name / f"{f}.png" for f in s.frame_names] for s in seqs]
    gate = threading.Event()
    log = Log(gate=gate)
    monkeypatch.setattr(sequence_tracker, "imwrite_indexed", log)
    tracker = make(world, "fused")
    tracker.profile = True
    held, timer = [], []

    def run_sequence(seq, *args, **kwargs):
        k = int(seq.name[1:])
        held.append(k - log.sequences_written(files))
        if k == 2:
            timer.append(threading.Timer(0.3, gate.set))
            timer[0].start()
        return random_labels(np.random.default_rng(k), len(seq), (64, 96)), 1.0

    tracker.run_sequence = run_sequence
    profiling.reset()
    try:
        tracker.run_dataset(seqs, tmp_path)
        spans = profiling.spans()
    finally:
        profiling.reset()
        gate.set()
    assert writer_threads() == []
    assert held[:3] == [0, 1, 2] and max(held) <= LabelWriter.DEPTH
    assert log.sequences_written(files) == 5
    writes = [s for s in spans if s.name == "png_write"]
    assert len(writes) == 5 and writes[2].end_ns - writes[2].start_ns >= 0.25e9
    encodes = [s for s in spans if s.name == "png_encode"]
    assert {s.request for s in encodes} == {s.request for s in writes}
