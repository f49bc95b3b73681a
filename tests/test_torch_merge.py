"""The fused tracker's small pieces against frtm_tpu on the same numpy
inputs: the two merges (labels equal, merged rows within 1e-6; measured
1.2e-7), the windowed deferred merge against the one-shot one, the
tensor-gated memory insert, and the phase timer."""
import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from frtm_tpu.models import memory as jm
from frtm_tpu.runtime import sequence_tracker as jst
from frtm_tpu_torch.models import memory as tm
from frtm_tpu_torch.runtime.sequence_tracker import (BatchedSequenceTracker, merge_rows_and_label,
                                                     merge_volume)
from frtm_tpu_torch.utils.profiling import PhaseTimer, count_host_syncs


def _rows(n, seed, lead=()):
    """Random soft rows with exact 0, 1 and 0.5, and pixels where all rows
    are equal (ties)."""
    rng = np.random.RandomState(seed)
    rows = rng.rand(*lead, n, 24, 32).astype(np.float32)
    rows[..., 0:3, :] = np.float32(0.0)
    rows[..., 3:6, :] = np.float32(1.0)
    rows[..., 6:9, :] = np.float32(0.5)
    rows[..., 9:12, :] = rows[..., :1, 9:12, :]          # every row equal
    rows[..., 0, 12:14, :] = np.float32(1.0)             # one sure winner
    rows[..., 14:16, :8] = np.float32(0.5)               # ties at the label threshold
    return rows


@pytest.mark.parametrize("n", [1, 2, 3])
def test_merge_rows_and_label_matches_jax(n):
    ids = [0, 3, 5, 9][:n + 1]
    for seed in range(3):
        rows = _rows(n, seed)
        jm_, jl = jst.merge_rows_and_label(jnp.asarray(rows), jnp.asarray(ids, jnp.int32))
        m, lab = merge_rows_and_label(torch.from_numpy(rows), torch.tensor(ids, dtype=torch.int32))
        assert lab.dtype == torch.uint8
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jl))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm_), atol=1e-6, rtol=0)
    # a leading window axis is merged frame by frame
    rows = _rows(n, 7, lead=(4,))
    m, lab = merge_rows_and_label(torch.from_numpy(rows), torch.tensor(ids, dtype=torch.int32))
    for f in range(4):
        mf, lf = merge_rows_and_label(torch.from_numpy(rows[f]),
                                      torch.tensor(ids, dtype=torch.int32))
        assert torch.equal(m[f], mf) and torch.equal(lab[f], lf)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_merge_volume_matches_jax(n):
    ids = [0, 3, 5, 9][:n + 1]
    for seed in range(3):
        fg = _rows(n, seed, lead=(5,))
        want = np.asarray(jst.merge_volume(jnp.asarray(fg), jnp.asarray(ids, jnp.int32)))
        got = merge_volume(torch.from_numpy(fg), torch.tensor(ids, dtype=torch.int32))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [2, 5, 32])
def test_merge_volume_windows_equals_one_shot(window):
    """Ground truth inserted at the start frames (one mid-sequence), windows
    that do not divide the length."""
    T, N, H, W = 11, 2, 16, 24
    rng = np.random.RandomState(0)
    outs = torch.from_numpy(rng.rand(T - 1, N, H, W).astype(np.float32))
    masks = torch.from_numpy((rng.rand(N, H, W) > 0.6).astype(np.float32))
    starts = [0, 4]
    lut = torch.tensor([0, 3, 5], dtype=torch.int32)
    fg = torch.cat([torch.zeros(1, N, H, W), outs])
    for k, s in enumerate(starts):
        fg[s, k] = masks[k]
    want = merge_volume(fg, lut)
    got = BatchedSequenceTracker._merge_volume_windows(None, outs, starts, masks, lut, T,
                                                       window=window)
    assert torch.equal(got, want)
    # and the one-shot merge is the JAX package's
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jst.merge_volume(jnp.asarray(fg.numpy()),
                                                  jnp.asarray([0, 3, 5], jnp.int32))))


@pytest.mark.parametrize("gate", ["tensor", "bool"])
def test_memory_update_gate_matches_jax(gate):
    """Inserts with the gate on and off, as an (N,) tensor (never read on the
    host) and as a host bool, against memory_update(..., enabled=e); one
    object (N = 1)."""
    rng = np.random.RandomState(1)
    K, cap, C, h, w, H, W = 2, 4, 3, 4, 5, 8, 10
    f = rng.rand(K, h, w, C).astype(np.float32)
    y = (rng.rand(K, H, W, 1) > 0.5).astype(np.float32)
    p = rng.rand(K, H, W, 1).astype(np.float32)
    js = jm.memory_init(cap, jnp.asarray(f), jnp.asarray(y), jnp.asarray(p))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))
    ts = tm.memory_init(cap, nchw(f)[None], nchw(y)[None], nchw(p)[None])
    for step, e in enumerate([True, False, True, True, False, True, True]):
        fi = rng.rand(h, w, C).astype(np.float32)
        yi = rng.rand(H, W, 1).astype(np.float32)
        pi = rng.rand(H, W, 1).astype(np.float32)
        js = jm.memory_update(js, jnp.asarray(fi), jnp.asarray(yi), jnp.asarray(pi), 0.1,
                              enabled=jnp.asarray(e))
        ts = tm.memory_update(ts, nchw(fi)[None], nchw(yi)[None], nchw(pi)[None], 0.1,
                              enabled=torch.tensor([e]) if gate == "tensor" else e)
        np.testing.assert_array_equal(ts.weights[0].numpy(), np.asarray(js.weights))
        np.testing.assert_array_equal(ts.samples[0].numpy(),
                                      np.moveaxis(np.asarray(js.samples), -1, -3))
        np.testing.assert_array_equal(ts.labels[0].numpy(),
                                      np.moveaxis(np.asarray(js.labels), -1, -3))
        np.testing.assert_array_equal(ts.pixel_weights[0].numpy(),
                                      np.moveaxis(np.asarray(js.pixel_weights), -1, -3))
        assert int(ts.current_size) == int(js.current_size)
        assert int(ts.prev_ind) == int(js.prev_ind)


@pytest.mark.parametrize("sync", [False, True])
def test_phase_timer_accumulates(sync):
    timer = PhaseTimer(sync=sync, device="cpu")
    for _ in range(3):
        with timer.phase("a"):
            time.sleep(0.002)
    with pytest.raises(RuntimeError):
        with timer.phase("b"):
            raise RuntimeError("the phase is recorded all the same")
    stats = timer.stats()
    assert stats["a"]["count"] == 3 and stats["b"]["count"] == 1
    assert stats["a"]["total_s"] >= 0.006
    assert stats["a"]["ms_per_call"] == pytest.approx(stats["a"]["total_s"] / 3 * 1e3)
    assert timer.report().splitlines()[0].startswith("a: ")
    timer.reset()
    assert timer.stats() == {}
    with count_host_syncs("cpu") as syncs:
        float(torch.ones(1).sum())
    assert syncs.count == 0
