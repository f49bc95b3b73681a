"""The deferred merge of the port's multi-sequence engine against
frtm_tpu's ShardedSequenceTracker on a 2-device CPU mesh (the world of
test_torch_multi_sequence.py): two two-object sequences in one group, one
with object 2 entering at frame 2, merged per sequence after the group's
loop. Bounds, as for the fused tracker: labels under 0.5 % of a frame
(measured: 0), the soft volume, ground truth at the start frames, within
1e-3 (measured: 4.2e-6). Against the port's fused tracker on each sequence
alone: equal labels, the soft volume within 1e-6 (measured: 0, bit-equal;
the bound leaves room for a convolution that rounds the group's larger
decode batch differently in the last bit).
"""
import numpy as np
import torch

from test_torch_multi_sequence import SIZE, sequence, world, worst_gap  # noqa: F401

torch.set_num_threads(2)


def test_groups_match_jax_deferred(world):
    """The deferred merge, per sequence after the group's loop: labels and
    the soft volume (ground truth at the start frames) against frtm_tpu."""
    seqs = [sequence(5, 2, 20, "d_a"),
            sequence(5, 2, 21, "d_b", starts={"00000": [1], "00002": [2]})]
    jt = world.jax_sharded("deferred")
    jax_soft, merge = [], jt._merge_volume

    def keep_jax(fg, lut):
        jax_soft.append(np.asarray(fg))
        return merge(fg, lut)

    jt._merge_volume = keep_jax
    want = jt.run_sequences(seqs)

    port = world.sharded("deferred")
    port_soft, windows = [], port._merge_volume_windows

    def keep_port(outs, start_frames, start_masks, lut, T, window=32):
        fg = torch.cat([torch.zeros_like(outs[:1]), outs])
        for k, s in enumerate(start_frames):
            fg[s, k] = start_masks[k]
        port_soft.append(fg.numpy())
        return windows(outs, start_frames, start_masks, lut, T, window)

    port._merge_volume_windows = keep_port
    got = port.run_sequences(seqs)
    fused = world.fused("deferred")
    worst = fused_worst = labels_worst = 0.0
    for i, seq in enumerate(seqs):
        labels_worst = max(labels_worst, worst_gap(got[seq.name], want[seq.name], seq))
        a, b = port_soft[i], jax_soft[i][:, :2]
        assert a.shape == b.shape == (5, 2) + SIZE
        worst = max(worst, float(np.abs(a - b).max()))
        alone, _ = fused.run_sequence(seq)
        assert worst_gap(got[seq.name], alone, seq) == 0.0, seq.name
        soft, _ = fused.run_sequence(seq, soft=True)
        fused_worst = max(fused_worst, float(np.abs(a - soft).max()))
    print(f"labels against frtm_tpu {labels_worst:.5f}; soft volume against frtm_tpu "
          f"{worst:.3g}, against the fused tracker {fused_worst:.3g}")
    assert labels_worst < 0.005 and worst < 1e-3 and fused_worst < 1e-6, \
        (labels_worst, worst, fused_worst)
