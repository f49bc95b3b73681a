"""Height sharding (frtm_tpu_torch/parallel/spatial.py, ops/halo.py, the fused
tracker's mesh=) on the CPU, in gloo worlds of child processes
(tests/torch_spatial_worker.py; rendezvous through a file under the test's
temporary directory, two threads a rank).

The six tests of tests/test_spatial.py, at their sizes and bounds, against
both the port's unsharded path and frtm_tpu's spatial mode on a 4-device CPU
mesh:
* the rn18 pyramid at 128x96 on four ranks: 5e-5 of the port's unsharded
  pyramid, and against frtm_tpu's make_spatial_extract the bound of
  tests/test_torch_resnet.py (1e-4 of a level's peak) plus 5e-5;
* the frame step at 128x96 on a group of four and on the plain world mesh
  (the 1-D mesh): 1e-5 of the unsharded step; against frtm_tpu's sharded
  step the bound of tests/test_torch_seg_network.py (1e-4) plus 1e-5;
* 2 x 2 (data x spatial) ranks on two frames, each sample against its own
  one-rank run: 1e-5;
* the fused tracker (one object, 5 frames), the deferred merge (two
  objects) and multilayer target models (layer4 and layer3), 64x96 on
  four ranks: labels under 0.5 % of a frame from the port's unsharded
  tracker (measured: equal), which lies under 0.5 % from frtm_tpu's
  unsharded tracker (measured: equal). frtm_tpu's BatchedSequenceTracker
  (mesh=) is the noisy one: with these weights its labels move from its own
  unsharded tracker's by 2.67 % (fused), 3.97 % (deferred) and 1.53 %
  (multilayer) of a frame, as GSPMD's partitioning moves rounding and the
  random target models carry it (test_spatial.py's 0.5 % holds there only
  because its random head gives constant frames). So the port's sharded
  labels are held to frtm_tpu's sharded ones within that tracker's own gap,
  measured in the test, plus 0.5 %. Every rank's filters are bit-equal
  after the sequence; the init filters are bit-equal to the unsharded
  tracker's.

The tracker weights are made as in tests/test_torch_multi_sequence.py (each
TSE's score channels times SCORE_GAIN, the head scaled from the port's own
frame-1 logits), so that objects and background hold pixels in every frame
and the comparison is of masks, not of constant frames. Both packages'
trackers read the JAX augmenter's batches (frtm_tpu's behind FreshBatches).

Unit cases of ops/halo.py at groups of 2, 3 and 4, each against its
unsharded self in the same process: the stem's 7x7/s2 convolution (a shard
and a whole input), 3x3/s2, 3x3/s1 and 1x1/s2 convolutions, the max pool at
its -inf border (all-negative inputs, where a zero border would show), the
resizes (up, down, whole to rows, a pooled 1x1 to rows, rows to a height
that does not divide, bicubic, width only), kernels 1 and 2 by pad, compute,
crop, and the spatial mean; with one-row shards, halos deeper than a shard,
and heights that do not divide. All are bit-equal on this machine except the
spatial mean (an all-reduce of per-rank sums): measured 1.7e-7 of its peak
at most, bound 1e-6. The bit-equal ones are asserted so.
"""
import os
import subprocess
import sys
import warnings
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from frtm_tpu.config import eval_config as jax_eval_config
from frtm_tpu.data.synthetic import make_moving_square_sequence as jax_sequence
from frtm_tpu.models import init_resnet, init_seg_network, resnet_out_channels
from frtm_tpu.models.discriminator import init_disc_params
from frtm_tpu.parallel.spatial import (make_spatial_extract as jax_spatial_extract,
                                       make_spatial_frame_step as jax_spatial_step,
                                       make_spatial_mesh as jax_spatial_mesh)
from frtm_tpu.runtime.sequence_tracker import BatchedSequenceTracker as JaxFused
from frtm_tpu_torch.models.resnet import ResNet
from frtm_tpu_torch.models.seg_network import SegNetwork
from frtm_tpu_torch.ops import halo
from frtm_tpu_torch.parallel import SpatialMesh, make_spatial_mesh
from frtm_tpu_torch.runtime.sequence_tracker import BatchedSequenceTracker
from frtm_tpu_torch.utils.convert import (disc_params_from_jax, resnet_from_jax,
                                          seg_network_from_jax)
from test_torch_tracker import FreshBatches, JaxAugmenterShim
from torch_spatial_worker import (ARCH, TRACKS, ops_cases, sequence_args, tiny_config,
                                  track_sequence)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_spatial_worker.py")
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
SCORE_GAIN, HEAD_SPREAD = 300.0, 0.5
OPS_WORLDS = (2, 3, 4)
# the unit cases that are bit-equal by construction or measured so here;
# the spatial mean's all-reduce changes its sum's order
NOT_BIT_EQUAL = {"spatial_mean"}


def child_env():
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "2"
    return env


class Ranks:
    """A gloo world of tests/torch_spatial_worker.py children, started now
    and read on the first `result()`."""

    def __init__(self, mode, workdir, n):
        self.mode, self.workdir, self.n = mode, workdir, n
        self.children = [subprocess.Popen([sys.executable, str(WORKER), mode, str(workdir),
                                           str(r), str(n)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True, env=child_env(),
                                          cwd=workdir)
                         for r in range(n)]
        self.results = None

    def result(self, timeout=400):
        if self.results is None:
            try:
                outs = [c.communicate(timeout=timeout)[0] for c in self.children]
            finally:
                self.stop()
            for rank, (c, out) in enumerate(zip(self.children, outs)):
                assert c.returncode == 0, (self.mode, self.n, rank, out[-3000:])
            name = (lambda r: f"ops{self.n}_{r}.pt") if self.mode == "ops" else \
                (lambda r: f"models{r}.pt")
            self.results = [torch.load(self.workdir / name(r), weights_only=False)
                            for r in range(self.n)]
        return self.results

    def stop(self):
        for c in self.children:
            if c.poll() is None:
                c.kill()
                c.wait()


def _scaled_refiner(key, ch, in_channels):
    refiner = init_seg_network(key, ch, in_channels=in_channels)
    for p in refiner["tse"].values():
        w = np.array(p["transform1"]["w"])
        w[:, :, -in_channels:, :] *= SCORE_GAIN     # HWIO: the scores are the last inputs
        p["transform1"] = dict(p["transform1"], w=jnp.asarray(w))
    return refiner


def _convert_p0(p0):
    if isinstance(p0, dict):
        return {L: _convert_p0(p) for L, p in p0.items()}
    return disc_params_from_jax(np.asarray(p0.project), np.asarray(p0.filter))


class World:
    """Both packages' weights, the workers' inputs, and the worker worlds."""

    def __init__(self, workdir):
        self.workdir = workdir
        # the unit cases need no inputs: their worlds start at once
        self.worlds = {n: Ranks("ops", workdir, n) for n in OPS_WORLDS}
        # tests/test_spatial.py's extract and frame-step weights
        self.step_cfg = replace(jax_eval_config(ARCH, fast=True), disc=replace(
            jax_eval_config(ARCH, fast=True).disc, c_channels=16))
        self.backbone = init_resnet(jax.random.PRNGKey(1), ARCH)
        self.ch = {L: c for L, c in resnet_out_channels(ARCH).items()
                   if L in self.step_cfg.refnet_layers}
        self.refiner = init_seg_network(jax.random.PRNGKey(2), self.ch,
                                        use_bn=self.step_cfg.refnet_use_bn)
        self.disc = init_disc_params(jax.random.PRNGKey(3), self.step_cfg.disc)
        self.images = (np.random.RandomState(0).rand(2, 128, 96, 3) * 255.0).astype(np.float32)
        # the trackers' weights
        self.jcfgs = {ml: self._jax_tiny(ml) for ml in (False, True)}
        self.trk_refiner, self.p0 = {}, {}
        for ml in (False, True):
            refiner = _scaled_refiner(jax.random.PRNGKey(2), self.ch, 2 if ml else 1)
            self.p0[ml] = _convert_p0(JaxFused(self.jcfgs[ml], self.backbone,
                                               refiner)._disc_params0)
            if not ml:
                self.p0[ml] = self.p0[ml][self.jcfgs[ml].disc.layer]
            self.trk_refiner[ml] = refiner
            self._scale_head(ml)
        inputs = {"backbone": self._state(self.backbone, resnet_from_jax),
                  "refiner": self._state(self.refiner, seg_network_from_jax),
                  "refiner_trk": self._state(self.trk_refiner[False], seg_network_from_jax),
                  "refiner_ml": self._state(self.trk_refiner[True], seg_network_from_jax),
                  "p0": self.p0[False], "p0_ml": self.p0[True],
                  "disc_project": disc_params_from_jax(np.asarray(self.disc.project),
                                                       np.asarray(self.disc.filter)).project,
                  "disc_filter": disc_params_from_jax(np.asarray(self.disc.project),
                                                      np.asarray(self.disc.filter)).filter,
                  "images": torch.from_numpy(self.images).permute(0, 3, 1, 2).contiguous(),
                  "aug_batches": {name: self._aug_batches(name) for name, *_ in TRACKS}}
        torch.save(inputs, workdir / "inputs.pt")
        self.worlds["models"] = Ranks("models", workdir, 4)

    @staticmethod
    def _jax_tiny(multilayer):
        cfg = tiny_config(multilayer)
        jcfg = jax_eval_config(ARCH, fast=True, num_aug=2)
        jcfg = replace(jcfg, disc=replace(jcfg.disc, **{k: getattr(cfg.disc, k) for k in (
            "init_iters", "update_iters", "memory_size", "c_channels", "train_skipping")}))
        return replace(jcfg, disc_layers=cfg.disc_layers)

    @staticmethod
    def _state(tree, convert):
        return convert(jax.tree.map(np.asarray, tree))

    def port_models(self, multilayer):
        tb = ResNet(ARCH)
        tb.load_state_dict(self._state(self.backbone, resnet_from_jax))
        tr = SegNetwork(self.ch, in_channels=2 if multilayer else 1)
        tr.load_state_dict(self._state(self.trk_refiner[multilayer], seg_network_from_jax))
        return tb, tr

    def port_tracker(self, multilayer=False, merge_mode="online", **kw):
        return BatchedSequenceTracker(tiny_config(multilayer), *self.port_models(multilayer),
                                      extract_chunk=4, merge_mode=merge_mode, device="cpu",
                                      disc_params0=self.p0[multilayer],
                                      augmenter=JaxAugmenterShim(self.jcfgs[False].aug_params),
                                      **kw)

    def _scale_head(self, multilayer):
        """The head scaled so that frame 1's logits have median 0 and spread
        HEAD_SPREAD (tests/test_torch_multi_sequence.py)."""
        seq = jax_sequence(n_frames=2, size=(64, 96), square=18, n_objects=2, seed=2)
        vol, _ = self.port_tracker(multilayer, "deferred").run_sequence(seq, soft=True)
        y = np.clip(vol[1].astype(np.float64), 1e-12, 1 - 1e-12)
        logits = np.log(y) - np.log1p(-y)
        scale = HEAD_SPREAD / float(logits.std())
        refiner = self.trk_refiner[multilayer]
        conv2 = refiner["up"]["conv2"]
        refiner["up"]["conv2"] = dict(conv2, w=conv2["w"] * scale,
                                      b=(conv2["b"] - float(np.median(logits))) * scale)

    def _aug_batches(self, name):
        tracker = self.port_tracker(name == "multilayer")
        return tracker._augment_objects(tracker._collect_objects(track_sequence(name)))

    def jax_tracker(self, name, sharded=True):
        _, _, _, _, multilayer, merge_mode = next(t for t in TRACKS if t[0] == name)
        tracker = JaxFused(self.jcfgs[multilayer], self.backbone, self.trk_refiner[multilayer],
                           extract_chunk=4, scan_bucket=2, merge_mode=merge_mode,
                           mesh=jax_spatial_mesh(n_spatial=4) if sharded else None)
        tracker.augmenter = FreshBatches(tracker.augmenter)
        return tracker

    def stop(self):
        for w in self.worlds.values():
            w.stop()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("spatial"))
    yield w
    w.stop()


def models(world):
    return world.worlds["models"].result()


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def test_spatial_extract_matches_single(world):
    want = jax.device_get(jax_spatial_extract(ARCH, jax_spatial_mesh(n_spatial=4),
                                              output_layers=world.step_cfg.refnet_layers)(
        world.backbone, jnp.asarray(world.images[:1])))
    for rank, out in enumerate(models(world)):
        assert set(out["extract"]) == set(want)
        for L, w in want.items():
            got, w = out["extract"][L], _nchw(w)
            assert got.shape == out["extract_single"][L].shape == w.shape
            # measured: equal to the unsharded pyramid to the bit
            torch.testing.assert_close(got, out["extract_single"][L], rtol=0, atol=5e-5)
            torch.testing.assert_close(got, w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()) + 5e-5)


def test_spatial_frame_step_matches_single(world):
    disc = world.disc
    want = _nchw(jax_spatial_step(world.step_cfg, jax_spatial_mesh(n_spatial=4))(
        world.backbone, world.refiner, disc, jnp.asarray(world.images[:1])))
    for out in models(world):
        assert out["step"].shape == (1, 1, 128, 96)
        single = out["step_single"][0]
        torch.testing.assert_close(out["step"], single, rtol=0, atol=1e-5)
        torch.testing.assert_close(out["step_flat"], out["step"], rtol=0, atol=1e-5)
        torch.testing.assert_close(out["step"], want, rtol=0, atol=1e-4 + 1e-5)
        # exchanges and gathers happened, and moved rows, not maps
        traffic = out["step_traffic"]
        assert traffic["exchange"] > 0 and traffic["gather"] > 0


def test_spatial_dp_combo_matches_per_sample(world):
    """2 x 2 (data x spatial): each sample equal to its own one-rank run."""
    for out in models(world):
        got = out["step_dpsp"]
        assert got.shape == (2, 1, 128, 96)
        for b in range(2):
            torch.testing.assert_close(got[b:b + 1], out["step_single"][b], rtol=0, atol=1e-5,
                                       msg=f"sample {b}")


def _label_gap(got, want):
    return max(float(np.mean(a != b)) for a, b in zip(got, want))


def _tracked_pixels(labels, n_objects):
    """Every tracked frame holds background and each object."""
    for t, lb in enumerate(labels[1:], 1):
        assert int((lb == 0).sum()) >= 10, t
        for i in range(1, n_objects + 1):
            assert int((lb == i).sum()) >= 10, (t, i)


def _check_tracker(world, name):
    jax_single, _ = world.jax_tracker(name, sharded=False).run_sequence(
        jax_sequence(**sequence_args(name)))
    jax_sharded, _ = world.jax_tracker(name).run_sequence(jax_sequence(**sequence_args(name)))
    jax_own_gap = _label_gap(jax_sharded, jax_single)
    n_objects = next(t for t in TRACKS if t[0] == name)[2]
    for out in models(world):
        runs = out["trackers"][name]
        got, single = runs["sharded"]["labels"], runs["single"]["labels"]
        assert len(got) == len(single) == len(jax_single) == len(track_sequence(name))
        _tracked_pixels(single, n_objects)
        assert _label_gap(got, single) < 0.005
        assert _label_gap(single, np.stack(jax_single)) < 0.005
        assert _label_gap(got, np.stack(jax_sharded)) <= jax_own_gap + 0.005


def test_spatially_sharded_scan_tracker_matches_single(world):
    _check_tracker(world, "fused")


def test_spatially_sharded_deferred_merge_matches_single(world):
    _check_tracker(world, "deferred")


def test_spatially_sharded_multilayer_scan_matches_single(world):
    _check_tracker(world, "multilayer")


@pytest.mark.parametrize("name", [t[0] for t in TRACKS])
def test_ranks_filters_bit_equal(world, name):
    """The replicated target models stay equal on every rank, and the
    init, which runs replicated and unchanged, is the unsharded tracker's."""
    outs = [o["trackers"][name] for o in models(world)]
    for out in outs:
        for L, f in out["sharded"]["init_filters"].items():
            assert torch.equal(f, out["single"]["init_filters"][L]), L
        for L, f in out["sharded"]["filters"].items():
            assert torch.equal(f, outs[0]["sharded"]["filters"][L]), L


@pytest.mark.parametrize("n", OPS_WORLDS)
@pytest.mark.parametrize("case", [c[0] for c in ops_cases(4)])
def test_halo_op_matches_unsharded(world, n, case):
    for rank, out in enumerate(world.worlds[n].result()):
        want, got = out[case]["want"], out[case]["got"]
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        if case in NOT_BIT_EQUAL:
            gap = float((got - want).abs().max() / want.abs().max())
            assert gap <= 1e-6, (rank, gap)
        else:
            assert torch.equal(got, want), (rank, float((got - want).abs().max()))


@pytest.mark.parametrize("n", OPS_WORLDS)
def test_halo_exchanges_move_rows(world, n):
    """Each unit case's exchanges move boundary rows (two for a 3x3
    convolution), a small share of what gathering the maps moves."""
    traffic = world.worlds[n].result()[0]["traffic"]
    assert traffic["exchange"] >= 11 and traffic["gather"] > 0
    assert traffic["exchange_bytes"] < traffic["gather_bytes"] / 5


def test_make_spatial_mesh_refusals():
    with pytest.raises(ValueError, match=r"need 2 processes \(1 x 2 spatial\), have 1"):
        make_spatial_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"need 4 processes \(2 x 2 spatial\), have 1"):
        make_spatial_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_spatial_mesh(1)
    mesh = make_spatial_mesh(1, device="cpu")
    assert isinstance(mesh, SpatialMesh) and mesh.group is None and mesh.size == 1
    assert mesh.device == torch.device("cpu") and (mesh.data_index, mesh.n_data) == (0, 1)


def test_group_of_one_is_the_meshless_tracker(world):
    """A spatial group of one shards nothing: the tracker's labels and
    filters are bit-equal to the tracker without a mesh."""
    seq = track_sequence("deferred")
    want, _ = world.port_tracker(merge_mode="online").run_sequence(seq)
    tracker = world.port_tracker(merge_mode="online", mesh=make_spatial_mesh(1, device="cpu"))
    got, _ = tracker.run_sequence(seq)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert tracker.device == torch.device("cpu")


def test_indivisible_height_warns_once(world):
    """A frame height that the group does not divide warns, once per
    tracker (frtm_tpu/runtime/sequence_tracker.py's warning)."""
    fake = SimpleNamespace(size=3, rank=0, group=None, device=torch.device("cpu"))
    tracker = world.port_tracker(mesh=fake)

    class Stop(Exception):
        pass

    def stop(sequence):
        raise Stop

    tracker._collect_objects = stop
    seq = track_sequence("fused")          # 64 rows: 64 % 3 != 0
    with pytest.warns(UserWarning, match="frame height 64 is not divisible by n_spatial=3"):
        with pytest.raises(Stop):
            tracker.run_sequence(seq)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Stop):
            tracker.run_sequence(seq)


def test_halo_without_a_group_is_the_plain_op():
    x = torch.randn(2, 4, 12, 10)
    w = torch.randn(5, 4, 3, 3)
    assert torch.equal(halo.conv2d(x, w, stride=2, H=12), torch.nn.functional.conv2d(
        x, w, stride=2, padding=1))
    one = SimpleNamespace(size=1, rank=0, group=None)
    assert torch.equal(halo.max_pool_3x3_s2(x, 12, one), torch.nn.functional.max_pool2d(x, 3, 2,
                                                                                       1))
    assert halo.gather_rows(x, 12, one) is x and halo.take_rows(x, 12, one) is x
    assert torch.equal(halo.spatial_mean(x, 12, None), x.mean(dim=(-2, -1), keepdim=True))
