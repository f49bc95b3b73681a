"""Height sharding: one frame's rows split over a spatial group of processes
(frtm_tpu/parallel/spatial.py).

Data parallelism and sequence parallelism add throughput but cannot make one
frame faster; sharding the image height can. In the JAX package GSPMD
partitions every convolution, resize and mean along the height and inserts
the halo exchanges. The port runs one process per card, so each rank
computes its rows through ops/halo.py, which exchanges the boundary rows a
stencil reads (O(W C) bytes) and gathers a level only where it stops
dividing. The target model stays replicated: each rank projects its rows
of the target model's layer (a 1x1 convolution, pointwise), the compressed
c-channel map is gathered, and the classification, the memory and the
GN-CG solves run on the whole map, identically on every rank.

The mesh may be pure SP (n_data = 1) or DP x SP: the world's consecutive
blocks of n_spatial ranks are spatial groups, each taking its rows of the
batch (distributed.batch_rows). `make_spatial_extract` and
`make_spatial_frame_step` take the global batch on every rank and return
the global result on every rank.

Numerics: the exchanges move bytes; the sums that change are the resizes'
(a band of the matrix in place of the whole of it) and the spatial means'
(a sum per rank, then an all-reduce), so the sharded pyramid and masks
agree with the unsharded ones to float rounding, not bit for bit.
"""
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..models.resnet import level_heights
from ..models.seg_network import seg_network_apply
from ..models.discriminator import classify_objects, project_all
from ..ops import halo
from ..ops.conv import compute_copy
from .distributed import batch_rows
from .mesh import Mesh, this_device


@dataclass(frozen=True)
class SpatialMesh(Mesh):
    """A spatial group: `group`, `rank` and `size` are the group's (None, 0
    and 1 for a group of one), `data_index` and `n_data` place the group
    among the world's groups. `traffic` counts the group's exchanges,
    gathers and all-reduces and their bytes (ops/halo.py)."""
    data_index: int = 0
    n_data: int = 1
    traffic: dict = field(default_factory=dict, compare=False)


def make_spatial_mesh(n_spatial: int, n_data: int = 1, device=None) -> SpatialMesh:
    """The spatial group of this process in a world of exactly n_data x
    n_spatial processes (one process, not initialised, for 1 x 1): rank
    d * n_spatial + s is rank s of group d. Every rank creates every group,
    as torch.distributed requires. On this process's device
    (mesh.this_device: its card, raising where there is none; the CPU only
    where device="cpu" asks for it). Raises where the world does not
    match."""
    dev = this_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = n_data * n_spatial
    if n_spatial < 1 or n_data < 1 or world != need:
        raise ValueError(f"need {need} processes ({n_data} x {n_spatial} spatial), "
                         f"have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, s = divmod(rank, n_spatial)
    group = None
    if n_spatial > 1:
        for g in range(n_data):
            made = dist.new_group(list(range(g * n_spatial, (g + 1) * n_spatial)))
            if g == d:
                group = made
    return SpatialMesh(group=group, rank=s if n_spatial > 1 else 0, size=n_spatial,
                       device=dev, data_index=d, n_data=n_data)


def _data_rows(mesh, x):
    lo, hi = batch_rows(x.shape[0], getattr(mesh, "data_index", 0), getattr(mesh, "n_data", 1))
    return x[lo:hi]


def _gather_data(mesh, x):
    """The whole batch from every group's rows (equal on a group's ranks):
    one all-gather over the world, the groups' rank-0 parts concatenated."""
    if getattr(mesh, "n_data", 1) == 1:
        return x
    parts = halo.all_gather_bytes(x, None, dist.get_world_size())
    return torch.cat(parts[::mesh.size])


class _ComputeCopies:
    """A module's copy in the compute type, made once per module."""

    def __init__(self, dtype):
        self.dtype, self.made = dtype, {}

    def __call__(self, module):
        key = id(module)
        if key not in self.made or self.made[key][0] is not module:
            self.made[key] = (module, compute_copy(module, self.dtype))
        return self.made[key][1]


def _sharded_pyramid(net, images, mesh, output_layers, dtype):
    """This group's batch rows, their pyramid on this rank's rows, and the
    levels' global heights."""
    x = _data_rows(mesh, torch.as_tensor(images).to(mesh.device))
    feats = net.extract_features(x, output_layers=output_layers, out_dtype=dtype, mesh=mesh)
    return x, feats, level_heights(x.shape[-2])


def make_spatial_extract(arch: str, mesh: SpatialMesh, output_layers=None,
                         dtype=torch.float32):
    """The backbone pyramid with the height sharded over the mesh's spatial
    groups and the batch over its data axis.

    :param mesh: a make_spatial_mesh() mesh, or a parallel/mesh.py Mesh,
                 whose whole group is one spatial group
    :param arch: the backbone's name (a ResNet of it is passed to fn)
    :param dtype: the backbone's compute type (a copy is made once)
    :return: fn(backbone, images (B, 3, H, W) 0..255, the global batch on
             every rank) -> {layer: (B, c, h, w) float32}, whole on every rank
    """
    copies = _ComputeCopies(dtype)

    def fn(backbone, images):
        if backbone.arch != arch:
            raise ValueError(f"make_spatial_extract: a {backbone.arch} for {arch}")
        _, feats, heights = _sharded_pyramid(copies(backbone), images, mesh, output_layers,
                                             torch.float32)
        return {L: _gather_data(mesh, halo.gather_rows(f, heights[L], mesh))
                for L, f in feats.items()}

    return fn


def make_spatial_frame_step(cfg, mesh: SpatialMesh, dtype=torch.float32):
    """The per-frame hot path (backbone pyramid, target-model classify,
    decoder, sigmoid; the JAX frame step) with the height sharded over the
    mesh's spatial groups and the batch over its data axis. Backbone and
    decoder compute in `dtype` (copies made once); the target model in
    float32 on the gathered compressed map.

    :return: fn(backbone, refiner, disc (DiscParams of one model), images
             (B, 3, H, W) 0..255, the global batch on every rank) ->
             (B, 1, H, W) float32 mask probabilities, whole on every rank
    """
    layers = tuple(cfg.refnet_layers)
    disc_layer = cfg.disc.layer
    copies = _ComputeCopies(dtype)

    @torch.no_grad()
    def fn(backbone, refiner, disc, images):
        x, feats, heights = _sharded_pyramid(copies(backbone), images, mesh,
                                             tuple(sorted(set(layers) | {disc_layer},
                                                          reverse=True)), dtype)
        project = disc.project if disc.project.dim() == 5 else disc.project[None]
        filt = disc.filter if disc.filter.dim() == 5 else disc.filter[None]
        compressed = project_all(feats[disc_layer].float(), project)     # (B, 1, c, h, w)
        compressed = halo.gather_rows(compressed, heights[disc_layer], mesh)
        scores = classify_objects(compressed, filt).to(dtype)
        logits = seg_network_apply(copies(refiner), scores, {L: feats[L] for L in layers},
                                   tuple(x.shape[-2:]), layers=layers, mesh=mesh,
                                   heights=heights)
        probs = torch.sigmoid(logits.float())
        return _gather_data(mesh, halo.gather_rows(probs, x.shape[-2], mesh))

    return fn
