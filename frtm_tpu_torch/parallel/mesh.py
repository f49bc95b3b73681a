"""The device set (frtm_tpu/parallel/mesh.py).

The JAX package's `Mesh` is a set of devices that GSPMD shards a program
over. The port runs one process per card, so its counterpart is a small
record of the process group: the group (None in a world of one), this
process's rank, the world size and this process's card. The multi-sequence
engine splits each chunk of sequences over the mesh's ranks; data-parallel
training (parallel/train_step.py) splits each batch by rows.

The JAX package's sharding specs become operations here, since nothing
places a global array: `replicated` broadcasts a module's tensors from rank
0, so every process starts from the same weights, and `batch_sharded` takes
this process's rows of a global batch.
"""
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    group: Optional[object]     # the torch.distributed process group; None in a world of one
    rank: int
    size: int
    device: torch.device


def this_device(device=None) -> torch.device:
    """This process's device: by default its card (cuda:LOCAL_RANK, which
    init_distributed makes current), raising on a machine without CUDA; the
    CPU only where device="cpu" asks for it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The initialised world, or this process alone when none is
    initialised, on this process's device (`this_device(device)`). Raises
    where n_devices asks for more processes than the world has, or for
    fewer: each process drives one card, so a mesh is a whole world."""
    dev = this_device(device)
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} devices, have {size} (one process per card; "
                         "a mesh is the whole world of init_distributed)")
    return Mesh(group=group, rank=rank, size=size, device=dev)


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's, in place (the
    counterpart of a replicated sharding); returns the module. A no-op in a
    world of one."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in module.state_dict().values():
                dist.broadcast(t, src=0, group=mesh.group)
    return module


def batch_sharded(mesh: Mesh, x, batch_axis: int = 0):
    """This rank's contiguous rows (distributed.batch_rows) of a global
    batch `x` (an array or a tensor) along `batch_axis`: the rows the
    counterpart of a batch-sharded spec puts on this rank's devices."""
    from .distributed import batch_rows
    lo, hi = batch_rows(x.shape[batch_axis], mesh.rank, mesh.size)
    return x[(slice(None),) * batch_axis + (slice(lo, hi),)]
