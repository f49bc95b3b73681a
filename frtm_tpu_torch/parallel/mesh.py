"""The device set (frtm_tpu/parallel/mesh.py).

The JAX package's `Mesh` is a set of devices that GSPMD shards a program
over. The port runs one process per card, so its counterpart is a small
record of the process group: the group (None in a world of one), this
process's rank, the world size and this process's card. The multi-sequence
engine splits each chunk of sequences over the mesh's ranks. The GSPMD
sharding specs `replicated` and `batch_sharded` serve only data-parallel
training and come with it (ROADMAP.md queue item 7).
"""
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    group: Optional[object]     # the torch.distributed process group; None in a world of one
    rank: int
    size: int
    device: torch.device


def this_device() -> torch.device:
    """This process's card (init_distributed sets it from LOCAL_RANK), or
    the CPU on a machine without CUDA."""
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The initialised world, or this process alone when none is
    initialised. Raises where n_devices asks for more processes than the
    world has, or for fewer: each process drives one card, so a mesh is a
    whole world."""
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} devices, have {size} (one process per card; "
                         "a mesh is the whole world of init_distributed)")
    return Mesh(group=group, rank=rank, size=size, device=this_device())
