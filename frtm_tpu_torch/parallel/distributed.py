"""Multi-process plumbing on torch.distributed (frtm_tpu/parallel/distributed.py).

Inference scales by partitioning SEQUENCES across processes: frames of one
sequence form a sequential chain, but sequences are independent, so each
process tracks a round-robin share of the dataset (`process_slice`) on its
own card, with no collective inside the loop; the only traffic is one
`barrier` before rank 0 scores. The port's idiom is one process per card, so
a process's "local devices" are its one card (`local_mesh`).

Training scales by splitting each global batch by rows (`batch_rows`): every
process materialises only its rows, which the train step uploads to its
card; no global array exists, so the JAX package's global_batch has no
counterpart. parallel/train_step.py all-reduces the BatchNorm statistics and
the gradients.

`init_distributed` reads torchrun's variables (MASTER_ADDR and MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK) where the JAX package reads
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID. Its backend
is `gloo` by default: inference's only traffic is a barrier, and NCCL
refuses two ranks on one card, which is how one card runs the multi-process
paths. Training on cards joins `nccl` (`train --multihost` / `--dp` on
`--dev cuda`); gloo also takes CUDA tensors, staging them through the host.
"""
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, this_device

# seconds a rank waits for the others at the rendezvous and in a barrier
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                     backend: str = "gloo", device=None) -> Tuple[int, int]:
    """Join the process group of a multi-process run. Returns (rank, world
    size).

    A run is multi-process when an argument or torchrun's environment says
    so: `coordinator` ("host:port", or an init URL such as "tcp://host:port"
    or "file:///path") or MASTER_ADDR:MASTER_PORT, `num_processes` or
    WORLD_SIZE, `process_id` or RANK. Otherwise this is a no-op that returns
    (0, 1). A group that is already initialised is returned as it is.

    A declared run whose initialisation fails raises: a rank that fell back
    to one process would re-track the whole dataset (process_slice keeps
    everything at n = 1) and leave the others waiting at the barrier. There
    is no counterpart of the JAX package's TPU-metadata branch
    (TPU_WORKER_HOSTNAMES): no pod runtime describes the card's machine, so
    nothing is guessed.

    device: the device this process computes on ("cuda", "cpu", a
    torch.device; None: the card where CUDA is available). Where it is a
    card, the process's card becomes cuda:LOCAL_RANK (0 where LOCAL_RANK is
    not set): one process per card. A CPU run touches no card. backend:
    "gloo" or "nccl" (cards only, one rank a card)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = _env_int("WORLD_SIZE") if num_processes is None else num_processes
    process_id = _env_int("RANK") if process_id is None else process_id
    if coordinator is None and num_processes is None and process_id is None:
        return 0, 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs its coordinator, world size and rank: "
                         f"got {coordinator!r}, {num_processes!r}, {process_id!r}")
    if torch.cuda.is_available() if device is None else torch.device(device).type == "cuda":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_slice(n_items, process_id=None, num_processes=None):
    """Round-robin item assignment for embarrassingly-parallel work
    (inference sequences): item i belongs to process (i % num_processes).
    Round-robin rather than contiguous blocks so sorted-by-length datasets
    load-balance across processes."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return list(range(pid, n_items, n))


def batch_rows(batch_size, process_id=None, num_processes=None):
    """The contiguous row range [p * b, (p + 1) * b), b = B / n, of a
    (batch_size,)-leading global batch that process p owns."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    if batch_size % n:
        raise ValueError(f"global batch {batch_size} not divisible by {n} processes")
    b = batch_size // n
    return pid * b, (pid + 1) * b


def global_mesh(device=None):
    """The mesh of every process of the run (training), on this process's
    device (mesh.this_device)."""
    return make_mesh(device=device)


def local_mesh(device=None):
    """This process alone on its device (inference: each process tracks its
    own sequences; nothing spans processes)."""
    return Mesh(group=None, rank=0, size=1, device=this_device(device))


def barrier(name: str):
    """Every process of the run waits here for the others (the counterpart
    of multihost_utils.sync_global_devices); a no-op in a world of one.
    `name` says in a failure which barrier was not reached."""
    if process_count() == 1:
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e
