"""Multi-device modes on torch.distributed (frtm_tpu/parallel/): so far the
inference half, sequence parallelism and multi-process evaluation. Data-
parallel training and height sharding are ROADMAP.md queue item 7."""
from .distributed import (barrier, batch_rows, global_mesh, init_distributed, local_mesh,
                          process_slice)
from .mesh import Mesh, make_mesh
from .multi_sequence import ShardedSequenceTracker

__all__ = ["Mesh", "make_mesh", "ShardedSequenceTracker", "init_distributed",
           "process_slice", "batch_rows", "local_mesh", "global_mesh", "barrier"]
