"""Multi-device modes on torch.distributed (frtm_tpu/parallel/), one process
per card: sequence parallelism and multi-process evaluation
(multi_sequence.py), and data-parallel training with synchronised BatchNorm
(train_step.py). Height sharding is ROADMAP.md queue item 7."""
from .distributed import (barrier, batch_rows, global_mesh, init_distributed, local_mesh,
                          process_slice)
from .mesh import Mesh, batch_sharded, make_mesh, replicated
from .multi_sequence import ShardedSequenceTracker
from .train_step import make_sharded_train_step

__all__ = ["Mesh", "make_mesh", "replicated", "batch_sharded", "ShardedSequenceTracker",
           "make_sharded_train_step", "init_distributed", "process_slice", "batch_rows",
           "local_mesh", "global_mesh", "barrier"]
