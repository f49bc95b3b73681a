"""Data-parallel train step (frtm_tpu/parallel/train_step.py).

The JAX package jits the train step with the refiner replicated and the
batch sharded over the mesh's devices; GSPMD then inserts the gradient
all-reduce, and the BatchNorm statistics, reduced over the sharded batch
axis, are the global batch's. The port runs one process per card, and each
process computes the step on its rows of the global batch
(distributed.batch_rows) with the collectives written out, in
TrainerModel.train_step given the mesh's process group:
* the decoder's BatchNorms take their statistics over the global batch
  (ops/conv.py::batch_norm_train with the mesh's group), so the running
  statistics every rank writes are the same;
* the loss and the accuracy divide by the global number of valid samples,
  so a rank whose rows are all padding adds 0;
* one SUM all-reduce of every refiner gradient, through one flat buffer,
  before the AMSGrad step, which then runs alike on every rank;
* the returned loss and accuracy are the global batch's.
Parameters are broadcast from rank 0 once (mesh.replicated); the replicas
then stay equal bit for bit. torch's DistributedDataParallel and
SyncBatchNorm do not fit: the step calls seg_network_apply, not a module's
forward, and the BatchNorm is the port's own, which rounds as JAX's.
"""
import functools


def make_sharded_train_step(model, mesh):
    """The step of TrainerModel `model` over this rank's rows of a global
    batch: TrainerModel.train_step with the mesh's process group, fn(
    disc_batch, images, labels, mask, optimizer, lr) -> {"stats/loss",
    "stats/accuracy"} of the global batch, its arguments holding this rank's
    rows (images and labels (T, b, ...), disc_batch and mask (b, ...)). A
    mesh with no group (one process) gives TrainerModel.train_step itself."""
    return functools.partial(model.train_step, group=mesh.group)
