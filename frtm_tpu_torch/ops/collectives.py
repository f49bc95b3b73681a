"""The collectives of the data-parallel trainer.

The JAX package's data-parallel step has no collective in its source: GSPMD
inserts them where a reduction spans the sharded batch axis. The port runs one
process per card, so the reductions that must span the global batch (the
decoder's BatchNorm statistics, the valid count, the loss and the gradients)
sum over the processes explicitly.
"""
import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group. The gradient of every rank's input is
    the sum over the ranks of the output's gradients, so the backward is the
    same all-reduce."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(t, group=None):
    """`t` summed over the ranks of a torch.distributed process group, with
    its gradient; `t` itself where group is None (this process alone)."""
    return t if group is None else _AllReduceSum.apply(t, group)


def all_reduce_grads(params, group):
    """Every parameter's gradient summed over the ranks of `group`, in one
    all-reduce of a flat buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
