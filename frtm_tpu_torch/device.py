"""Device selection for the port's entry points.

The default is the card: `resolve_device(None)` returns cuda:0 and raises on a
machine without CUDA. Only an explicit `device="cpu"` runs on the CPU (the
tests pass it). A CUDA device also sets the numerics of PyTorch's libraries:
* TF32 off for matmuls and cuDNN convs: cuDNN defaults to TF32 on Hopper,
  which would put ~1e-3 relative error into the GN-CG solve and into every
  kernel-versus-plain comparison;
* cuDNN's deterministic algorithms only. The solver differentiates through
  convolutions, and cuDNN's default backward kernels sum with atomics, in an
  order that changes from run to run; the target model's least-squares
  problem is ill-conditioned, so that rounding moved part of a 480x854
  frame's labels (0.4 to 1.0 %) between two runs of the same tracker on one input
  (NVIDIA H100, rn101, seeded random weights). With deterministic kernels
  two runs agree bit for bit, as the JAX package's do.
"""
import torch


def disable_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def deterministic_convs():
    torch.backends.cudnn.deterministic = True


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "frtm_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        disable_tf32()
        deterministic_convs()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev
