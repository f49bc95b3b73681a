"""Device selection for the port's entry points.

The default is the card: `resolve_device(None)` returns cuda:0 and raises on a
machine without CUDA. Only an explicit `device="cpu"` runs on the CPU (the
tests pass it). A CUDA device also turns TF32 off for matmuls and cuDNN
convs: cuDNN defaults to TF32 on Hopper, which would put ~1e-3 relative error
into the GN-CG solve and into every kernel-versus-plain comparison.
"""
import torch


def disable_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "frtm_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions")
        disable_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev
