"""Kernel 2: 3x3 stride-1 zero-padded conv from Cin channels to one output
channel (the decoder head `up.conv2`), replacing
frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas.

`conv3x3_cout1` launches csrc/conv3x3_cout1.cu (float32) or
csrc/conv3x3_cout1_bf16.cu (bfloat16) on CUDA tensors and runs the plain
version — the same 9 * Cin tap sum written with tensor ops — on CPU
tensors.

float32 and bfloat16, one kernel instance each; input, weight and bias share
the type. In bfloat16 both the kernel and the plain version upcast planes and
(bfloat16-rounded) weights to float32, accumulate in float32 and round the
sum once, as the TPU kernel does; the JAX decoder's own bfloat16 convolution
rounds differently.

Gradient: `conv3x3_cout1` is differentiable (a torch.autograd.Function)
where an input requires a gradient and autograd records, in float32 only.
On the card its backward launches csrc/conv3x3_cout1_dx.cu for the input
gradient and csrc/conv3x3_cout1_dw.cu for the weight and bias gradients, each
only where it is needed; on the CPU it runs the plain backward (autograd of
the plain forward). Both kernels read (dw) or store (dx) 8 bytes at a time
where W is even and the tensors 8-byte aligned, else 4 (`pair_width`,
`build.VARIANTS`: v2, v1); both widths give the same bits. The bfloat16
instance serves inference only; a backward through it raises. Under `torch.no_grad`, or where nothing needs a gradient,
the forward runs as a plain call and records nothing.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import build


def conv3x3_cout1_plain(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x (N, C, H, W), w (1, C, 3, 3), b (1,) or None -> (N, 1, H, W)."""
    if x.dtype == torch.bfloat16:
        return conv3x3_cout1_plain(x.float(), w.float(),
                                   None if b is None else b.float()).to(torch.bfloat16)
    n, c, h, wd = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = None
    for di in range(3):
        for dj in range(3):
            t = torch.einsum("c,nchw->nhw", w[0, :, di, dj],
                             xp[:, :, di:di + h, dj:dj + wd])
            acc = t if acc is None else acc + t
    y = acc[:, None]
    return y if b is None else y + b.reshape(1, 1, 1, 1)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
# the library of each instance: the bfloat16 one is its own design
_SOURCES = {"f32": "conv3x3_cout1", "bf16": "conv3x3_cout1_bf16"}


def _forward(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    instance = build.instance_of(x, "conv3x3_cout1 input")
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError(f"conv3x3_cout1: input {x.dtype}, weight {w.dtype} and bias "
                        f"{None if b is None else b.dtype} must share one type")
    if x.device.type == "cpu":
        return conv3x3_cout1_plain(x, w, b)
    build.check_cuda_tensor(x, "conv3x3_cout1 input", 4, x.dtype)
    build.check_cuda_tensor(w, "conv3x3_cout1 weight", 4, x.dtype)
    n, c, h, wd = x.shape
    if tuple(w.shape) != (1, c, 3, 3):
        raise ValueError(f"conv3x3_cout1: weight shape {tuple(w.shape)} != (1, {c}, 3, 3)")
    if b is not None:
        build.check_cuda_tensor(b, "conv3x3_cout1 bias", 1, x.dtype)
        if b.numel() != 1:
            raise ValueError("conv3x3_cout1: bias must have one element")
    y = torch.empty((n, 1, h, wd), dtype=x.dtype, device=x.device)
    build.launch("conv3x3_cout1", f"frtm_conv3x3_cout1_{instance}", _ARGTYPES,
                 x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                 y.data_ptr(), n, c, h, wd, device=x.device, variant=instance,
                 source=_SOURCES[instance])
    return y


def conv3x3_cout1_input_grad_plain(gy: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """dx of conv3x3_cout1_plain for output gradient gy (N, 1, H, W), taken
    by autograd; the conv is linear in x, so x's values do not enter."""
    with torch.enable_grad():
        x = torch.zeros(tuple(x_shape), dtype=gy.dtype, device=gy.device, requires_grad=True)
        (dx,) = torch.autograd.grad(conv3x3_cout1_plain(x, w.detach()), x, gy)
    return dx


def conv3x3_cout1_weight_grad_plain(x: torch.Tensor, gy: torch.Tensor, w_shape):
    """(dw (1, C, 3, 3), db (1,)) of conv3x3_cout1_plain, taken by autograd;
    the conv is affine in (w, b), so their values do not enter."""
    with torch.enable_grad():
        w = torch.zeros(tuple(w_shape), dtype=gy.dtype, device=gy.device, requires_grad=True)
        b = torch.zeros(1, dtype=gy.dtype, device=gy.device, requires_grad=True)
        dw, db = torch.autograd.grad(conv3x3_cout1_plain(x.detach(), w, b), (w, b), gy)
    return dw, db


def _check_grad(gy, what):
    if gy.dtype != torch.float32:
        raise TypeError(f"conv3x3_cout1 {what}: float32 only (the bfloat16 instance serves "
                        f"inference), got a {gy.dtype} gradient")


_DX_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
_DW_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]


def pair_width(w: int, *ptrs: int) -> int:
    """Floats per load or store of the backward kernels, which move column
    pairs: 2 where every row starts 8-byte aligned (W even, each pointer
    8-byte aligned), else 1. Both widths give the same sums in the same
    order."""
    return 2 if w % 2 == 0 and all(p % 8 == 0 for p in ptrs) else 1


def conv3x3_cout1_input_grad(gy: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """Output gradient (N, 1, H, W) and weight (1, C, 3, 3), float32 ->
    input gradient (N, C, H, W): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check_grad(gy, "input gradient")
    n, c, h, wd = x_shape
    if tuple(gy.shape) != (n, 1, h, wd) or tuple(w.shape) != (1, c, 3, 3):
        raise ValueError(f"conv3x3_cout1 input gradient: gradient {tuple(gy.shape)}, weight "
                         f"{tuple(w.shape)} for input {tuple(x_shape)}")
    if gy.device.type == "cpu":
        return conv3x3_cout1_input_grad_plain(gy, w, x_shape)
    gy, w = gy.contiguous(), w.detach().contiguous()
    build.check_cuda_tensor(gy, "conv3x3_cout1 output gradient", 4)
    build.check_cuda_tensor(w, "conv3x3_cout1 weight", 4)
    dx = torch.empty((n, c, h, wd), dtype=gy.dtype, device=gy.device)
    vec = pair_width(wd, gy.data_ptr(), dx.data_ptr())
    build.launch("conv3x3_cout1_dx", "frtm_conv3x3_cout1_dx_f32", _DX_ARGTYPES,
                 gy.data_ptr(), w.data_ptr(), dx.data_ptr(), n, c, h, wd, vec,
                 device=gy.device, variant=f"v{vec}")
    return dx


def conv3x3_cout1_weight_grad(x: torch.Tensor, gy: torch.Tensor):
    """Input (N, C, H, W) and output gradient (N, 1, H, W), float32 ->
    (dw (1, C, 3, 3), db (1,)): the kernel on CUDA tensors, the plain version
    on CPU tensors."""
    _check_grad(gy, "weight gradient")
    n, c, h, wd = x.shape
    if tuple(gy.shape) != (n, 1, h, wd):
        raise ValueError(f"conv3x3_cout1 weight gradient: gradient {tuple(gy.shape)} for "
                         f"input {tuple(x.shape)}")
    if gy.device.type == "cpu":
        return conv3x3_cout1_weight_grad_plain(x, gy, (1, c, 3, 3))
    x, gy = x.detach().contiguous(), gy.contiguous()
    build.check_cuda_tensor(x, "conv3x3_cout1 input", 4)
    build.check_cuda_tensor(gy, "conv3x3_cout1 output gradient", 4)
    tiles = weight_grad_plan(n, c, h, wd, gy.device, "blocks")
    vec = pair_width(wd, x.data_ptr(), gy.data_ptr())
    partials = torch.empty((9 * c + 1) * tiles, dtype=gy.dtype, device=gy.device)
    out = torch.empty(9 * c + 1, dtype=gy.dtype, device=gy.device)
    build.launch("conv3x3_cout1_dw", "frtm_conv3x3_cout1_dw_f32", _DW_ARGTYPES,
                 x.data_ptr(), gy.data_ptr(), partials.data_ptr(), out.data_ptr(), tiles,
                 n, c, h, wd, vec, device=gy.device, variant=f"v{vec}")
    return out[:9 * c].view(1, c, 3, 3), out[9 * c:]


def weight_grad_plan(n, c, h, w, device: torch.device, what="rows") -> int:
    """What csrc/conv3x3_cout1_dw.cu plans for input (n, c, h, w) on a CUDA
    device: "blocks", the partials of each output value (the tiles of pass
    1), or "rows", the rows in a stripe."""
    fn = getattr(build.library("conv3x3_cout1_dw"), f"frtm_conv3x3_cout1_dw_{what}")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong if what == "blocks" else ctypes.c_int
    index = device.index if device.index is not None else torch.cuda.current_device()
    got = fn(n, c, h, w, index)
    if got <= 0:
        raise RuntimeError(f"conv3x3_cout1 weight gradient: no plan for input "
                           f"{(n, c, h, w)} on {device}")
    return got


def input_grad_plan(n, c, h, w, what="rows") -> int:
    """What csrc/conv3x3_cout1_dx.cu launches for input gradient (n, c, h,
    w): "rows", the rows in a stripe, or "warps", the warps across a block's
    column segment."""
    fn = build.library("conv3x3_cout1_dx").frtm_conv3x3_cout1_dx_plan
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    got = fn(n, c, h, w, {"rows": 0, "warps": 1}[what])
    if got <= 0:
        raise RuntimeError(f"conv3x3_cout1 input gradient: no plan for {(n, c, h, w)}")
    return got


class _Conv3x3Cout1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_cout1_input_grad(gy, w, x.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv3x3_cout1_weight_grad(x, gy)
        return dx, dw, db if ctx.has_bias else None


def conv3x3_cout1(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x (N, C, H, W), w (1, C, 3, 3), b (1,) or None -> (N, 1, H, W);
    differentiable where an input requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return _Conv3x3Cout1.apply(x, w, b)
    return _forward(x, w, b)
