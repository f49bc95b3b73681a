"""The port's hand-written Hopper kernels, one per Pallas kernel of frtm_tpu,
each beside its plain PyTorch version, and the backward kernels of kernels 1
and 2 (the gradients the JAX package takes by autodiff). A wrapper launches
its kernel for a CUDA tensor and runs the plain version for a CPU tensor."""
from . import build
from .build import KERNELS, LAUNCHES, VARIANTS, reset_launches
from .pyrup import (pyr_up_bicubic, pyr_up_bicubic_backward, pyr_up_bicubic_backward_plain,
                    pyr_up_bicubic_plain)
from .conv3x3_cout1 import (conv3x3_cout1, conv3x3_cout1_input_grad,
                            conv3x3_cout1_input_grad_plain, conv3x3_cout1_plain,
                            conv3x3_cout1_weight_grad, conv3x3_cout1_weight_grad_plain)
from .warp_affine import warp_affine

__all__ = ["KERNELS", "LAUNCHES", "VARIANTS", "build", "reset_launches",
           "pyr_up_bicubic", "pyr_up_bicubic_plain", "pyr_up_bicubic_backward",
           "pyr_up_bicubic_backward_plain", "conv3x3_cout1", "conv3x3_cout1_plain",
           "conv3x3_cout1_input_grad", "conv3x3_cout1_input_grad_plain",
           "conv3x3_cout1_weight_grad", "conv3x3_cout1_weight_grad_plain", "warp_affine"]
