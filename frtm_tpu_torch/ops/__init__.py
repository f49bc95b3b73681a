from .resize import resize, interpolate, adaptive_cat
from .conv import conv2d, max_pool_3x3_s2, batch_norm, relu, FrozenBatchNorm2d

__all__ = ["resize", "interpolate", "adaptive_cat", "conv2d", "max_pool_3x3_s2",
           "batch_norm", "relu", "FrozenBatchNorm2d"]
