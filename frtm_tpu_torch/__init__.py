"""frtm_tpu_torch — the PyTorch / CUDA port of frtm_tpu for NVIDIA Hopper.

The package mirrors frtm_tpu's layout (ops/, models/, runtime/, data/,
utils/, config.py) with PyTorch idiom: NCHW activations, OIHW weights,
nn.Modules carrying the reference checkpoint's parameter names. The three
Pallas kernels of the JAX package are hand-written CUDA kernels for sm_90a
here (ops/kernels/), each beside a plain PyTorch version of the same
function. Entry points run on the card unless the caller passes
device="cpu"; on the CPU every kernel wrapper runs its plain version.

The package imports torch and numpy only: nothing of JAX or frtm_tpu, and
no cv2 or PIL. What the JAX package leaves to OpenCV, PIL and its own C++
library on the host (Telea inpainting, JPEG decoding) the port does in its
host library, utils/csrc/frtm_host.cpp, built with the host compiler at
first use (utils/native.py).
"""
