// Kernel 2: 3x3 stride-1 zero-padded convolution from Cin channels to ONE
// output channel, f32 accumulation, optional bias — the decoder head
// `up.conv2` at full image resolution. Replaces
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas.
//
// Bound: bytes. Per output pixel the card reads Cin input values once from
// device memory and does 2 * 9 * Cin flops on them (~4.5 flop/byte at f32),
// well below the ridge of the f32 CUDA cores; a single output channel gives a
// tensor core nothing to fill. Design: one thread per output pixel (threads
// along W, so a warp's loads are contiguous), the 9 * Cin weights staged in
// shared memory once per block, the 3x3 neighbourhood read through the
// read-only cache, where the three rows a block touches stay resident. The
// TPU kernel's host-side NHWC -> channel-plane transpose and halo stacking
// are gone: the port's NCHW layout already has W contiguous per channel.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
conv3x3_cout1_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int C, int H, int W) {
  extern __shared__ float ws[];  // (C, 3, 3)
  for (int i = threadIdx.x; i < 9 * C; i += kThreads) ws[i] = w[i];
  __syncthreads();

  const int n = blockIdx.z;
  const int oy = blockIdx.y;
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  if (ox >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* xn = x + static_cast<size_t>(n) * C * plane;

  const bool up = oy > 0, down = oy < H - 1, left = ox > 0, right = ox < W - 1;
  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* xc = xn + c * plane + static_cast<size_t>(oy) * W + ox;
    const float* wc = ws + 9 * c;
    if (up) {
      if (left) acc = fmaf(wc[0], __ldg(xc - W - 1), acc);
      acc = fmaf(wc[1], __ldg(xc - W), acc);
      if (right) acc = fmaf(wc[2], __ldg(xc - W + 1), acc);
    }
    if (left) acc = fmaf(wc[3], __ldg(xc - 1), acc);
    acc = fmaf(wc[4], __ldg(xc), acc);
    if (right) acc = fmaf(wc[5], __ldg(xc + 1), acc);
    if (down) {
      if (left) acc = fmaf(wc[6], __ldg(xc + W - 1), acc);
      acc = fmaf(wc[7], __ldg(xc + W), acc);
      if (right) acc = fmaf(wc[8], __ldg(xc + W + 1), acc);
    }
  }
  if (bias != nullptr) acc += bias[0];
  y[static_cast<size_t>(n) * plane + static_cast<size_t>(oy) * W + ox] = acc;
}

}  // namespace

// x: (N, C, H, W), w: (1, C, 3, 3), bias: (1,) or null, y: (N, 1, H, W);
// all float32 and contiguous.
FRTM_EXPORT int frtm_conv3x3_cout1_f32(const float* x, const float* w,
                                       const float* bias, float* y, int N,
                                       int C, int H, int W, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * 9 * C;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((W + kThreads - 1) / kThreads, H, N);
  conv3x3_cout1_kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, y, C, H, W);
  return cudaGetLastError();
}
