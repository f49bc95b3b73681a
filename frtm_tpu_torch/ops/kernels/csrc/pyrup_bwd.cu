// Kernel 1's backward: the adjoint of the 2x bicubic pyramid upsampler
// (csrc/pyrup.cu), float32. The JAX package takes this gradient by autodiff
// of its XLA decoder (frtm_tpu/models/seg_network.py::pyr_up_bicubic); the
// forward it differentiates is the one that
// frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas computes.
//
// The forward reads padded row p = (R >> 1) + k, k = 0..3, for output row
// Y = R - 1, with the even taps where R is even and the odd taps where R is
// odd; padded row p is source row clamp(p - 2, 0, H - 1). So, per axis, the
// gradient of source index h is
//   sum over p folding onto h (p = h + 2; p = 0, 1 too where h = 0;
//   p = H + 2, H + 3 too where h = H - 1), over k = 0..3, of
//   even[k] * g[2 (p - k) - 1] + odd[k] * g[2 (p - k)],
// where g is zero outside 0 .. 2H - 1. The two axes are separable: rows
// first, then columns.
//
// Bound: bytes. Per input element the function reads 4 output gradients and
// writes one value (20 bytes) and does about 60 flops (3 flop/byte), far
// under the ridge of the f32 CUDA cores.
//
// Design: a gather, no atomics, so a re-run gives the same bits. A block
// owns a 32 x 32 tile of one plane's input gradient. It stages the 70 x 70
// window of the output gradient that the tile's taps read (rows 2 h0 - 3 ..
// 2 h0 + 66, zero outside the plane) in shared memory, applies the row
// adjoint into a 32 x 70 buffer, then the column adjoint, and writes the
// tile. Neighbouring threads take neighbouring columns, so the window's loads
// and the tile's stores are coalesced. Each sum runs in a fixed order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;               // input rows and columns per tile
constexpr int kWin = 2 * kTile + 6;     // output rows / columns the tile's taps read

struct Taps {
  float even[4];
  float odd[4];
};

// The adjoint along one axis at source index h of n: v[(Y - base) * stride]
// is the output gradient at output index Y (n outputs per 2n).
__device__ __forceinline__ float adjoint(const float* v, int stride, int base, int h, int n,
                                         const Taps& t) {
  const int p_lo = h == 0 ? 0 : h + 2;
  const int p_hi = h == n - 1 ? n + 3 : h + 2;
  float s = 0.f;
  for (int p = p_lo; p <= p_hi; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ye = 2 * (p - k) - 1;
      if (ye >= 0 && ye < 2 * n) s = fmaf(t.even[k], v[(ye - base) * stride], s);
      const int yo = ye + 1;
      if (yo >= 0 && yo < 2 * n) s = fmaf(t.odd[k], v[(yo - base) * stride], s);
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
pyrup_bwd_kernel(const float* __restrict__ gy, float* __restrict__ gx, int H, int W, Taps taps) {
  __shared__ float win[kWin * kWin];
  __shared__ float mid[kTile * kWin];
  const int h0 = blockIdx.y * kTile, w0 = blockIdx.x * kTile;
  const int y0 = 2 * h0 - 3, x0 = 2 * w0 - 3;
  const int OH = 2 * H, OW = 2 * W;
  const float* g = gy + static_cast<size_t>(blockIdx.z) * OH * OW;
  for (int e = threadIdx.x; e < kWin * kWin; e += kThreads) {
    const int i = e / kWin, j = e - (e / kWin) * kWin;
    const int Y = y0 + i, X = x0 + j;
    win[e] = (Y >= 0 && Y < OH && X >= 0 && X < OW) ? g[static_cast<size_t>(Y) * OW + X] : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kWin; e += kThreads) {
    const int r = e / kWin, j = e - (e / kWin) * kWin;
    const int h = h0 + r;
    mid[e] = h < H ? adjoint(win + j, kWin, y0, h, H, taps) : 0.f;
  }
  __syncthreads();
  float* out = gx + static_cast<size_t>(blockIdx.z) * H * W;
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, c = e - (e / kTile) * kTile;
    const int h = h0 + r, w = w0 + c;
    if (h < H && w < W)
      out[static_cast<size_t>(h) * W + w] = adjoint(mid + r * kWin, 1, x0, w, W, taps);
  }
}

}  // namespace

// gy: (planes, 2H, 2W), gx: (planes, H, W), float32, contiguous.
FRTM_EXPORT int frtm_pyrup_bwd_f32(const float* gy, float* gx, int planes, int H, int W,
                                   const float* even, const float* odd, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (planes <= 0 || H <= 0 || W <= 0 || planes > 65535) return cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < 4; ++k) {
    taps.even[k] = even[k];
    taps.odd[k] = odd[k];
  }
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, planes);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  pyrup_bwd_kernel<<<grid, kThreads, 0, stream>>>(gy, gx, H, W, taps);
  return cudaGetLastError();
}
