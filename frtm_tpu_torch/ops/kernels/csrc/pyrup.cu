// Kernel 1: the decoder's 2x bicubic pyramid upsampler (the reference's
// PyrUpBicubic2d). Replaces frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas.
//
// out[Y, X] of one (N*C) plane, with R = Y + 1, C = X + 1 (the crop by 1):
//   rows of the edge-padded input a = pad(x, 2, replicate) are filtered by the
//   4-tap Keys (A=-0.75) phase taps of row parity R & 1 (even taps at phase
//   -0.25, odd at -0.75), starting at row R >> 1; the four filtered values at
//   columns (C >> 1) .. (C >> 1) + 3 are then filtered by the taps of column
//   parity C & 1. Rows first, then columns, each sum left to right with
//   round-to-nearest multiplies and adds (no FMA): the same order as
//   frtm_tpu/models/seg_network.py::pyr_up_bicubic and the port's plain
//   version, so on the card the two agree bit for bit.
//
// Bound: bytes. Each output needs 16 taps of 4-byte input and 35 flops, while
// the function moves 5 bytes per output (4 written, 1 read): ~7 flop/byte,
// below the ~20 flop/byte ridge of the f32 CUDA cores. One block computes a 16 x 64 output tile from a 12 x 36 input tile
// (2-pixel halo, edge-clamped loads instead of a padded copy) staged once in
// shared memory, so device memory sees each input about 1.3 times and each
// output once. The TPU kernel's host-side halo pre-stacking and even/odd
// output planes were Mosaic workarounds and have no counterpart here.
#include "common.cuh"

namespace {

constexpr int kTileOX = 64;                 // output columns per block
constexpr int kTileOY = 16;                 // output rows per block
constexpr int kInX = kTileOX / 2 + 4;       // input columns incl. halo
constexpr int kInY = kTileOY / 2 + 4;       // input rows incl. halo
constexpr int kThreadsX = 64;
constexpr int kThreadsY = 4;

struct Taps {
  float even[4];
  float odd[4];
};

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
pyrup_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
             Taps taps) {
  __shared__ float tile[kInY][kInX];
  const int plane = blockIdx.z;
  const int oy0 = blockIdx.y * kTileOY;
  const int ox0 = blockIdx.x * kTileOX;
  const int rb = oy0 / 2;  // tile origin in padded-input coordinates
  const int cb = ox0 / 2;
  const float* xp = x + static_cast<size_t>(plane) * H * W;

  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int idx = tid; idx < kInY * kInX; idx += kThreadsX * kThreadsY) {
    const int i = idx / kInX;
    const int j = idx - i * kInX;
    const int sy = min(max(rb + i - 2, 0), H - 1);
    const int sx = min(max(cb + j - 2, 0), W - 1);
    tile[i][j] = __ldg(xp + static_cast<size_t>(sy) * W + sx);
  }
  __syncthreads();

  const int OH = 2 * H;
  const int OW = 2 * W;
  const int ox = ox0 + threadIdx.x;
  if (ox >= OW) return;
  const int Cc = ox + 1;
  const int c = (Cc >> 1) - cb;
  float wc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) wc[k] = (Cc & 1) ? taps.odd[k] : taps.even[k];
  float* yp = y + static_cast<size_t>(plane) * OH * OW;

  for (int ty = threadIdx.y; ty < kTileOY; ty += kThreadsY) {
    const int oy = oy0 + ty;
    if (oy >= OH) break;
    const int R = oy + 1;
    const int r = (R >> 1) - rb;
    float wr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) wr[k] = (R & 1) ? taps.odd[k] : taps.even[k];
    float acc = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float col = __fmul_rn(wr[0], tile[r][c + kc]);
      col = __fadd_rn(col, __fmul_rn(wr[1], tile[r + 1][c + kc]));
      col = __fadd_rn(col, __fmul_rn(wr[2], tile[r + 2][c + kc]));
      col = __fadd_rn(col, __fmul_rn(wr[3], tile[r + 3][c + kc]));
      const float t = __fmul_rn(wc[kc], col);
      acc = kc == 0 ? t : __fadd_rn(acc, t);
    }
    yp[static_cast<size_t>(oy) * OW + ox] = acc;
  }
}

}  // namespace

// x: (planes, H, W) float32, y: (planes, 2H, 2W) float32, both contiguous.
FRTM_EXPORT int frtm_pyrup_f32(const float* x, float* y, int planes, int H,
                               int W, const float* even, const float* odd,
                               int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Taps taps;
  for (int k = 0; k < 4; ++k) {
    taps.even[k] = even[k];
    taps.odd[k] = odd[k];
  }
  dim3 block(kThreadsX, kThreadsY);
  dim3 grid((2 * W + kTileOX - 1) / kTileOX, (2 * H + kTileOY - 1) / kTileOY,
            planes);
  pyrup_kernel<<<grid, block, 0, stream>>>(x, y, H, W, taps);
  return cudaGetLastError();
}
