// Kernel 2's input gradient: the adjoint of the 3x3 zero-padded conv from C
// channels to one (csrc/conv3x3_cout1.cu), float32,
//   dx[n, c, h, w] = sum over i, j of w[c, i, j] * dy[n, h + 1 - i, w + 1 - j],
// dy zero outside the image. The JAX package takes this gradient by autodiff
// of its XLA head conv (frtm_tpu/ops/conv.py::conv2d); the forward is what
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas computes.
//
// Bound: bytes. Per pixel it reads one dy value and writes C values of dx,
// with 18 flops per written value (~4.5 flop/byte); the writes are nearly all
// of the bytes.
//
// Design: a gather over a dy tile staged in shared memory, no atomics. A
// block owns a 16-row x 128-column tile of one image and stages the tile's
// 18 x 130 dy window once; each thread owns one column of 8 rows and keeps
// its 10 x 3 dy neighbourhood in registers, then walks over the C channels
// (weights in shared memory) and writes 8 values per channel. Lanes are
// adjacent columns, so every store of a warp is one coalesced 128-byte row
// segment. Each value is one fixed-order sum of 9 products.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsX = 4;
constexpr int kRows = 8;                                   // output rows per thread
constexpr int kTileX = 32 * kWarpsX;                       // 128 columns
constexpr int kTileY = kThreads / 32 / kWarpsX * kRows;    // 16 rows
constexpr int kInX = kTileX + 2;
constexpr int kInY = kTileY + 2;

__global__ void __launch_bounds__(kThreads)
conv3x3_cout1_dx_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                        float* __restrict__ dx, int C, int H, int W) {
  extern __shared__ float smem[];
  float* ws = smem;                  // (C, 3, 3)
  float* win = smem + 9 * C;         // dy rows y0 - 1 .. y0 + kTileY, cols x0 - 1 .. x0 + kTileX
  for (int i = threadIdx.x; i < 9 * C; i += kThreads) ws[i] = w[i];
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* g = dy + static_cast<size_t>(blockIdx.z) * plane;
  for (int e = threadIdx.x; e < kInY * kInX; e += kThreads) {
    const int r = e / kInX, c = e - (e / kInX) * kInX;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    win[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? g[static_cast<size_t>(gy) * W + gx] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int cx = 32 * (warp % kWarpsX) + (threadIdx.x & 31);
  const int cy = kRows * (warp / kWarpsX);
  const int ox = x0 + cx;
  if (ox >= W) return;
  // v[r][k] = dy[y0 + cy + r - 1][ox + k - 1]; output row y0 + cy + r reads
  // dy[h + 1 - i][w + 1 - j] = v[r + 2 - i][2 - j]
  float v[kRows + 2][3];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) v[r][k] = win[(cy + r) * kInX + cx + k];
  float* out = dx + static_cast<size_t>(blockIdx.z) * C * plane + ox;
  for (int c = 0; c < C; ++c) {
    const float* wc = ws + 9 * c;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int oy = y0 + cy + r;
      if (oy >= H) break;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 9; ++t) s = fmaf(wc[t], v[r + 2 - t / 3][2 - t % 3], s);
      out[c * plane + static_cast<size_t>(oy) * W] = s;
    }
  }
}

}  // namespace

// dy: (N, 1, H, W), w: (1, C, 3, 3), dx: (N, C, H, W); float32, contiguous.
// Refuses (cudaErrorInvalidValue) a C whose weights and dy window exceed
// 48 KB of shared memory (C > 1106).
FRTM_EXPORT int frtm_conv3x3_cout1_dx_f32(const float* dy, const float* w, float* dx, int N,
                                          int C, int H, int W, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (9 * static_cast<size_t>(C) + kInY * kInX);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, N);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  conv3x3_cout1_dx_kernel<<<grid, kThreads, smem, stream>>>(dy, w, dx, C, H, W);
  return cudaGetLastError();
}
