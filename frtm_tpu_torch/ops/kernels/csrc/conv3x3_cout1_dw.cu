// Kernel 2's weight and bias gradient: for the 3x3 zero-padded conv from C
// channels to one (csrc/conv3x3_cout1.cu), float32,
//   dw[c, i, j] = sum over n, h, w of dy[n, h, w] * x[n, c, h + i - 1, w + j - 1],
//   db = sum of dy,
// x zero outside the image. The JAX package takes this gradient by autodiff
// of its XLA head conv (frtm_tpu/ops/conv.py::conv2d); the forward is what
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas computes.
//
// Bound: bytes. It reads x once (C values per pixel) and dy once, writes
// 9 C + 1 values, and does 18 flops per value of x (~4.5 flop/byte).
//
// Design: a deterministic two-pass reduction, no atomics, so a re-run gives
// the same bits. Pass 1: a block owns a 16-row x 128-column tile of one
// image; each thread keeps the dy of its column of 8 rows in registers and,
// channel by channel, reads its 10 x 3 window of the channel's x tile (staged
// with its halo in shared memory, zero outside the image) and forms the 9
// tap sums; the block reduces them in a fixed order (warp shuffles, then the
// 8 warps in turn) and writes one partial row of 9 C + 1 values (the last is
// the tile's dy sum). Pass 2: one block per output value sums the partials
// over the tiles in a fixed order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsX = 4;
constexpr int kRows = 8;
constexpr int kTileX = 32 * kWarpsX;                    // 128 columns
constexpr int kTileY = kWarps / kWarpsX * kRows;        // 16 rows
constexpr int kInX = kTileX + 2;
constexpr int kInY = kTileY + 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
dw_partials_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ partials, int C, int H, int W) {
  __shared__ float win[kInY * kInX];
  __shared__ float red[kWarps][10];
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cx = 32 * (warp % kWarpsX) + lane;
  const int cy = kRows * (warp / kWarpsX);
  const int ox = x0 + cx;
  const float* g = dy + static_cast<size_t>(blockIdx.z) * plane;
  float d[kRows];
  float dsum = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int oy = y0 + cy + r;
    d[r] = (ox < W && oy < H) ? g[static_cast<size_t>(oy) * W + ox] : 0.f;
    dsum += d[r];
  }
  const int out_len = 9 * C + 1;
  float* part = partials + (static_cast<size_t>(blockIdx.z) * gridDim.y * gridDim.x +
                            static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * out_len;
  {
    const float s = warp_sum(dsum);
    if (lane == 0) red[warp][9] = s;
  }
  const float* xn = x + static_cast<size_t>(blockIdx.z) * C * plane;
  for (int c = 0; c < C; ++c) {
    const float* xc = xn + c * plane;
    __syncthreads();   // the previous channel's window and sums are read
    for (int e = threadIdx.x; e < kInY * kInX; e += kThreads) {
      const int r = e / kInX, k = e - (e / kInX) * kInX;
      const int gy = y0 - 1 + r, gx = x0 - 1 + k;
      win[e] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xc[static_cast<size_t>(gy) * W + gx] : 0.f;
    }
    __syncthreads();
    // v[r][k] = x[y0 + cy + r - 1][ox + k - 1]; tap (i, j) of output row
    // y0 + cy + r reads x[h + i - 1][w + j - 1] = v[r + i][j]
    float v[kRows + 2][3];
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) v[r][k] = win[(cy + r) * kInX + cx + k];
    float acc[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) s = fmaf(d[r], v[r + t / 3][t % 3], s);
      acc[t] = warp_sum(s);
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < 9; ++t) red[warp][t] = acc[t];
    }
    __syncthreads();
    if (threadIdx.x < 9) {
      float s = 0.f;
      for (int k = 0; k < kWarps; ++k) s += red[k][threadIdx.x];
      part[9 * c + threadIdx.x] = s;
    }
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += red[k][9];
    part[9 * C] = s;
  }
}

// out[o] = sum over b of partials[b * out_len + o], in order of b per thread,
// then across the threads in a fixed tree.
__global__ void __launch_bounds__(kThreads)
dw_sum_kernel(const float* __restrict__ partials, float* __restrict__ out, int blocks,
              int out_len) {
  __shared__ float red[kWarps];
  const int o = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    s += partials[static_cast<size_t>(b) * out_len + o];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += red[k];
    out[o] = t;
  }
}

inline dim3 tiles(int N, int H, int W) {
  return dim3((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, N);
}

}  // namespace

// The number of partial rows (tiles) pass 1 writes for (N, H, W); the caller
// gives frtm_conv3x3_cout1_dw_f32 that many rows of 9 C + 1 floats.
FRTM_EXPORT long long frtm_conv3x3_cout1_dw_blocks(int N, int H, int W) {
  const dim3 g = tiles(N, H, W);
  return static_cast<long long>(g.x) * g.y * g.z;
}

// x: (N, C, H, W), dy: (N, 1, H, W), partials: (blocks, 9 C + 1) scratch,
// out: (9 C + 1,) = dw (1, C, 3, 3) then db; float32, contiguous.
FRTM_EXPORT int frtm_conv3x3_cout1_dw_f32(const float* x, const float* dy, float* partials,
                                          float* out, long long n_partials, int N, int C,
                                          int H, int W, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  const dim3 grid = tiles(N, H, W);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(grid.x) * grid.y * grid.z;
  if (blocks != n_partials || blocks > (1LL << 30)) return cudaErrorInvalidValue;
  dw_partials_kernel<<<grid, kThreads, 0, stream>>>(x, dy, partials, C, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<<<9 * C + 1, kThreads, 0, stream>>>(partials, out, static_cast<int>(blocks),
                                                   9 * C + 1);
  return cudaGetLastError();
}
