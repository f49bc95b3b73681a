// Kernel 2: 3x3 stride-1 zero-padded convolution from Cin channels to ONE
// output channel, f32 accumulation, optional bias — the decoder head
// `up.conv2` at full image resolution. Replaces
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas.
//
// Bound: bytes. Per output pixel the card reads Cin input values once from
// device memory and does 2 * 9 * Cin flops on them (~4.5 flop/byte at f32),
// well below the ridge of the f32 CUDA cores; a single output channel gives a
// tensor core nothing to fill.
//
// Design. A block owns a 16-row x 128-column output tile and loops over the
// Cin channels. For each channel it stages the tile's 18 x 132 input halo in
// shared memory with cp.async, two channels deep, so channel c+1 is on its
// way while channel c is summed; each input value then crosses
// from L2 to the SM about 1.16 times (the halo), not 3 times as when every
// output row fetched its own three rows. Taps outside the image are the
// copy's zero-fill (src-size 0), which is the conv's zero padding. Input
// rows are only 8-byte aligned in general (854 floats at the main path), so
// the copies are 8 bytes (4 where W is odd, whose rows alternate), and TMA,
// whose global strides must be multiples of 16 bytes, is out. A thread owns
// one column of 8 output rows: lanes are adjacent columns, so shared-memory
// reads are free of bank conflicts, and the 10 x 3 window it reads per
// channel feeds 8 independent FMA chains. The weights sit in shared memory.
// Each thread's share of the halo copy (offsets, image-edge tests) is worked
// out once per block, not once per channel: at N = 1 the 210 blocks leave
// most SMs with two, and their instruction rate, not bytes, sets the time.
//
// The kernel is a template on the element type. The bfloat16 instance
// (frtm_conv3x3_cout1_bf16) reads half the bytes (~9 flop/byte) and keeps the
// tiles, the two-deep staging and the 8 rows per thread. Its halo sits in
// shared memory as bfloat16 and is converted to float as a thread fills its
// window; weights and bias are converted to float once per block; the 9 * Cin
// FMAs run in float32 in the float32 kernel's order and the sum is rounded
// once, at the store (the TPU kernel upcasts planes and weights the same way).
// What shifts with 2-byte elements: a column pair is 4 bytes, the least
// cp.async moves, so where W is even (rows are then 4-byte aligned) the halo
// is copied pair by pair with zero-fill; where W is odd, rows are only 2-byte
// aligned and each element goes through a plain load and store.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsX = 4;                                // warps across a tile
constexpr int kRowsPerThread = 8;
constexpr int kTileX = 32 * kWarpsX;                      // 128 output columns
constexpr int kTileY = kThreads / 32 / kWarpsX * kRowsPerThread;  // 16 output rows
constexpr int kInX = kTileX + 4;                          // input columns x0-2 .. x0+129
constexpr int kInY = kTileY + 2;
constexpr int kStageFloats = kInY * kInX;
constexpr int kStages = 2;

static_assert(kInX % 2 == 0, "a stage row is whole column pairs");
constexpr int kPairsPerRow = kInX / 2;
constexpr int kCopies = (kInY * kPairsPerRow + kThreads - 1) / kThreads;  // per thread

// A thread's share of the halo copy, the same for every channel: for each of
// its column pairs (rows y0-1 .. y0+kTileY, columns x0-2 .. x0+kTileX+1) the
// offset in a stage, and the offsets in a channel plane of its two values,
// -1 outside the image (the copy zero-fills those).
struct HaloCopies {
  int dst[kCopies];
  int src[kCopies][2];
};

__device__ __forceinline__ HaloCopies halo_copies(int y0, int x0, int H, int W) {
  HaloCopies h;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kPairsPerRow;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 2 + 2 * (e - r * kPairsPerRow);
    const bool row_in = e < kInY * kPairsPerRow && gy >= 0 && gy < H;
    h.dst[i] = e < kInY * kPairsPerRow ? 2 * e : -1;
    h.src[i][0] = row_in && gx >= 0 && gx < W ? gy * W + gx : -1;
    h.src[i][1] = row_in && gx + 1 >= 0 && gx + 1 < W ? gy * W + gx + 1 : -1;
  }
  return h;
}

// One channel's halo into st. With kPairs (W even, x 8-byte aligned) both
// values of a pair lie inside or outside the image, and one 8-byte copy
// moves them.
template <bool kPairs>
__device__ __forceinline__ void load_halo(float* st, const float* xc, const HaloCopies& h) {
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    if (h.dst[i] < 0) break;
    float* dst = st + h.dst[i];
    if (kPairs) {
      const bool in = h.src[i][0] >= 0;
      cp_async8(dst, in ? xc + h.src[i][0] : xc, in ? 8 : 0);
    } else {
      const bool in0 = h.src[i][0] >= 0, in1 = h.src[i][1] >= 0;
      cp_async4(dst, in0 ? xc + h.src[i][0] : xc, in0 ? 4 : 0);
      cp_async4(dst + 1, in1 ? xc + h.src[i][1] : xc, in1 ? 4 : 0);
    }
  }
}

// The same in bfloat16: with kPairs (W even, x 4-byte aligned) one 4-byte
// copy moves a pair; otherwise two plain stores, zero outside the image.
template <bool kPairs>
__device__ __forceinline__ void load_halo(__nv_bfloat16* st, const __nv_bfloat16* xc,
                                          const HaloCopies& h) {
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    if (h.dst[i] < 0) break;
    __nv_bfloat16* dst = st + h.dst[i];
    if (kPairs) {
      const bool in = h.src[i][0] >= 0;
      cp_async4(dst, in ? xc + h.src[i][0] : xc, in ? 4 : 0);
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      dst[0] = h.src[i][0] >= 0 ? xc[h.src[i][0]] : zero;
      dst[1] = h.src[i][1] >= 0 ? xc[h.src[i][1]] : zero;
    }
  }
}

template <typename T, bool kPairs>
__global__ void __launch_bounds__(kThreads)
conv3x3_cout1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y,
                     int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                // (C, 3, 3), as float
  T* stages = reinterpret_cast<T*>(smem + ((9 * C + 3) & ~3));  // kStages x kStageFloats
  for (int i = threadIdx.x; i < 9 * C; i += kThreads) ws[i] = to_float(w[i]);

  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* xn = x + static_cast<size_t>(blockIdx.z) * C * plane;
  const HaloCopies copies = halo_copies(y0, x0, H, W);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < C) load_halo<kPairs>(stages + s * kStageFloats, xn + s * plane, copies);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int cx = 32 * (warp % kWarpsX) + (threadIdx.x & 31);   // tile column
  const int cy = kRowsPerThread * (warp / kWarpsX);            // first tile row
  float acc[kRowsPerThread] = {};
  for (int c = 0; c < C; ++c) {
    cp_async_wait<kStages - 2>();   // channel c has landed (for this thread)
    __syncthreads();                // ... for every thread; stage (c-1) is free
    const int ahead = c + kStages - 1;
    if (ahead < C)
      load_halo<kPairs>(stages + (ahead % kStages) * kStageFloats, xn + ahead * plane, copies);
    cp_async_commit();

    const T* s = stages + (c % kStages) * kStageFloats + cy * kInX + cx + 1;
    const float* wc = ws + 9 * c;
    float win[kRowsPerThread + 2][3];
#pragma unroll
    for (int r = 0; r < kRowsPerThread + 2; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) win[r][k] = to_float(s[r * kInX + k]);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float wt = wc[t];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(wt, win[r + t / 3][t % 3], acc[r]);
    }
  }

  const int ox = x0 + cx;
  if (ox >= W) return;
  const float b = bias != nullptr ? to_float(bias[0]) : 0.f;
  T* yn = y + static_cast<size_t>(blockIdx.z) * plane + ox;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int oy = y0 + cy + r;
    if (oy < H)
      from_float(yn + static_cast<size_t>(oy) * W, bias != nullptr ? acc[r] + b : acc[r]);
  }
}

// Checks and launch for one element type; the entry points below are its
// two instances. A pair is 8 bytes of float or 4 bytes of bfloat16.
template <typename T>
int launch_conv3x3_cout1(const T* x, const T* w, const T* bias, T* y, int N, int C, int H,
                         int W, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((9 * static_cast<size_t>(C) + 3) & ~size_t(3)) +
                      sizeof(T) * kStages * kStageFloats;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, N);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  const bool pairs = W % 2 == 0 && reinterpret_cast<size_t>(x) % (2 * sizeof(T)) == 0;
  if (pairs)
    conv3x3_cout1_kernel<T, true><<<grid, kThreads, smem, stream>>>(x, w, bias, y, C, H, W);
  else
    conv3x3_cout1_kernel<T, false><<<grid, kThreads, smem, stream>>>(x, w, bias, y, C, H, W);
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, H, W), w: (1, C, 3, 3), bias: (1,) or null, y: (N, 1, H, W);
// all of one type and contiguous. Refuses (cudaErrorInvalidValue) a Cin whose
// float weights and staged halos exceed 48 KB of shared memory (Cin > 837 in
// float32, Cin > 1101 in bfloat16).
FRTM_EXPORT int frtm_conv3x3_cout1_f32(const float* x, const float* w,
                                       const float* bias, float* y, int N,
                                       int C, int H, int W, int device,
                                       cudaStream_t stream) {
  return launch_conv3x3_cout1<float>(x, w, bias, y, N, C, H, W, device, stream);
}

FRTM_EXPORT int frtm_conv3x3_cout1_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* bias, __nv_bfloat16* y, int N,
                                        int C, int H, int W, int device,
                                        cudaStream_t stream) {
  return launch_conv3x3_cout1<__nv_bfloat16>(x, w, bias, y, N, C, H, W, device, stream);
}
