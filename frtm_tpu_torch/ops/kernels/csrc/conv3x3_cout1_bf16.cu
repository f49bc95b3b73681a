// Kernel 2 in bfloat16: 3x3 stride-1 zero-padded convolution from Cin
// bfloat16 channels to ONE output channel, float32 accumulation, optional
// bias — the decoder head `up.conv2` at full image resolution. Replaces
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas, as
// conv3x3_cout1.cu does in float32, with the same sums: each output's 9 * Cin
// FMAs in float32, channel after channel and tap after tap, the weights and
// bias upcast from bfloat16, the sum rounded to bfloat16 once, at the store.
//
// Bound: bytes. Per output pixel the card reads Cin 2-byte values and writes
// one, and does 18 * Cin flops (~9 flop/byte), under the ridge of the f32
// CUDA cores; a single output channel gives a tensor core nothing to fill.
// The 9 FMAs an output and channel are most of the instructions, so the
// design spends as few others as it can on each FMA.
//
// Design.
//  - A thread owns 2 adjacent output columns x 8 rows, so a window row of 4
//    values feeds 6 FMAs per tap row, and the results leave as one 4-byte
//    store of two bfloat16 per row (two 2-byte stores where W is odd). A
//    block of 128 threads owns a 16 x 128 output tile. At N = 1 (480x854)
//    that is 210 blocks for 132 SMs; a 16 x 64 tile, twice the blocks, read
//    the same time at N = 1 and 2 and 15 % more at N = 16, and a 16 x 256
//    one 14 % more at N = 16 (scripts/bench_torch_bf16_decoder.py), so
//    every launch takes this one.
//  - The halo stays bfloat16 in shared memory, as words of two values from
//    an even column, copied with 4-byte cp.async (zero-filled outside the
//    image, which is the conv's zero padding) where W is even and the input
//    4-byte aligned, else value by value. A float32 halo would spend no
//    conversions, but twice the shared-memory bandwidth: counted per warp
//    and channel, its 2 x 10 eight-byte reads and the 2-byte-strided stores
//    that convert into it take about 80 shared-memory cycles, against about
//    54 issue cycles for this loop (per window row 3 four-byte reads, one
//    wavefront each, and 4 conversions; 225 instructions a channel for 16
//    outputs in the compiled loop, 144 of them FMAs).
//  - kChans channels per stage, kStages stages: one barrier per kChans
//    channels (4 at Cin = 16, against 16 before), and kChans channels of
//    halo in flight while the previous ones are summed. A Cin that is not a
//    multiple of kChans leaves the last stage part empty. Stages of 1 or 2
//    channels, and 3 or 4 stages, measured at most 3 % faster at N = 16 and
//    up to 16 % slower at N = 1 and 2 (scripts/bench_torch_bf16_decoder.py).
//  - The weights sit in shared memory as float32, 12 a channel, read as
//    three 16-byte broadcasts.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileY = 16;
constexpr int kInY = kTileY + 2;
constexpr int kChans = 4;   // channels per stage
constexpr int kStages = 2;  // stages in flight
constexpr int kWeightStride = 12;

constexpr int kRows = 8;                                 // output rows of a thread
constexpr int kPairsX = kThreads / (kTileY / kRows);     // column pairs of a block
constexpr int kTileX = 2 * kPairsX;                      // 128
constexpr int kWordsX = kTileX / 2 + 2;                  // words from column x0-2
constexpr int kChanWords = kInY * kWordsX;
constexpr int kStageWords = kChans * kChanWords;
constexpr int kSlots = (kChanWords + kThreads - 1) / kThreads;  // copies per thread

// A thread's share of a channel's halo copy, the same for every channel:
// per word its index in the stage (-1: none) and the plane offsets of its two
// values (-1 outside the image).
struct Halo {
  int dst[kSlots];
  int src[kSlots][2];
  __device__ __forceinline__ Halo(int y0, int x0, int H, int W) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kWordsX;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 2 + 2 * (e - r * kWordsX);
      const bool row_in = e < kChanWords && gy >= 0 && gy < H;
      dst[i] = e < kChanWords ? e : -1;
      src[i][0] = row_in && gx >= 0 && gx < W ? gy * W + gx : -1;
      src[i][1] = row_in && gx + 1 >= 0 && gx + 1 < W ? gy * W + gx + 1 : -1;
    }
  }
};

// One channel's halo into st. kWords: W even and x 4-byte aligned, so a
// word's two values are both inside the image or both outside.
template <bool kWords>
__device__ __forceinline__ void load_halo(unsigned* st, const __nv_bfloat16* xc, const Halo& h) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (h.dst[i] < 0) break;
    if (kWords) {
      const bool in = h.src[i][0] >= 0;
      cp_async4(st + h.dst[i], in ? xc + h.src[i][0] : xc, in ? 4 : 0);
    } else {
      const unsigned short* u = reinterpret_cast<const unsigned short*>(xc);
      const unsigned lo = h.src[i][0] >= 0 ? u[h.src[i][0]] : 0u;
      const unsigned hi = h.src[i][1] >= 0 ? u[h.src[i][1]] : 0u;
      st[h.dst[i]] = lo | (hi << 16);
    }
  }
}

__device__ __forceinline__ float lo_half(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_half(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
conv3x3_cout1_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                          int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                           // (C, 12), as float
  unsigned* stages = reinterpret_cast<unsigned*>(smem + kWeightStride * C);
  for (int i = threadIdx.x; i < kWeightStride * C; i += kThreads) {
    const int c = i / kWeightStride, t = i - c * kWeightStride;
    ws[i] = t < 9 ? __bfloat162float(w[9 * c + t]) : 0.f;
  }

  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  const __nv_bfloat16* xn = x + static_cast<size_t>(blockIdx.z) * C * plane;
  const Halo halo(y0, x0, H, W);
  const int groups = (C + kChans - 1) / kChans;
  auto load_group = [&](int g) {
    unsigned* st = stages + (g % kStages) * kStageWords;
#pragma unroll
    for (int k = 0; k < kChans; ++k)
      if (g * kChans + k < C)
        load_halo<kWords>(st + k * kChanWords, xn + (g * kChans + k) * plane, halo);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < groups) load_group(s);
    cp_async_commit();
  }

  const int cx = threadIdx.x % kPairsX;   // column pair in the tile
  const int ry = kRows * (threadIdx.x / kPairsX);   // first tile row
  float acc[kRows][2] = {};
  for (int g = 0; g < groups; ++g) {
    cp_async_wait<kStages - 2>();   // group g has landed (for this thread)
    __syncthreads();                // ... for every thread; stage (g-1) is free
    if (g + kStages - 1 < groups) load_group(g + kStages - 1);
    cp_async_commit();
    const unsigned* st = stages + (g % kStages) * kStageWords + ry * kWordsX + cx;
    for (int k = 0; k < kChans; ++k) {
      const int c = g * kChans + k;
      if (c >= C) break;
      const float4* wv = reinterpret_cast<const float4*>(ws + kWeightStride * c);
      const float4 w0 = wv[0], w1 = wv[1], w2 = wv[2];
      const float wt[9] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x};
      const unsigned* s = st + k * kChanWords;
#pragma unroll
      for (int r = 0; r < kRows + 2; ++r) {
        // window row r: columns 2cx-1 .. 2cx+2 of the tile
        const unsigned a = s[r * kWordsX], b = s[r * kWordsX + 1],
                       d = s[r * kWordsX + 2];
        const float v0 = hi_half(a), v1 = lo_half(b), v2 = hi_half(b), v3 = lo_half(d);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int o = r - dy;   // output row that takes this window row as tap row dy
          if (o < 0 || o >= kRows) continue;
          acc[o][0] = fmaf(wt[3 * dy], v0, acc[o][0]);
          acc[o][0] = fmaf(wt[3 * dy + 1], v1, acc[o][0]);
          acc[o][0] = fmaf(wt[3 * dy + 2], v2, acc[o][0]);
          acc[o][1] = fmaf(wt[3 * dy], v1, acc[o][1]);
          acc[o][1] = fmaf(wt[3 * dy + 1], v2, acc[o][1]);
          acc[o][1] = fmaf(wt[3 * dy + 2], v3, acc[o][1]);
        }
      }
    }
  }

  const int ox = x0 + 2 * cx;
  if (ox >= W) return;
  const float b = bias != nullptr ? __bfloat162float(bias[0]) : 0.f;
  __nv_bfloat16* yn = y + static_cast<size_t>(blockIdx.z) * plane + ox;
#pragma unroll
  for (int o = 0; o < kRows; ++o) {
    const int oy = y0 + ry + o;
    if (oy >= H) break;
    const float r0 = bias != nullptr ? acc[o][0] + b : acc[o][0];
    const float r1 = bias != nullptr ? acc[o][1] + b : acc[o][1];
    __nv_bfloat16* dst = yn + static_cast<size_t>(oy) * W;
    if ((W & 1) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(r0, r1);
    } else {
      dst[0] = __float2bfloat16_rn(r0);
      if (ox + 1 < W) dst[1] = __float2bfloat16_rn(r1);
    }
  }
}

template <bool kWords>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* bias,
           __nv_bfloat16* y, int N, int C, int H, int W, cudaStream_t stream) {
  auto kernel = conv3x3_cout1_bf16_kernel<kWords>;
  const size_t smem = sizeof(float) * kWeightStride * static_cast<size_t>(C) +
                      sizeof(unsigned) * kStages * kStageWords;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, N);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, y, C, H, W);
  return cudaGetLastError();
}

}  // namespace

// x: (N, C, H, W), w: (1, C, 3, 3), bias: (1,) or null, y: (N, 1, H, W); all
// bfloat16 and contiguous, y 4-byte aligned. Refuses (cudaErrorInvalidValue) a
// Cin whose float weights and staged halos exceed 227 KB of shared memory
// (Cin > 4050).
FRTM_EXPORT int frtm_conv3x3_cout1_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* bias, __nv_bfloat16* y, int N,
                                        int C, int H, int W, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || static_cast<long long>(H) * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(y) % 4 != 0) return cudaErrorMisalignedAddress;
  const bool words = W % 2 == 0 && reinterpret_cast<size_t>(x) % 4 == 0;
  return words ? launch<true>(x, w, bias, y, N, C, H, W, stream)
               : launch<false>(x, w, bias, y, N, C, H, W, stream);
}
