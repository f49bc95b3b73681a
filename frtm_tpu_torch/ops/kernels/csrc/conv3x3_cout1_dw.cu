// Kernel 2's weight and bias gradient: for the 3x3 zero-padded conv from C
// channels to one (csrc/conv3x3_cout1.cu), float32,
//   dw[c, i, j] = sum over n, h, w of dy[n, h, w] * x[n, c, h + i - 1, w + j - 1],
//   db = sum of dy,
// x zero outside the image. The JAX package takes this gradient by autodiff
// of its XLA head conv (frtm_tpu/ops/conv.py::conv2d); the forward is what
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas computes.
//
// Bound: bytes. It reads x once (C values per pixel) and dy once, writes
// 9 C + 1 values, and does 18 flops per value of x (~4.5 flop/byte). At the
// training shape, x (16,16,480,854), this design runs at 75-80 % of the
// byte bound on an H100 80GB HBM3 at 700 W (scripts/bench_torch_conv3x3_dw.py,
// chip_smoke.py); the kernel it replaced ran at 41 %.
//
// Design: a deterministic two-pass reduction, no atomics, so a re-run gives
// the same bits.
//  - Pass 1 streams rows and keeps every sum in registers. A thread owns two
//    adjacent columns u0, u0 + 1 (u0 even) of a group of kGroup channels and
//    walks a stripe of x rows down one image. x row y meets dy rows y + 1, y
//    and y - 1 (taps i = 0, 1, 2); column u meets dy columns u + 1, u and
//    u - 1 (taps j = 0, 1, 2). So per row the thread needs dy columns
//    u0 - 1 .. u0 + 2 of three rows: it loads its own pair of the newest dy
//    row once for all its channels, takes the two neighbours from the
//    adjacent lanes (__shfl_up_sync / __shfl_down_sync; lanes 0 and 31 load
//    theirs, from L1 or L2), and keeps the last three rows' windows in a
//    register ring whose slots are fixed by unrolling the walk 3 rows at a
//    time. Per row and channel: one load of its two x values and 18 FMA
//    into 9 tap sums. x is read exactly once: the stripes split x's rows,
//    and only dy has halo rows (one above and one below a stripe).
//  - A block holds kGroups channel groups (threadIdx.y) of one column
//    segment of one stripe, so a dy row reaches the SM once and the other
//    groups read it from L1. Every group sums dy's own pair of its rows
//    (the stripe's rows, so each dy value counts once); group 0 of chunk 0
//    keeps that sum as db's partial. C that is not a multiple of the group
//    size takes a masked last group (its loads read zero, its sums are not
//    written); C over kChunk channels takes more chunks (gridDim.y).
//  - Only after its whole stripe does a block reduce, once, in a fixed
//    order: warp shuffles, then the warps of each group in turn through
//    shared memory, one partial per output value. Partials are stored
//    transposed, partials[o * tiles + tile], so that pass 2 reads each
//    output's row with consecutive threads on consecutive addresses and
//    sums it in a fixed order (per thread, then a shuffle tree, then the
//    warps in turn).
//  - Loads: the next row's x and dy are loaded before the current row's
//    FMAs, one row in flight ahead of its use (two ahead cost pyrup_bwd
//    16-17 % through registers). Addresses are a pointer advanced one row a
//    step plus per-channel plane offsets. Width: 8 bytes (one float2 per
//    channel and row) where W is even and x and dy are 8-byte aligned
//    (rows of 3416 bytes at the training width 854: a multiple of 8, not of
//    16, so 16-byte loads or TMA, whose strides must be multiples of 16
//    bytes, do not fit); else 4 bytes. The wrapper picks the width and
//    counts it as the launch's variant (v2, v1); both give the same bits.
//  - Stripe length: rows from kMinRows to kMaxRows, picked per launch from
//    the grid's waves of resident blocks: the least waves * (rows +
//    kReduceRows), the block's reduction counted as kReduceRows rows of the
//    walk. The plan depends on the card and the shape only, not on the width,
//    so both widths sum in one order.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarpsX = 2;                   // warps across a column segment
constexpr int kPairs = kLanes * kWarpsX;     // column pairs in a segment
constexpr int kGroup = 4;                    // channels a thread owns
constexpr int kGroups = 4;                   // channel groups in a block
constexpr int kChunk = kGroup * kGroups;     // channels a block owns
constexpr int kThreads = kPairs * kGroups;
constexpr int kMinBlocks = 3;                // blocks an SM must hold (24 warps)
constexpr int kMinRows = 8, kMaxRows = 32;   // rows in a stripe
constexpr int kReduceRows = 4;               // the closing reduction, in rows of the walk
constexpr int kTaps = 9 * kGroup;            // a thread's tap sums
constexpr int kSumThreads = 256;             // pass 2
constexpr int kMaxDevices = 64;
static_assert(kGroups * (kTaps + 1) <= kThreads, "one thread per output of the block");

struct Plan {
  int segs;         // column segments across a row
  int stripes;      // stripes of rows down an image
  int rows;         // rows in a stripe (the last may hold fewer)
  int chunks;       // channel chunks of kChunk
  long long tiles;  // N * stripes * segs: the partials of each output value
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// two floats at p, or zero where not in the image (a: p[0], b: p[1])
template <int kVec>
__device__ __forceinline__ float2 load_pair(const float* p, bool a, bool b) {
  if constexpr (kVec == 2) {
    return a ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  } else {
    return make_float2(a ? __ldg(p) : 0.f, b ? __ldg(p + 1) : 0.f);
  }
}

// A thread's part of one dy row: its pair (columns u0, u0 + 1) and, in
// lanes 0 and 31, the halo column u0 - 1 or u0 + 2.
struct DyRow {
  float2 d;
  float halo;
};

// dy columns u0 - 1 .. u0 + 2 of one row
__device__ __forceinline__ float4 window(const DyRow& r, int lane) {
  float left = __shfl_up_sync(0xffffffffu, r.d.y, 1);
  float right = __shfl_down_sync(0xffffffffu, r.d.x, 1);
  if (lane == 0) left = r.halo;
  if (lane == kLanes - 1) right = r.halo;
  return make_float4(left, r.d.x, r.d.y, right);
}

// the taps (i, 0..2) of x values a (column u0) and b (u0 + 1) against
// window d of dy row y - i + 1: tap j pairs u0 with column u0 - j + 1
__device__ __forceinline__ void taps3(float* t, float a, float b, float4 d) {
  t[0] = fmaf(b, d.w, fmaf(a, d.z, t[0]));
  t[1] = fmaf(b, d.z, fmaf(a, d.y, t[1]));
  t[2] = fmaf(b, d.y, fmaf(a, d.x, t[2]));
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw_partials_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ partials, int C, int H, int W, Plan p) {
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned tile = blockIdx.x;
  const int seg = tile % p.segs;
  const unsigned rest = tile / p.segs;
  const int stripe = rest % p.stripes;
  const int n = rest / p.stripes;
  const int u0 = 2 * (seg * kPairs + threadIdx.x);
  const int c0 = blockIdx.y * kChunk + threadIdx.y * kGroup;  // the group's first channel
  const int y0 = stripe * p.rows, y1 = min(y0 + p.rows, H);
  const bool in_a = u0 < W, in_b = u0 + 1 < W;
  const int halo = lane == 0 ? -1 : 2;  // the halo column's offset from u0
  const bool in_halo = (lane == 0 || lane == kLanes - 1) && u0 + halo >= 0 && u0 + halo < W;
  bool ch_a[kGroup], ch_b[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    ch_a[k] = c0 + k < C && in_a;
    ch_b[k] = c0 + k < C && in_b;
  }
  const long long plane = static_cast<long long>(H) * W;
  // x row y0 at column u0 of channel c0, and dy row y0 - 1 at column u0
  // (rows outside the image are never loaded)
  const float* xr = x + (static_cast<long long>(n) * C + c0) * plane +
                    static_cast<long long>(y0) * W + u0;
  const float* g = dy + n * plane + static_cast<long long>(y0 - 1) * W + u0;

  auto load_dy = [&](int h, const float* row) {
    const bool ok = h >= 0 && h < H;
    DyRow r;
    r.d = load_pair<kVec>(row, ok && in_a, ok && in_b);
    r.halo = ok && in_halo ? __ldg(row + halo) : 0.f;
    return r;
  };
  auto load_x = [&](const float* row, float2(&v)[kGroup]) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = load_pair<kVec>(row + k * plane, ch_a[k], ch_b[k]);
  };

  float acc[kGroup][9];
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[k][t] = 0.f;
  float db = 0.f;
  // ring slot (y - y0 + 1) mod 3 holds the window of dy row y
  float4 ring[3];
  ring[0] = window(load_dy(y0 - 1, g), lane);
  ring[1] = window(load_dy(y0, g + W), lane);
  DyRow dn = load_dy(y0 + 1, g + 2 * W);
  float2 xn[kGroup];
  load_x(xr, xn);
  g += 3 * W;  // dy row y0 + 2
  for (int y = y0; y < y1; y += 3) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (y + s < y1) {
        float2 xc[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) xc[k] = xn[k];
        ring[(s + 2) % 3] = window(dn, lane);  // dy row y + s + 1
        if (y + s + 1 < y1) {                  // the next row's loads
          xr += W;
          load_x(xr, xn);
          dn = load_dy(y + s + 2, g);
          g += W;
        }
        const float4 d0 = ring[(s + 2) % 3], d1 = ring[(s + 1) % 3], d2 = ring[s % 3];
        db += d1.y + d1.z;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          taps3(acc[k], xc[k].x, xc[k].y, d0);
          taps3(acc[k] + 3, xc[k].x, xc[k].y, d1);
          taps3(acc[k] + 6, xc[k].x, xc[k].y, d2);
        }
      }
    }
  }

  __shared__ float red[kGroups][kWarpsX][kTaps + 1];
  const int wx = threadIdx.x / kLanes;
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float s = warp_sum(acc[k][t]);
      if (lane == 0) red[threadIdx.y][wx][9 * k + t] = s;
    }
  if (threadIdx.y == 0) {
    const float s = warp_sum(db);
    if (lane == 0) red[0][wx][kTaps] = s;
  }
  __syncthreads();
  const int i = threadIdx.y * kPairs + threadIdx.x;
  if (i < kGroups * (kTaps + 1)) {
    const int grp = i / (kTaps + 1), v = i % (kTaps + 1);
    const int c = blockIdx.y * kChunk + grp * kGroup + v / 9;
    const bool tap = v < kTaps && c < C;
    const bool bias = v == kTaps && grp == 0 && blockIdx.y == 0;
    if (tap || bias) {
      float s = red[grp][0][v];
#pragma unroll
      for (int w = 1; w < kWarpsX; ++w) s += red[grp][w][v];
      const long long o = tap ? 9LL * c + v % 9 : 9LL * C;
      partials[o * p.tiles + tile] = s;
    }
  }
}

// out[o] = the sum of partials[o * tiles ..][0 .. tiles): per thread in
// order of b, then a shuffle tree, then the warps in turn.
__global__ void __launch_bounds__(kSumThreads)
dw_sum_kernel(const float* __restrict__ partials, float* __restrict__ out, long long tiles) {
  __shared__ float red[kSumThreads / kLanes];
  const float* row = partials + blockIdx.x * tiles;
  float s = 0.f;
  for (long long b = threadIdx.x; b < tiles; b += kSumThreads) s += row[b];
  s = warp_sum(s);
  if ((threadIdx.x & (kLanes - 1)) == 0) red[threadIdx.x / kLanes] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int k = 1; k < kSumThreads / kLanes; ++k) t += red[k];
    out[blockIdx.x] = t;
  }
}

// the stripes for (N, C, H, W) on `device`; rows = 0 where the card cannot
// be read
Plan plan(int N, int C, int H, int W, int device) {
  static int resident[kMaxDevices];  // blocks the card holds at once
  Plan p{};
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_partials_kernel<2>, kThreads,
                                                      0) != cudaSuccess ||
        sms * per_sm == 0)
      return p;
    resident[device] = sms * per_sm;
  }
  p.segs = ((W + 1) / 2 + kPairs - 1) / kPairs;
  p.chunks = (C + kChunk - 1) / kChunk;
  long long best = -1;
  for (int rows = kMinRows; rows <= kMaxRows; ++rows) {
    const int stripes = (H + rows - 1) / rows;
    const long long blocks = static_cast<long long>(N) * stripes * p.segs * p.chunks;
    const long long cost = (blocks + resident[device] - 1) / resident[device] *
                           (std::min(rows, H) + kReduceRows);
    if (best < 0 || cost < best) {
      best = cost;
      p.rows = rows;
      p.stripes = stripes;
    }
  }
  p.tiles = static_cast<long long>(N) * p.stripes * p.segs;
  return p;
}

bool valid(int N, int C, int H, int W, int device) {
  return device >= 0 && device < kMaxDevices && N > 0 && C > 0 && H > 0 && W > 0 &&
         static_cast<long long>(C) * H * W < (1LL << 31) &&
         static_cast<long long>(N) * ((H + kMinRows - 1) / kMinRows) *
                 (((W + 1) / 2 + kPairs - 1) / kPairs) < (1LL << 31) &&
         (C + kChunk - 1) / kChunk <= 65535;
}

}  // namespace

// The number of partials of each output value (tiles) pass 1 writes for
// (N, C, H, W) on `device`; the caller gives frtm_conv3x3_cout1_dw_f32 a
// scratch of (9 C + 1) * tiles floats. -1 where the shape is refused or
// the card cannot be read.
FRTM_EXPORT long long frtm_conv3x3_cout1_dw_blocks(int N, int C, int H, int W, int device) {
  if (!valid(N, C, H, W, device) || cudaSetDevice(device) != cudaSuccess) return -1;
  const Plan p = plan(N, C, H, W, device);
  return p.rows ? p.tiles : -1;
}

// The rows in a stripe for that launch (0 where refused): the stripe edges
// the card tests place their shapes around.
FRTM_EXPORT int frtm_conv3x3_cout1_dw_rows(int N, int C, int H, int W, int device) {
  if (!valid(N, C, H, W, device) || cudaSetDevice(device) != cudaSuccess) return 0;
  return plan(N, C, H, W, device).rows;
}

// x: (N, C, H, W), dy: (N, 1, H, W), partials: ((9 C + 1) * tiles,)
// scratch, out: (9 C + 1,) = dw (1, C, 3, 3) then db; float32, contiguous.
// vec: floats per load, 2 (W even, x and dy 8-byte aligned) or 1.
FRTM_EXPORT int frtm_conv3x3_cout1_dw_f32(const float* x, const float* dy, float* partials,
                                          float* out, long long tiles, int N, int C, int H,
                                          int W, int vec, int device, cudaStream_t stream) {
  if (!valid(N, C, H, W, device)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (vec != 2 && vec != 1) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy);
  if (align % (4 * vec) != 0 || (vec == 2 && W % 2 != 0)) return cudaErrorMisalignedAddress;
  const Plan p = plan(N, C, H, W, device);
  if (p.rows == 0) return cudaErrorInvalidConfiguration;
  if (p.tiles != tiles) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(p.tiles), p.chunks), block(kPairs, kGroups);
  if (vec == 2)
    dw_partials_kernel<2><<<grid, block, 0, stream>>>(x, dy, partials, C, H, W, p);
  else
    dw_partials_kernel<1><<<grid, block, 0, stream>>>(x, dy, partials, C, H, W, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_sum_kernel<<<9 * C + 1, kSumThreads, 0, stream>>>(partials, out, p.tiles);
  return cudaGetLastError();
}
