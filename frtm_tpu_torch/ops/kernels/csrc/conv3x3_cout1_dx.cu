// Kernel 2's input gradient: the adjoint of the 3x3 zero-padded conv from C
// channels to one (csrc/conv3x3_cout1.cu), float32,
//   dx[n, c, h, w] = sum over i, j of w[c, i, j] * dy[n, h + 1 - i, w + 1 - j],
// dy zero outside the image. The JAX package takes this gradient by autodiff
// of its XLA head conv (frtm_tpu/ops/conv.py::conv2d); the forward is what
// frtm_tpu/ops/pallas/conv_small.py::conv3x3_cout1_pallas computes.
//
// Bound: bytes. It reads dy once and writes C values of dx per pixel, with
// 18 flops per written value (~4.5 flop/byte). At the training shape, dy
// (16,1,480,854) and dx (16,16,480,854), that is 26.2 MB read and 419.8 MB
// written, 0.1331 ms at 3.35 TB/s: the stores are 94 % of the bytes, so the
// kernel is a store stream. This design runs at 76-77 % of that bound
// (0.1730-0.1741 ms) on an H100 80GB HBM3 at 700 W, where a zero_() of dx's
// size reaches 98 %; the design before it (a gather over a dy tile staged in
// shared memory behind a barrier, one 4-byte store per value) ran at 50 %
// (chip_smoke.py, scripts/bench_torch_conv3x3_dx.py).
//
// Design: a register walk, no shared memory, no barrier, no atomics.
//  - A thread owns two adjacent columns u0, u0 + 1 (u0 even) of a group of
//    kGroup channels and walks a stripe of kRows rows down one image.
//    Output row h meets dy rows h + 1, h and h - 1 (taps i = 0, 1, 2);
//    column u meets dy columns u + 1, u and u - 1 (taps j = 0, 1, 2). So per
//    row the thread needs dy columns u0 - 1 .. u0 + 2 of three rows: it
//    loads its own pair of the newest dy row, takes the two neighbours from
//    the adjacent lanes (__shfl_up_sync / __shfl_down_sync; lanes 0 and 31
//    load theirs, from L1 or L2), and keeps the last three rows' windows in
//    a register ring whose slots are fixed by unrolling the stripe. The next
//    dy row is loaded before the current row's sums, one row in flight ahead
//    of its use.
//  - The group's 9 kGroup weights stay in registers (36 at kGroup = 4). Per
//    row and channel: 18 FMA and one store of the pair, 8 bytes where W is
//    even and dy and dx are 8-byte aligned (rows of 3416 bytes at the
//    training width 854: a multiple of 8, not of 16, so 16-byte stores or
//    TMA, whose strides must be multiples of 16 bytes, do not fit), else
//    two 4-byte stores. The wrapper picks the width and counts it as the
//    launch's variant (v2, v1). Each value is the sum of the design before:
//    s = 0, then fmaf over the taps t = 3 i + j in order, so both widths and
//    every re-run give the same bits, and the bits of the design before.
//  - A block is one channel group of one stripe of one image and spans a
//    whole row where W allows (up to kMaxWarps = 14 warps of 64 columns, 896
//    columns; at W = 854, 14 warps), so the 32-byte sectors that two warps'
//    stores share, and those that a row's end shares with the next row's
//    start (rows of 3416 bytes start at 0, 24, 16 or 8 mod 32), are
//    completed by the same block within one row's time. Wider rows take
//    segments of equal warps. The groups of a stripe are adjacent block
//    indices, so they run together and read their dy rows from L2 once. Two
//    blocks of 14 warps fit an SM at up to 72 registers a thread
//    (__launch_bounds__).
//  - C that is not a multiple of kGroup takes a masked last group (its
//    weights read zero, its stores are not made). C is at most kMaxChannels.
//  - Stripe length: kRows = 3 rows, though each stripe loads 5 dy rows for
//    3 and the grid runs 39 waves of blocks at the training shape. By CUDA
//    events it was the fastest of 2, 3, 4, 5, 6, 8, 12, 16, 30 and 60 rows
//    there and at N = 8; from 4 rows on, the time grows with the stripe, and
//    30 rows, which a plan of whole waves took (3.9 waves), ran 22 % slower
//    (scripts/bench_torch_conv3x3_dx.py --variants). What longer stripes
//    cost is not measured.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kGroup = 4;                     // channels a thread owns
constexpr int kMaxWarps = 14;                 // warps across a block's columns
constexpr int kMaxThreads = kMaxWarps * kLanes;
constexpr int kMinBlocks = 2;                 // blocks an SM must hold (28 warps)
constexpr int kRows = 3;                      // rows in a stripe
constexpr int kMaxChannels = 1 << 16;

struct Plan {
  int warps;    // warps in a block
  int segs;     // column segments across a row
  int stripes;  // stripes of kRows rows down an image (the last may hold fewer)
  int groups;   // channel groups of kGroup
};

// two floats at p, or zero where not in the image (a: p[0], b: p[1])
template <int kVec>
__device__ __forceinline__ float2 load_pair(const float* p, bool a, bool b) {
  if constexpr (kVec == 2) {
    return a ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  } else {
    return make_float2(a ? __ldg(p) : 0.f, b ? __ldg(p + 1) : 0.f);
  }
}

// the pair (a: column u0, b: u0 + 1) at p, where in the image
template <int kVec>
__device__ __forceinline__ void store_pair(float* p, float a, float b, bool in_a, bool in_b) {
  if constexpr (kVec == 2) {
    if (in_a) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (in_a) p[0] = a;
    if (in_b) p[1] = b;
  }
}

// A thread's part of one dy row: its pair (columns u0, u0 + 1) and, in
// lanes 0 and 31, the halo column u0 - 1 or u0 + 2.
struct DyRow {
  float2 d;
  float halo;
};

// dy columns u0 - 1 .. u0 + 2 of one row (x, y, z, w)
__device__ __forceinline__ float4 window(const DyRow& r, int lane) {
  float left = __shfl_up_sync(0xffffffffu, r.d.y, 1);
  float right = __shfl_down_sync(0xffffffffu, r.d.x, 1);
  if (lane == 0) left = r.halo;
  if (lane == kLanes - 1) right = r.halo;
  return make_float4(left, r.d.x, r.d.y, right);
}

template <int kVec>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
dx_kernel(const float* __restrict__ dy, const float* __restrict__ w, float* __restrict__ dx,
          int C, int H, int W, Plan p) {
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned block = blockIdx.x;
  const int grp = block % p.groups;
  const unsigned tile = block / p.groups;
  const int seg = tile % p.segs;
  const unsigned rest = tile / p.segs;
  const int stripe = rest % p.stripes;
  const int n = rest / p.stripes;
  const int u0 = 2 * (seg * p.warps * kLanes + threadIdx.x);
  const int c0 = grp * kGroup;  // the group's first channel
  const int y0 = stripe * kRows, y1 = min(y0 + kRows, H);
  const bool in_a = u0 < W, in_b = u0 + 1 < W;
  const int halo = lane == 0 ? -1 : 2;  // the halo column's offset from u0
  const bool in_halo = (lane == 0 || lane == kLanes - 1) && u0 + halo >= 0 && u0 + halo < W;
  bool ch[kGroup];
  float wt[kGroup][9];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    ch[k] = c0 + k < C;
#pragma unroll
    for (int t = 0; t < 9; ++t) wt[k][t] = ch[k] ? __ldg(w + 9 * (c0 + k) + t) : 0.f;
  }
  const long long plane = static_cast<long long>(H) * W;
  // dy row y0 - 1 at column u0 (rows outside the image are never loaded), and
  // dx row y0 at column u0 of channel c0
  const float* g = dy + n * plane + static_cast<long long>(y0 - 1) * W + u0;
  float* out = dx + (static_cast<long long>(n) * C + c0) * plane +
               static_cast<long long>(y0) * W + u0;

  auto load_dy = [&](int h, const float* row) {
    const bool ok = h >= 0 && h < H;
    DyRow r;
    r.d = load_pair<kVec>(row, ok && in_a, ok && in_b);
    r.halo = ok && in_halo ? __ldg(row + halo) : 0.f;
    return r;
  };

  // ring slot (y - y0 + 1) mod 3 holds the window of dy row y
  float4 ring[3];
  ring[0] = window(load_dy(y0 - 1, g), lane);
  ring[1] = window(load_dy(y0, g + W), lane);
  DyRow dn = load_dy(y0 + 1, g + 2 * W);
  g += 3 * W;  // dy row y0 + 2
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    if (y0 + s < y1) {
      ring[(s + 2) % 3] = window(dn, lane);  // dy row y0 + s + 1
      if (s + 1 < kRows && y0 + s + 1 < y1) {  // the next row's loads
        dn = load_dy(y0 + s + 2, g);
        g += W;
      }
      // taps i = 0, 1, 2: dy rows y0 + s + 1, y0 + s, y0 + s - 1
      const float4 d[3] = {ring[(s + 2) % 3], ring[(s + 1) % 3], ring[s % 3]};
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // tap j pairs u0 with dy column u0 + 1 - j (z, y, x) and u0 + 1 with
        // u0 + 2 - j (w, z, y); a masked channel's sums (zero weights) are
        // not stored
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a = fmaf(wt[k][3 * i], d[i].z, a);
          b = fmaf(wt[k][3 * i], d[i].w, b);
          a = fmaf(wt[k][3 * i + 1], d[i].y, a);
          b = fmaf(wt[k][3 * i + 1], d[i].z, b);
          a = fmaf(wt[k][3 * i + 2], d[i].x, a);
          b = fmaf(wt[k][3 * i + 2], d[i].y, b);
        }
        store_pair<kVec>(out + k * plane, a, b, ch[k] && in_a, ch[k] && in_b);
      }
      out += W;
    }
  }
}

int warps_across(int W) { return ((W + 1) / 2 + kLanes - 1) / kLanes; }

// the blocks for (N, C, H, W)
Plan plan(int N, int C, int H, int W) {
  Plan p;
  const int across = warps_across(W);
  p.segs = (across + kMaxWarps - 1) / kMaxWarps;
  p.warps = (across + p.segs - 1) / p.segs;
  p.stripes = (H + kRows - 1) / kRows;
  p.groups = (C + kGroup - 1) / kGroup;
  return p;
}

bool valid(int N, int C, int H, int W) {
  if (N <= 0 || C <= 0 || C > kMaxChannels || H <= 0 || W <= 0 ||
      static_cast<long long>(H) * W >= (1LL << 31))
    return false;
  const Plan p = plan(N, C, H, W);
  return static_cast<long long>(N) * p.stripes * p.segs * p.groups < (1LL << 31);
}

}  // namespace

// The rows in a stripe (what = 0) or the warps in a block (what = 1) that
// frtm_conv3x3_cout1_dx_f32 launches for (N, C, H, W); 0 where the shape is
// refused. The card tests place their shapes around these edges.
FRTM_EXPORT int frtm_conv3x3_cout1_dx_plan(int N, int C, int H, int W, int what) {
  if (!valid(N, C, H, W)) return 0;
  return what == 0 ? kRows : plan(N, C, H, W).warps;
}

// dy: (N, 1, H, W), w: (1, C, 3, 3), dx: (N, C, H, W); float32, contiguous.
// vec: floats per load and store, 2 (W even, dy and dx 8-byte aligned) or 1.
// Refuses (cudaErrorInvalidValue) C over kMaxChannels (65536) and H * W of
// 2^31 or more.
FRTM_EXPORT int frtm_conv3x3_cout1_dx_f32(const float* dy, const float* w, float* dx, int N,
                                          int C, int H, int W, int vec, int device,
                                          cudaStream_t stream) {
  if (!valid(N, C, H, W)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (vec != 2 && vec != 1) return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx);
  if (align % (4 * vec) != 0 || (vec == 2 && W % 2 != 0)) return cudaErrorMisalignedAddress;
  const Plan p = plan(N, C, H, W);
  const unsigned blocks = static_cast<unsigned>(N) * p.stripes * p.segs * p.groups;
  const int threads = p.warps * kLanes;
  if (vec == 2)
    dx_kernel<2><<<blocks, threads, 0, stream>>>(dy, w, dx, C, H, W, p);
  else
    dx_kernel<1><<<blocks, threads, 0, stream>>>(dy, w, dx, C, H, W, p);
  return cudaGetLastError();
}
