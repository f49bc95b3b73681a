// Kernel 1's backward: the adjoint of the 2x bicubic pyramid upsampler
// (csrc/pyrup.cu), float32. The JAX package takes this gradient by autodiff
// of its XLA decoder (frtm_tpu/models/seg_network.py::pyr_up_bicubic); the
// forward it differentiates is the one that
// frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas computes.
//
// The function. The forward reads padded row p = (R >> 1) + k, k = 0..3,
// for output row Y = R - 1, with the even taps e where R is even and the
// odd taps o where R is odd; padded row p is source row clamp(p - 2, 0,
// n - 1). So, per axis, the gradient of source index h is the sum over p
// folding onto h (p = h + 2; p = 0, 1 too where h = 0; p = n + 2, n + 3 too
// where h = n - 1), over k, of e[k] g[2 (p - k) - 1] + o[k] g[2 (p - k)],
// with g zero outside 0 .. 2n - 1. The p = h + 2 part is a stride-2 8-tap
// filter, a pyramid down, the same at every index:
//   gx[h] = sum_{i=0..7} f[i] g[2h - 3 + i],  f = (e3, o3, e2, o2, e1, o1, e0, o0),
// and the folded rows add three taps at the two ends:
//   h = 0:      (o0 + o1) g[0] + e0 g[1] + o0 g[2]
//   h = n - 1:  e3 g[2n - 3] + o3 g[2n - 2] + (e2 + e3) g[2n - 1]
// (g zero outside again; where n = 1 both apply). pyrup.py builds the three
// tables (PYRDOWN_TAPS, FOLD_FIRST, FOLD_LAST). The axes are separable.
//
// Bound: bytes. Per input element the function reads 4 output gradients and
// writes one value (20 bytes) and does 6 FMA per output gradient in the
// separable form here, far under the ridge of the f32 CUDA cores. At the
// training shapes, (16,32,120,214) and (16,16,240,428), this design runs at
// 75 % and 78 % of the byte bound on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, scripts/bench_torch_pyrup_bwd.py); the kernel it replaced
// ran at 33 % and 34 %.
//
// Design. No shared memory and no barriers: each thread works alone.
//  - A thread owns two adjacent input-gradient columns w, w + 1 (w even) and
//    walks a chunk of rows down one plane. Each gy row it reads at columns
//    2w - 4 .. 2w + 7, which holds both columns' taps (2w - 3 .. 2w + 6), as
//    three 16-byte loads; neighbouring threads read neighbouring 16 bytes,
//    so a warp's loads are contiguous and L1 serves the overlap. It forms
//    the two columns' horizontal 8-tap sums at once and keeps the last 8
//    rows' sums in a register ring (16 registers). Row h of the chunk needs
//    gy rows 2h - 3 .. 2h + 4, so every two new gy rows complete one output
//    row: 8 vertical taps per column, one 8-byte store of the pair. The
//    ring's slots are fixed at compile time by unrolling the walk 4 rows at
//    a time; a chunk starts with 3 steps that only fill the ring.
//  - Loads in flight: once a step has summed its two gy rows, it loads the
//    next step's two (96 bytes a row) before its vertical sums and store, so
//    each thread keeps two rows' loads in flight instead of one scalar, and
//    80 registers let an SM hold 24 warps. Two steps ahead took 102
//    registers, 16 warps, and ran 16-17 % slower at the training shapes
//    (scripts/bench_torch_pyrup_bwd.py --variants).
//  - Edges: a gy row or a 16-byte piece of one outside the plane is not
//    loaded and reads zero, so the 8-tap form holds at every index. A thread
//    that holds column 0 or W - 1 adds the fold taps into its own copy of
//    the horizontal taps once, so no row pays for a border; the first and
//    last row add theirs under a branch taken in 2 of H rows. Addresses are
//    linear in the row (a predicate keeps a load outside the plane from
//    being made), so each load is a base and a constant offset.
//  - Load width: 16-byte loads need 16-byte aligned rows, that is W even
//    and a 16-byte aligned pointer (the training shapes: rows of 1712 and
//    3424 bytes). Elsewhere the same walk reads 8-byte pieces (any W, an
//    8-byte aligned pointer) or single floats; the wrapper picks the width
//    and counts it as the launch's variant (v4, v2, v1).
//  - Work split. Threads are numbered column pair fastest, then by chunk of
//    rows, then by plane, so a warp's loads and stores are contiguous runs.
//    The chunk length is picked per launch: the longest of kMaxRows, ...,
//    1 rows that still gives a full wave of threads for the card. A chunk of
//    8 rows reads 22 gy rows for 16 (the 6 halo rows mostly from L2); 16
//    or 32 rows were 4-10 % slower at the training shapes.
//  - Sums in a fixed order, no atomics: a re-run gives the same bits.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 8;   // input-gradient rows in a chunk, at most
constexpr int kAhead = 1;     // steps whose gy rows are loaded ahead of use
constexpr int kMaxDevices = 64;
static_assert(4 % kAhead == 0, "the walk is unrolled 4 steps at a time");

struct Taps {
  float f[8];      // the pyramid-down filter
  float first[3];  // onto index 0: g[0], g[1], g[2]
  float last[3];   // onto index n - 1: g[2n - 3], g[2n - 2], g[2n - 1]
};

struct Chunks {
  int pairs;  // column pairs across an input-gradient row
  int count;  // chunks of rows down a plane
  int rows;   // rows in a chunk
};

__device__ __forceinline__ float tap8(const float* f, const float* v) {
  float s = f[0] * v[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) s = fmaf(f[i], v[i], s);
  return s;
}

__device__ __forceinline__ float fold3(const float* t, float a, float b, float c, float s) {
  return fmaf(t[2], c, fmaf(t[1], b, fmaf(t[0], a, s)));
}

// A thread's 12 gy columns 2w - 4 .. 2w + 7 of a row, as 12 / kVec loads of
// kVec floats. 2w - 4 is a multiple of 4 and 2W of kVec, so every load lies
// wholly inside the row or wholly outside it, where it is not made and
// reads zero.
template <int kVec>
struct Span {
  static constexpr int kLoads = 12 / kVec;
  bool in[kLoads];  // load q lies in the row
  __device__ __forceinline__ Span(int w, int OW) {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int c = 2 * w - 4 + q * kVec;
      in[q] = c >= 0 && c < OW;
    }
  }
  // v = the row whose column 2w - 4 is at byte address a, or zero where the
  // row is outside the plane (!row)
  __device__ __forceinline__ void load(uintptr_t a, bool row, float* v) const {
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const bool ok = row && in[q];
      if constexpr (kVec == 4) {
        const float4 x = ok ? __ldg(reinterpret_cast<const float4*>(a) + q)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
      } else if constexpr (kVec == 2) {
        const float2 x = ok ? __ldg(reinterpret_cast<const float2*>(a) + q)
                            : make_float2(0.f, 0.f);
        v[2 * q] = x.x, v[2 * q + 1] = x.y;
      } else {
        v[q] = ok ? __ldg(reinterpret_cast<const float*>(a) + q) : 0.f;
      }
    }
  }
};

template <int kVec>
__global__ void __launch_bounds__(kThreads)
pyrup_bwd_kernel(const float* __restrict__ gy, float* __restrict__ gx, int planes, int H, int W,
                 Taps taps, Chunks ch) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int m = t % ch.pairs;
  const int rest = t / ch.pairs;
  const int chunk = rest % ch.count;
  const int plane = rest / ch.count;
  if (plane >= planes) return;
  const int w = 2 * m, OH = 2 * H, OW = 2 * W;
  const int h0 = chunk * ch.rows, h1 = min(h0 + ch.rows, H);
  // The horizontal taps of columns w and w + 1 over v[1 ..] and v[3 ..]
  // (v: columns 2w - 4 .. 2w + 7), the folds of column 0 and W - 1 added in,
  // so that no row pays for a border.
  float ca[8], cb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ca[i] = cb[i] = taps.f[i];
  if (w == 0) {  // g[0], g[1], g[2] = v[4], v[5], v[6]
#pragma unroll
    for (int i = 0; i < 3; ++i) ca[3 + i] += taps.first[i];
  }
  if (w == W - 1) {  // W odd: g[2W - 3 ..] = v[3 ..]
#pragma unroll
    for (int i = 0; i < 3; ++i) ca[2 + i] += taps.last[i];
  }
  if (w + 1 == W - 1) {  // W even: g[2W - 3 ..] = v[5 ..]
#pragma unroll
    for (int i = 0; i < 3; ++i) cb[2 + i] += taps.last[i];
  }
  const Span<kVec> span(w, OW);
  float* out = gx + static_cast<size_t>(plane) * H * W + w;
  // step u brings gy rows y0 + 2u and y0 + 2u + 1 into ring slots 2u, 2u + 1
  // (mod 8); from step 3 on it completes row h = h0 + u - 3, whose rows
  // 2h - 3 .. 2h + 4 then sit in slots 2u + 2 .. 2u + 9 (mod 8)
  const int y0 = 2 * h0 - 3;
  // byte address of row y0, column 2w - 4 (either may lie outside the plane;
  // only loads inside it are made), and of one row
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(gy) +
                       4 * (static_cast<long long>(plane) * OH * OW +
                            static_cast<long long>(y0) * OW + 2 * w - 4);
  const uintptr_t pitch = 4 * static_cast<uintptr_t>(OW);
  auto load_step = [&](int u, float(&v)[2][12]) {
    const int y = y0 + 2 * u;
    span.load(a0 + 2 * u * pitch, y >= 0 && y < OH, v[0]);
    span.load(a0 + (2 * u + 1) * pitch, y + 1 >= 0 && y + 1 < OH, v[1]);
  };

  float raw[kAhead][2][12];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) load_step(s, raw[s]);
  float2 ring[8];
  for (int u0 = 0;; u0 += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = u0 + i;
      const int h = h0 + u - 3;
      if (h >= h1) return;
      float(&cur)[2][12] = raw[i % kAhead];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        ring[(2 * i + r) & 7] = make_float2(tap8(ca, cur[r] + 1), tap8(cb, cur[r] + 3));
      if (h + kAhead < h1) load_step(u + kAhead, cur);
      if (h < h0) continue;
      float va[8], vb[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        va[k] = ring[(2 * i + 2 + k) & 7].x;
        vb[k] = ring[(2 * i + 2 + k) & 7].y;
      }
      float2 o = make_float2(tap8(taps.f, va), tap8(taps.f, vb));
      if (h == 0 || h == H - 1) {
        if (h == 0) {  // gy rows 0, 1, 2: k = 3, 4, 5
          o.x = fold3(taps.first, va[3], va[4], va[5], o.x);
          o.y = fold3(taps.first, vb[3], vb[4], vb[5], o.y);
        }
        if (h == H - 1) {  // gy rows 2H - 3 .. 2H - 1: k = 2, 3, 4
          o.x = fold3(taps.last, va[2], va[3], va[4], o.x);
          o.y = fold3(taps.last, vb[2], vb[3], vb[4], o.y);
        }
      }
      float* dst = out + static_cast<size_t>(h) * W;
      if ((W & 1) == 0) {
        *reinterpret_cast<float2*>(dst) = o;
      } else {
        dst[0] = o.x;
        if (w + 1 < W) dst[1] = o.y;
      }
    }
  }
}

template <int kVec>
int launch(const float* gy, float* gx, int planes, int H, int W, const Taps& taps, int device,
           cudaStream_t stream) {
  auto kernel = pyrup_bwd_kernel<kVec>;
  // threads the card holds at once, per device, for this variant
  static int resident[kMaxDevices];
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess)
      return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm * kThreads;
  }
  Chunks ch;
  ch.pairs = (W + 1) / 2;
  long long threads = 0;
  for (ch.rows = kMaxRows;; ch.rows /= 2) {
    ch.count = (H + ch.rows - 1) / ch.rows;
    threads = static_cast<long long>(planes) * ch.count * ch.pairs;
    if (ch.rows == 1 || threads >= resident[device]) break;
  }
  if (threads >= (1LL << 31) - kThreads) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(gy, gx, planes, H, W, taps, ch);
  return cudaGetLastError();
}

}  // namespace

// gy: (planes, 2H, 2W), gx: (planes, H, W), float32, contiguous. f, first,
// last: the tables of pyrup.py (8, 3, 3 floats). vec: floats per load, 4
// (gy 16-byte aligned, W even), 2 (gy 8-byte aligned) or 1; gx must be
// 8-byte aligned where W is even.
FRTM_EXPORT int frtm_pyrup_bwd_f32(const float* gy, float* gx, int planes, int H, int W,
                                   const float* f, const float* first, const float* last, int vec,
                                   int device, cudaStream_t stream) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (planes <= 0 || H <= 0 || W <= 0 || (vec != 4 && vec != 2 && vec != 1))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(gy) % (4 * vec) != 0 || (vec == 4 && W % 2 != 0) ||
      (W % 2 == 0 && reinterpret_cast<size_t>(gx) % 8 != 0) ||
      reinterpret_cast<size_t>(gx) % 4 != 0)
    return cudaErrorMisalignedAddress;
  Taps taps;
  for (int i = 0; i < 8; ++i) taps.f[i] = f[i];
  for (int i = 0; i < 3; ++i) {
    taps.first[i] = first[i];
    taps.last[i] = last[i];
  }
  if (vec == 4) return launch<4>(gy, gx, planes, H, W, taps, device, stream);
  if (vec == 2) return launch<2>(gy, gx, planes, H, W, taps, device, stream);
  return launch<1>(gy, gx, planes, H, W, taps, device, stream);
}
