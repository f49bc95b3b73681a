// Kernel 1 in bfloat16: the decoder's 2x bicubic pyramid upsampler (the
// reference's PyrUpBicubic2d) on bfloat16 planes. Replaces
// frtm_tpu/ops/pallas/pyrup.py::pyr_up_bicubic_pallas, as pyrup.cu does in
// float32, with the same sums: rows of the replicate-padded input first,
// then columns, each a left-to-right sum of round-to-nearest multiplies and
// adds (no FMA) in float32, the result rounded to bfloat16 once, at the
// store. So it agrees bit for bit with the plain version
// (pyr_up_bicubic_plain on the upcast input, rounded once).
//
// Bound: bytes. Per output the function moves 2.5 bytes (2 written, 0.5
// read) and does 35 flops in the one-output form, ~14 flop/byte: under the
// f32 ridge of the CUDA cores (~20), but not by much, so every instruction
// beyond the sums' multiplies and adds costs time. Four fifths of the bytes
// are the stores.
//
// Design. No shared memory and no barriers: each thread works alone.
//  - A thread owns a column of 2-row x 8-column output patches: output
//    columns 8m .. 8m+7, which read padded columns 4m .. 4m+7 (source
//    4m-2 .. 4m+5), and walks down a chunk of row pairs. Row pair p reads
//    padded rows p .. p+4, so consecutive pairs share 4 of their 5 rows: the
//    thread keeps a ring of 5 converted rows (5 x 8 floats) in registers and
//    loads one new row per pair, a pair ahead of its use. The ring's slots
//    are fixed at compile time by unrolling the walk 5 pairs at a time.
//    Per pair: 2 x 8 row sums and 16 column sums (14 flops an output, the
//    one-output form's 35 shared out), 4 loads and 8 conversions.
//  - Loads. Where W is even and the input 4-byte aligned, a row's 8 values
//    are 4 four-byte words. The replicate padding costs nothing there: a
//    word left of the row is loaded from column 0, one right of it from
//    column W-2, and each word's byte permute, which turns a bfloat16 half
//    into a float anyway, takes the low or the high half by a selector the
//    thread works out once. Elsewhere (W odd, or an input view whose pointer
//    is only 2-byte aligned) each value is a 2-byte load from its clamped
//    column. Rows are clamped by index. Row pitches of 428 and 856 bytes
//    (the DAVIS decoder's W = 214 and 428) are not multiples of 16, which
//    rules out TMA; the input is a fifth of the bytes, and 4-byte loads of
//    it are a few instructions in 250.
//  - Stores. Each output row's 8 values leave as one 16-byte store where
//    the row allows it: every row where W % 4 == 0, the even rows where
//    W % 4 == 2 (odd rows there are 8-byte aligned: two 8-byte stores), and
//    4-byte stores where W is odd. A thread whose patch overhangs the row
//    stores only the part inside it.
//  - Work split. Threads are numbered patch-fastest across a row, then by
//    chunk of row pairs, then by plane, so a warp's loads and stores are
//    contiguous runs (at most two) whatever the width. The chunk length is
//    picked per launch: the longest of 8, 4, 2, 1 row pairs that still
//    gives a full wave of threads for the card, so N = 1 fills the card as
//    N = 16 does. Chunks of 8 load 12 rows for 8 pairs; 16-pair chunks load
//    fewer, yet measured slower at N = 16 (63 and 71 % of the byte bound
//    against 70 and 78 %, scripts/bench_torch_bf16_decoder.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kLo = 0x1044;  // byte permute: low bfloat16 of a word -> float bits
constexpr unsigned kHi = 0x3244;  // high bfloat16 -> float bits

struct Taps {
  float even[4];
  float odd[4];
};

struct Chunks {
  int patches;  // 8-column patches across an output row
  int count;    // chunks of row pairs down a plane
  int pairs;    // row pairs in a chunk
};

__device__ __forceinline__ float bf16_bits(unsigned lo16) { return __uint_as_float(lo16 << 16); }

// A thread's 8 input columns (source 4m-2 .. 4m+5), clamped to the row.
template <bool kWords>
struct Columns;

// Four aligned words; a word outside the row loads an edge word and
// duplicates its edge half.
template <>
struct Columns<true> {
  int off[4];
  unsigned lo[4], hi[4];
  __device__ __forceinline__ Columns(int m, int W) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * m - 2 + 2 * k;
      if (c < 0) {
        off[k] = 0, lo[k] = kLo, hi[k] = kLo;
      } else if (c >= W) {
        off[k] = W - 2, lo[k] = kHi, hi[k] = kHi;
      } else {
        off[k] = c, lo[k] = kLo, hi[k] = kHi;
      }
    }
  }
  struct Raw {
    unsigned w[4];
  };
  __device__ __forceinline__ Raw load(const __nv_bfloat16* row) const {
    Raw r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __ldg(reinterpret_cast<const unsigned*>(row + off[k]));
    return r;
  }
  __device__ __forceinline__ void convert(const Raw& r, float* v) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(__byte_perm(r.w[k], 0, lo[k]));
      v[2 * k + 1] = __uint_as_float(__byte_perm(r.w[k], 0, hi[k]));
    }
  }
};

// Eight 2-byte loads from clamped columns.
template <>
struct Columns<false> {
  int off[8];
  __device__ __forceinline__ Columns(int m, int W) {
#pragma unroll
    for (int j = 0; j < 8; ++j) off[j] = min(max(4 * m - 2 + j, 0), W - 1);
  }
  struct Raw {
    unsigned short h[8];
  };
  __device__ __forceinline__ Raw load(const __nv_bfloat16* row) const {
    Raw r;
    const unsigned short* u = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int j = 0; j < 8; ++j) r.h[j] = __ldg(u + off[j]);
    return r;
  }
  __device__ __forceinline__ void convert(const Raw& r, float* v) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = bf16_bits(r.h[j]);
  }
};

__device__ __forceinline__ float filt4(const float* w, float v0, float v1, float v2, float v3) {
  float s = __fmul_rn(w[0], v0);
  s = __fadd_rn(s, __fmul_rn(w[1], v1));
  s = __fadd_rn(s, __fmul_rn(w[2], v2));
  return __fadd_rn(s, __fmul_rn(w[3], v3));
}

__device__ __forceinline__ unsigned pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// One output row's 8 values from its 8 row sums v (padded columns 4m ..
// 4m+7): output 8m+k has C = 8m+k+1, so odd k take the even taps; it reads
// v[(k+1)/2 ..], packed in pairs.
__device__ __forceinline__ uint4 columns(const Taps& t, const float* v) {
  uint4 u;
  u.x = pack(filt4(t.odd, v[0], v[1], v[2], v[3]), filt4(t.even, v[1], v[2], v[3], v[4]));
  u.y = pack(filt4(t.odd, v[1], v[2], v[3], v[4]), filt4(t.even, v[2], v[3], v[4], v[5]));
  u.z = pack(filt4(t.odd, v[2], v[3], v[4], v[5]), filt4(t.even, v[3], v[4], v[5], v[6]));
  u.w = pack(filt4(t.odd, v[3], v[4], v[5], v[6]), filt4(t.even, v[4], v[5], v[6], v[7]));
  return u;
}

// Store one row's patch at `dst` (output column 8m), `valid` values of it
// inside the row. kStore: 16 (16-byte aligned rows), 8 (8-byte), 4.
template <int kStore>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst, uint4 u, int valid) {
  if (kStore == 16 && valid >= 8) {
    *reinterpret_cast<uint4*>(dst) = u;
  } else if (kStore >= 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(u.x, u.y);
    if (valid > 4) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(u.z, u.w);
  } else {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    d[0] = u.x;
    if (valid > 2) d[1] = u.y;
    if (valid > 4) d[2] = u.z;
    if (valid > 6) d[3] = u.w;
  }
}

// kEvenStore / kOddStore: the store width of even and odd output rows.
template <bool kWords, int kEvenStore, int kOddStore>
__global__ void __launch_bounds__(kThreads)
pyrup_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                  int planes, int H, int W, Taps taps, Chunks ch) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int m = t % ch.patches;
  const int rest = t / ch.patches;
  const int chunk = rest % ch.count;
  const int plane = rest / ch.count;
  if (plane >= planes) return;
  const int p0 = chunk * ch.pairs;
  const int p1 = min(p0 + ch.pairs, H);
  const int OW = 2 * W;
  const int valid = OW - 8 * m;
  const Columns<kWords> cols(m, W);
  const __nv_bfloat16* xp = x + static_cast<size_t>(plane) * H * W;
  __nv_bfloat16* yp = y + static_cast<size_t>(plane) * 2 * H * OW + 8 * m;

  // ring slot (i + r) % 5 holds padded row q + r of pair q = p + i
  float a[5][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    cols.convert(cols.load(xp + static_cast<size_t>(min(max(p0 - 2 + r, 0), H - 1)) * W), a[r]);
  auto raw = cols.load(xp + static_cast<size_t>(min(p0 + 2, H - 1)) * W);
  for (int p = p0; p < p1; p += 5) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int q = p + i;
      if (q >= p1) return;
      cols.convert(raw, a[(i + 4) % 5]);
      raw = cols.load(xp + static_cast<size_t>(min(q + 3, H - 1)) * W);  // pair q+1's new row
      float vo[8], ve[8];  // row sums: odd taps over rows q..q+3, even over q+1..q+4
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        vo[j] = filt4(taps.odd, a[i % 5][j], a[(i + 1) % 5][j], a[(i + 2) % 5][j],
                      a[(i + 3) % 5][j]);
        ve[j] = filt4(taps.even, a[(i + 1) % 5][j], a[(i + 2) % 5][j], a[(i + 3) % 5][j],
                      a[(i + 4) % 5][j]);
      }
      __nv_bfloat16* row = yp + static_cast<size_t>(2 * q) * OW;
      store_row<kEvenStore>(row, columns(taps, vo), valid);
      store_row<kOddStore>(row + OW, columns(taps, ve), valid);
    }
  }
}

constexpr int kMaxDevices = 64;

template <bool kWords, int kEvenStore, int kOddStore>
int launch(const __nv_bfloat16* x, __nv_bfloat16* y, int planes, int H, int W, const Taps& taps,
           int device, cudaStream_t stream) {
  auto kernel = pyrup_bf16_kernel<kWords, kEvenStore, kOddStore>;
  // threads the card holds at once, per device, for this instance
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
  ch.patches = (2 * W + 7) / 8;
  long long threads = 0;
  for (ch.pairs = 8;; ch.pairs /= 2) {
    ch.count = (H + ch.pairs - 1) / ch.pairs;
    threads = static_cast<long long>(planes) * ch.count * ch.patches;
    if (ch.pairs == 1 || threads >= resident[device]) break;
  }
  if (threads >= (1LL << 31) - kThreads) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, stream>>>(x, y, planes, H, W, taps, ch);
  return cudaGetLastError();
}

}  // namespace

// x: (planes, H, W), y: (planes, 2H, 2W), both contiguous bfloat16; x needs
// 2-byte alignment only, y 16-byte.
FRTM_EXPORT int frtm_pyrup_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int planes, int H,
                                int W, const float* even, const float* odd, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (planes <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (reinterpret_cast<size_t>(y) % 16 != 0 || reinterpret_cast<size_t>(x) % 2 != 0)
    return cudaErrorMisalignedAddress;
  Taps taps;
  for (int k = 0; k < 4; ++k) {
    taps.even[k] = even[k];
    taps.odd[k] = odd[k];
  }
  const bool words = W % 2 == 0 && reinterpret_cast<size_t>(x) % 4 == 0;
  if (W % 4 == 0)
    return words ? launch<true, 16, 16>(x, y, planes, H, W, taps, device, stream)
                 : launch<false, 16, 16>(x, y, planes, H, W, taps, device, stream);
  if (W % 2 == 0)
    return words ? launch<true, 16, 8>(x, y, planes, H, W, taps, device, stream)
                 : launch<false, 16, 8>(x, y, planes, H, W, taps, device, stream);
  return launch<false, 4, 4>(x, y, planes, H, W, taps, device, stream);
}
