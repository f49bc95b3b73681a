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
// Bound: bytes. In float32 the function moves 5 bytes per output (4 written,
// 1 read) and does 35 flops for it (~7 flop/byte), below the ~20 flop/byte
// ridge of the f32 CUDA cores; four fifths of the bytes are the output's
// stores. In bfloat16 it moves 2.5 bytes per output for the same flops
// (~14 flop/byte): still under the ridge, at half the bytes.
//
// Design. A thread computes a 2-row x 4-column output patch: output rows 2p
// and 2p+1 (odd and even row taps) both read padded rows p .. p+4, and the 4
// columns 4q .. 4q+3 read padded columns 2q .. 2q+5. So per output row 6
// row-filtered values feed the 4 outputs (each output takes the same value
// the one-output form would compute, in the same order), and each row goes
// out as one 16-byte store (two 8-byte stores when 2W is not a multiple of 4,
// where rows are only 8-byte aligned). A block owns 64 x 128 output tiles
// (8 warps; a warp is one row pair of 32 patches, four row pairs per thread)
// and walks over them, tile after tile and plane after plane, with as many
// blocks as the SMs hold at once. The next tile's 36 x 68 input halo is
// copied into a second shared buffer with cp.async while the current tile is
// computed and stored. The replicate padding is a clamp in the copy's source
// index. Input rows are only 4-byte aligned in general (214 floats at the
// main path's first stage), which also rules out TMA, whose global strides
// must be multiples of 16 bytes; the input is a fifth of the bytes, so 4-byte
// copies do. Stores keep the default cache policy: the decoder reads the
// output next, and it fits in the 50 MB L2.
//
// The kernel is a template on the element type. The bfloat16 instance
// (frtm_pyrup_bf16) keeps the tiles, the patches and the double buffer; the
// halo sits in shared memory as bfloat16, is read as pairs and converted to
// float in registers, the sums are the float32 kernel's in the same order,
// and each output is rounded once, at the store. What shifts with 2-byte
// elements: cp.async moves at least 4 bytes, so the halo is copied as column
// pairs where W is even (a pair that the replicate padding clamps is not
// contiguous in the source and is written with two plain stores); where W is
// odd, rows are only 2-byte aligned and every element goes through a plain
// load and store. A row's 4 outputs are one 8-byte store where W is even
// (rows of 4W bytes are then 8-byte aligned) and two 4-byte stores where it
// is odd.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPatchCols = 32;                            // 4-column patches across a tile
constexpr int kRowPairs = 32;                             // output row pairs down a tile
constexpr int kInX = 2 * kPatchCols + 4;                  // padded input columns incl. halo
constexpr int kInY = kRowPairs + 4;                       // padded input rows incl. halo
constexpr int kWarps = kThreads / 32;

struct Taps {
  float even[4];
  float odd[4];
};

struct Tiles {
  int x, y, per_plane, total;  // tiles across, down, per plane, in all
};

struct TileOrigin {
  int plane, pair0, patch0;  // plane, first output row pair, first patch
};

__device__ __forceinline__ TileOrigin origin(int tile, const Tiles& t) {
  const int plane = tile / t.per_plane;
  const int rem = tile - plane * t.per_plane;
  const int ty = rem / t.x;
  return {plane, ty * kRowPairs, (rem - ty * t.x) * kPatchCols};
}

// Padded rows pair0 .. pair0 + kInY - 1 and columns 2 * patch0 .. + kInX - 1
// of one plane into buf (padded index i is source index i - 2, clamped).
template <bool kEvenW>
__device__ __forceinline__ void load_halo(float* buf, const float* x, const TileOrigin& o,
                                          int H, int W) {
  const float* xp = x + static_cast<size_t>(o.plane) * H * W;
  const int r0 = o.pair0 - 2;
  const int c0 = 2 * o.patch0 - 2;
  for (int e = threadIdx.x; e < kInY * kInX; e += kThreads) {
    const int i = e / kInX;
    const int j = e - i * kInX;
    const int sy = min(max(r0 + i, 0), H - 1);
    const int sx = min(max(c0 + j, 0), W - 1);
    cp_async4(buf + e, xp + static_cast<size_t>(sy) * W + sx);
  }
}

// The same in bfloat16. With kEvenW the first padded column's source index
// (2 * patch0 - 2) and W are even, so a column pair lies inside the row, 4-byte
// aligned, or outside it, where both values are the clamped edge value.
template <bool kEvenW>
__device__ __forceinline__ void load_halo(__nv_bfloat16* buf, const __nv_bfloat16* x,
                                          const TileOrigin& o, int H, int W) {
  const __nv_bfloat16* xp = x + static_cast<size_t>(o.plane) * H * W;
  const int r0 = o.pair0 - 2;
  const int c0 = 2 * o.patch0 - 2;
  if (kEvenW) {
    constexpr int kPairsX = kInX / 2;
    for (int e = threadIdx.x; e < kInY * kPairsX; e += kThreads) {
      const int i = e / kPairsX;
      const int j = 2 * (e - i * kPairsX);
      const int sy = min(max(r0 + i, 0), H - 1);
      const __nv_bfloat16* row = xp + static_cast<size_t>(sy) * W;
      __nv_bfloat16* dst = buf + i * kInX + j;
      const int sx = c0 + j;
      if (sx >= 0 && sx + 1 < W) {
        cp_async4(dst, row + sx);
      } else {
        dst[0] = row[min(max(sx, 0), W - 1)];
        dst[1] = row[min(max(sx + 1, 0), W - 1)];
      }
    }
  } else {
    for (int e = threadIdx.x; e < kInY * kInX; e += kThreads) {
      const int i = e / kInX;
      const int j = e - i * kInX;
      const int sy = min(max(r0 + i, 0), H - 1);
      const int sx = min(max(c0 + j, 0), W - 1);
      buf[e] = xp[static_cast<size_t>(sy) * W + sx];
    }
  }
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float filt4(const float* w, float v0, float v1, float v2, float v3) {
  float s = __fmul_rn(w[0], v0);
  s = __fadd_rn(s, __fmul_rn(w[1], v1));
  s = __fadd_rn(s, __fmul_rn(w[2], v2));
  return __fadd_rn(s, __fmul_rn(w[3], v3));
}

// One output row's 4 outputs from its 6 row-filtered values v (padded
// columns 2q .. 2q+5): columns 4q+1 and 4q+3 have odd C, 4q+2 and 4q+4 even.
__device__ __forceinline__ float4 columns(const Taps& t, const float* v) {
  return make_float4(filt4(t.odd, v[0], v[1], v[2], v[3]), filt4(t.even, v[1], v[2], v[3], v[4]),
                     filt4(t.odd, v[1], v[2], v[3], v[4]), filt4(t.even, v[2], v[3], v[4], v[5]));
}

// One row's 4 outputs. kEvenW: one 16-byte (float) or 8-byte (bfloat16)
// store; else two stores of half that, the second only where the row has it.
template <bool kEvenW>
__device__ __forceinline__ void store_row(float* row, int col, int OW, float4 v) {
  if (kEvenW) {
    *reinterpret_cast<float4*>(row + col) = v;
  } else {
    *reinterpret_cast<float2*>(row + col) = make_float2(v.x, v.y);
    if (col + 2 < OW) *reinterpret_cast<float2*>(row + col + 2) = make_float2(v.z, v.w);
  }
}

template <bool kEvenW>
__device__ __forceinline__ void store_row(__nv_bfloat16* row, int col, int OW, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  if (kEvenW) {
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(row + col) = u;
  } else {
    *reinterpret_cast<__nv_bfloat162*>(row + col) = lo;
    if (col + 2 < OW) *reinterpret_cast<__nv_bfloat162*>(row + col + 2) = hi;
  }
}

template <typename T, bool kEvenW>
__device__ __forceinline__ void compute_tile(const T* buf, T* y, const TileOrigin& o,
                                             int H, int W, const Taps& taps) {
  const int lane = threadIdx.x & 31;
  const int q = o.patch0 + lane;
  const int OW = 2 * W;
  if (4 * q >= OW) return;
  T* yp = y + static_cast<size_t>(o.plane) * 2 * H * OW;
#pragma unroll
  for (int k = 0; k < kRowPairs / kWarps; ++k) {
    const int rp = (threadIdx.x >> 5) + k * kWarps;
    const int p = o.pair0 + rp;
    if (p >= H) break;
    const T* s = buf + rp * kInX + 2 * lane;
    float vo[6], ve[6];  // row-filtered: odd taps at rows 0..3, even taps at rows 1..4
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      float a[6];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float2 t = load_pair(s + r * kInX + 2 * j);
        a[2 * j] = t.x;
        a[2 * j + 1] = t.y;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (r < 4) vo[j] = r == 0 ? __fmul_rn(taps.odd[0], a[j])
                                  : __fadd_rn(vo[j], __fmul_rn(taps.odd[r], a[j]));
        if (r > 0) ve[j] = r == 1 ? __fmul_rn(taps.even[0], a[j])
                                  : __fadd_rn(ve[j], __fmul_rn(taps.even[r - 1], a[j]));
      }
    }
    T* row = yp + static_cast<size_t>(2 * p) * OW;
    store_row<kEvenW>(row, 4 * q, OW, columns(taps, vo));
    store_row<kEvenW>(row + OW, 4 * q, OW, columns(taps, ve));
  }
}

template <typename T, bool kEvenW>
__global__ void __launch_bounds__(kThreads)
pyrup_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, Taps taps,
             Tiles tiles) {
  __shared__ __align__(16) unsigned char raw[2 * kInY * kInX * sizeof(T)];
  T* const buf = reinterpret_cast<T*>(raw);   // two buffers of kInY * kInX
  constexpr int kBuf = kInY * kInX;
  int tile = blockIdx.x;
  load_halo<kEvenW>(buf, x, origin(tile, tiles), H, W);
  cp_async_commit();
  for (int cur = 0; tile < tiles.total; tile += gridDim.x, cur ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles.total)
      load_halo<kEvenW>(buf + (cur ^ 1) * kBuf, x, origin(next, tiles), H, W);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute_tile<T, kEvenW>(buf + cur * kBuf, y, origin(tile, tiles), H, W, taps);
    __syncthreads();  // this buffer is refilled in the next iteration
  }
}

constexpr int kMaxDevices = 64;

// Blocks of `kernel` that the SMs of `device` hold at once, kept in *cached
// after the first call (one cache per kernel and device); 0 on error.
template <typename Kernel>
inline int resident_blocks(Kernel kernel, int threads, int device, int* cached) {
  if (*cached == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) !=
            cudaSuccess)
      return 0;
    *cached = sms * per_sm;
  }
  return *cached;
}

// Checks, tiling and launch for one element type; the entry points below
// are its two instances.
template <typename T>
int launch_pyrup(const T* x, T* y, int planes, int H, int W, const float* even, const float* odd,
                 int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (planes <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const bool even_w = W % 2 == 0;
  // the widest store is 16 bytes; the input is copied 4 bytes at a time
  // (bfloat16 pairs where W is even), else element by element
  if (reinterpret_cast<size_t>(y) % 16 != 0 ||
      reinterpret_cast<size_t>(x) % (even_w ? 4 : sizeof(T)) != 0)
    return cudaErrorMisalignedAddress;
  Taps taps;
  for (int k = 0; k < 4; ++k) {
    taps.even[k] = even[k];
    taps.odd[k] = odd[k];
  }
  Tiles t;
  t.x = ((2 * W + 3) / 4 + kPatchCols - 1) / kPatchCols;
  t.y = (H + kRowPairs - 1) / kRowPairs;
  t.per_plane = t.x * t.y;
  const long long total = static_cast<long long>(t.per_plane) * planes;
  if (total > (1LL << 30)) return cudaErrorInvalidValue;
  t.total = static_cast<int>(total);
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  static int resident_cache[2][kMaxDevices];  // one per instance of this template
  const int resident =
      even_w ? resident_blocks(pyrup_kernel<T, true>, kThreads, device, &resident_cache[1][device])
             : resident_blocks(pyrup_kernel<T, false>, kThreads, device,
                               &resident_cache[0][device]);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  const int grid = t.total < resident ? t.total : resident;
  if (even_w)
    pyrup_kernel<T, true><<<grid, kThreads, 0, stream>>>(x, y, H, W, taps, t);
  else
    pyrup_kernel<T, false><<<grid, kThreads, 0, stream>>>(x, y, H, W, taps, t);
  return cudaGetLastError();
}

}  // namespace

// x: (planes, H, W), y: (planes, 2H, 2W), both contiguous and of one type.
FRTM_EXPORT int frtm_pyrup_f32(const float* x, float* y, int planes, int H,
                               int W, const float* even, const float* odd,
                               int device, cudaStream_t stream) {
  return launch_pyrup<float>(x, y, planes, H, W, even, odd, device, stream);
}

FRTM_EXPORT int frtm_pyrup_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int planes, int H,
                                int W, const float* even, const float* odd,
                                int device, cudaStream_t stream) {
  return launch_pyrup<__nv_bfloat16>(x, y, planes, H, W, even, odd, device, stream);
}
