// Kernel 3: affine image warp with cv2.warpAffine semantics — nearest /
// bilinear / bicubic (Keys A=-0.75) taps, constant-zero border. Replaces
// frtm_tpu/ops/pallas/warp.py::warp_affine_pallas (with its _affine_coefs).
//
// The caller passes the nine entries of the INVERSE 3x3 map (the forward
// matrix is inverted on the host, as cv2 does). An output pixel (x, y) maps
// to the source coordinate (h0 x + h1 y + h2) / (h6 x + h7 y + h8),
// (h3 x + h4 y + h5) / (...) and takes 1, 4 or 16 taps per channel; a tap
// outside the source contributes zero. Every float operation is
// round-to-nearest and in the order of frtm_tpu/ops/warp.py::_resample and
// the port's plain version (no FMA contraction), so on the card the two agree
// bit for bit, nearest-mode rounding included.
//
// Bound: by bytes, 2.44 us at the main path's 3x480x854 bicubic warp
// (source pixels the taps read, plus the output, over 3.35 TB/s), but what
// limits it on the card is issue and shared-memory bandwidth: per output
// and channel 16 tap loads and 40 float operations that must stay unfused,
// plus ~70 operations of coordinates and weights per output pixel. The TPU
// kernel's one-hot selection-matrix products (99.6% multiplications by zero)
// worked around the TPU's lack of a vector gather; a GPU gathers directly.
//
// Two variants; ops/kernels/warp_affine.py::plan_warp picks one per call.
//
// STAGED (affine maps, the augmenter's every warp). A block owns a 16x32
// output tile: 8 warps of 2 outputs each for small outputs (a paste box:
// more blocks in flight), 4 warps of 4 for large ones (a full frame: fewer
// copies and setups per output). A warp's 32 lanes take an 8x4 output
// patch, and the box rows have a pitch of 8 mod 32 words, so that the
// lanes' taps fall on distinct banks whether the map rotates or not (where
// the wider pitch would not fit, it is the box's width). The tile's source
// box follows from its corners: each computed coordinate is monotonic in x and
// in y (a rounded product, then rounded sums), so its extremes over the tile
// lie at the corners the signs of its coefficients pick, and floor - 1 ..
// floor + 2 of those (floor(x + 0.5) for nearest) covers every tap. The
// block copies that box, all channels as one cp.async group, into shared
// memory: 8-byte copies of column pairs where the rows allow (W even), else
// 4-byte; the copy's zero-fill outside the image is the constant-zero
// border, so taps read shared memory with no compare and no select. (Staging
// one channel ahead in a double buffer, or per-channel groups, or blocks
// that walk over tiles prefetching the next box, all measured slower: every
// copied channel's address math and barrier is issue the warp lacks.) The
// inverse of an affine map has the bottom row (0, 0, 1) exactly (the host's
// LU never pivots row 2 and its multipliers are exact zeros), so the
// homogeneous divide is by 1.0 and is dropped: x / 1.0f == x. A pixel's
// coordinates, box offset and tap weights are computed once, while the copy
// flies. The fraction f lies in [0, 1], so bicubic tap k always takes the
// same piece of the Keys weight (at the joins both pieces give exactly 0),
// and the weights are branch-free. The channels are sampled one after
// another with those offsets and weights (sampling 3 or 4 channels together
// measured slower). Tiles whose box misses the image are written
// as zeros without staging. The host bounds every tile's box from the map's
// coefficients (ops/kernels/warp_affine.py::plan_warp) and takes DIRECT when
// the box's channels exceed 96 KB; a tile whose box exceeds the plan stops
// the launch with an error.
//
// DIRECT (projective maps, footprints over the shared-memory budget). One
// thread per output pixel in 32x8 blocks gathers its taps from global memory
// through the read-only cache, each behind a bound test.
#include "common.cuh"

namespace {

struct Inverse {
  float h[9];
};

// The Keys weight's two pieces (a = -0.75: (a+2) = 1.25, (a+3) = 2.25,
// 5a = -3.75, 8a = -6, 4a = -3), x = |t|; x^3 = (x*x)*x as in the plain version.
__device__ __forceinline__ float cubic_near(float x) {  // |t| < 1
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  return __fadd_rn(__fsub_rn(__fmul_rn(1.25f, x3), __fmul_rn(2.25f, x2)), 1.f);
}

__device__ __forceinline__ float cubic_far(float x) {  // 1 <= |t| < 2
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  return __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.75f, x3), __fmul_rn(-3.75f, x2)),
                             __fmul_rn(-6.f, x)),
                   -3.f);
}

__device__ __forceinline__ float cubic_weight(float t) {
  const float x = fabsf(t);
  return x < 1.f ? cubic_near(x) : x < 2.f ? cubic_far(x) : 0.f;
}

// The four bicubic weights at fraction f in [0, 1], taps -1 .. 2: |(k-1) - f|
// rounds to 1 + f, f, 1 - f and 2 - f, which lie in [1, 2], [0, 1], [0, 1]
// and [1, 2]; at 1 (and 2) the near (far) piece is exactly 0, as is the
// weight, so each tap's piece is fixed.
__device__ __forceinline__ void cubic_weights(float f, float w[4]) {
  w[0] = cubic_far(__fadd_rn(1.f, f));
  w[1] = cubic_near(f);
  w[2] = cubic_near(__fsub_rn(1.f, f));
  w[3] = cubic_far(__fsub_rn(2.f, f));
}

// The affine part of the map: (h0 x + h1 y) + h2, (h3 x + h4 y) + h5.
__device__ __forceinline__ void affine_map(const Inverse& m, float x, float y, float& xs,
                                           float& ys) {
  xs = __fadd_rn(__fadd_rn(__fmul_rn(m.h[0], x), __fmul_rn(m.h[1], y)), m.h[2]);
  ys = __fadd_rn(__fadd_rn(__fmul_rn(m.h[3], x), __fmul_rn(m.h[4], y)), m.h[5]);
}

// The first tap of a coordinate, as a float: floor(v + 0.5) for nearest,
// floor(v) otherwise; the taps are base + Taps::lo .. base + Taps::lo + Taps::n - 1.
template <int MODE>
__device__ __forceinline__ float tap_base(float v) {
  return MODE == 0 ? floorf(__fadd_rn(v, 0.5f)) : floorf(v);
}
template <int MODE>
struct Taps {
  static constexpr int lo = MODE == 2 ? -1 : 0;
  static constexpr int n = MODE == 0 ? 1 : MODE == 1 ? 2 : 4;
};

__device__ __forceinline__ float tap(const float* __restrict__ p, int ix, int iy,
                                     int H, int W) {
  return (ix >= 0 && ix < W && iy >= 0 && iy < H)
             ? __ldg(p + static_cast<size_t>(iy) * W + ix)
             : 0.f;
}

// Float -> int for tap indices, clamped far outside the image first so that
// ix + 2 cannot overflow (the clamp changes no tap: all are out of range).
__device__ __forceinline__ int to_index(float v, int n) {
  return static_cast<int>(fminf(fmaxf(v, -8.f), static_cast<float>(n) + 8.f));
}

// ---------------------------------------------------------------------------
// DIRECT: one output pixel, every channel, taps from global memory.

template <int MODE>
__device__ __forceinline__ void warp_pixel_direct(const float* __restrict__ src,
                                                  float* __restrict__ out, int C, int H,
                                                  int W, int OH, int OW, const Inverse& m,
                                                  int ox, int oy) {
  const float xo = static_cast<float>(ox);
  const float yo = static_cast<float>(oy);
  const float* h = m.h;
  float xn, yn;
  affine_map(m, xo, yo, xn, yn);
  const float wn = __fadd_rn(__fadd_rn(__fmul_rn(h[6], xo), __fmul_rn(h[7], yo)), h[8]);
  const float xs = __fdiv_rn(xn, wn);
  const float ys = __fdiv_rn(yn, wn);

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t oplane = static_cast<size_t>(OH) * OW;
  float* o = out + static_cast<size_t>(oy) * OW + ox;

  if (MODE == 0) {
    const int ix = to_index(tap_base<0>(xs), W);
    const int iy = to_index(tap_base<0>(ys), H);
    for (int c = 0; c < C; ++c) o[c * oplane] = tap(src + c * plane, ix, iy, H, W);
    return;
  }

  const float x0 = floorf(xs);
  const float y0 = floorf(ys);
  const float fx = __fsub_rn(xs, x0);
  const float fy = __fsub_rn(ys, y0);
  const int ix0 = to_index(x0, W);
  const int iy0 = to_index(y0, H);

  if (MODE == 1) {
    const float gx = __fsub_rn(1.f, fx);
    const float gy = __fsub_rn(1.f, fy);
    const float w00 = __fmul_rn(gx, gy), w10 = __fmul_rn(fx, gy);
    const float w01 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
    for (int c = 0; c < C; ++c) {
      const float* p = src + c * plane;
      float acc = __fmul_rn(w00, tap(p, ix0, iy0, H, W));
      acc = __fadd_rn(acc, __fmul_rn(w10, tap(p, ix0 + 1, iy0, H, W)));
      acc = __fadd_rn(acc, __fmul_rn(w01, tap(p, ix0, iy0 + 1, H, W)));
      acc = __fadd_rn(acc, __fmul_rn(w11, tap(p, ix0 + 1, iy0 + 1, H, W)));
      o[c * oplane] = acc;
    }
    return;
  }

  float wx[4], wy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wx[k] = cubic_weight(__fsub_rn(static_cast<float>(k - 1), fx));
    wy[k] = cubic_weight(__fsub_rn(static_cast<float>(k - 1), fy));
  }
  for (int c = 0; c < C; ++c) {
    const float* p = src + c * plane;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      float row = 0.f;
#pragma unroll
      for (int dx = 0; dx < 4; ++dx)
        row = __fadd_rn(row, __fmul_rn(wx[dx], tap(p, ix0 + dx - 1, iy0 + dy - 1, H, W)));
      acc = __fadd_rn(acc, __fmul_rn(wy[dy], row));
    }
    o[c * oplane] = acc;
  }
}

constexpr int kDirectX = 32;
constexpr int kDirectY = 8;

template <int MODE>
__global__ void __launch_bounds__(kDirectX * kDirectY)
warp_direct_kernel(const float* __restrict__ src, float* __restrict__ out, int C, int H,
                   int W, int OH, int OW, Inverse m) {
  const int ox = blockIdx.x * kDirectX + threadIdx.x;
  const int oy = blockIdx.y * kDirectY + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  warp_pixel_direct<MODE>(src, out, C, H, W, OH, OW, m, ox, oy);
}

// ---------------------------------------------------------------------------
// STAGED: affine maps, source boxes in shared memory.

constexpr int kTileX = 32;                        // four 8x4 output patches across
constexpr int kTileY = 16;                        // and four down
constexpr int kStagedSmemBytes = 96 * 1024;       // the staged channels of a block

// Copies of the C channels of the box (rows by .. by+bh-1, columns bx ..
// bx+bw-1 of the source) into shared memory, channel after channel (SW * SH
// floats each, row pitch SW), as one cp.async group; the copy zero-fills
// outside the image. With kPairs (W even, bx and bw even) one 8-byte copy moves two
// columns, which lie both inside or both outside the image. A thread's units
// are e = threadIdx.x + k * blockDim.x in row-major order of the box; the
// row e / units-per-row is taken in float, exact for the box sizes a block
// can hold (e < 2^15: the error stays under 2^-8 / d of a gap >= 0.5 / d).
template <bool kPairs, int kThreads>
__device__ __forceinline__ void stage_channels(float* stage, const float* __restrict__ src,
                                               size_t plane, int C, int bx, int by, int bw,
                                               int bh, int H, int W, int SW, int SH) {
  constexpr int kUnit = kPairs ? 2 : 1;
  const int per_row = bw / kUnit;
  const float inv = __frcp_rn(static_cast<float>(per_row));
  for (int e = threadIdx.x; e < per_row * bh; e += kThreads) {
    const int r = static_cast<int>(__fmul_rn(static_cast<float>(e) + 0.5f, inv));
    const int col = kUnit * (e - r * per_row);
    const int gy = by + r, gx = bx + col;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* p = src + (in ? static_cast<size_t>(gy) * W + gx : 0);
    float* d = stage + r * SW + col;
    for (int c = 0; c < C; ++c, p += plane, d += SW * SH) {
      if (kPairs)
        cp_async8(d, p, in ? 8 : 0);
      else
        cp_async4(d, p, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// One output from the staged box: s points at its first tap, w holds its
// weights (bilinear: w00, w10, w01, w11; bicubic: wx[4], wy[4]).
template <int MODE>
__device__ __forceinline__ float sample_staged(const float* s, int SW, const float* w) {
  if (MODE == 0) return s[0];
  if (MODE == 1) {
    float acc = __fmul_rn(w[0], s[0]);
    acc = __fadd_rn(acc, __fmul_rn(w[1], s[1]));
    acc = __fadd_rn(acc, __fmul_rn(w[2], s[SW]));
    return __fadd_rn(acc, __fmul_rn(w[3], s[SW + 1]));
  }
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < 4; ++dy) {
    float row = 0.f;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) row = __fadd_rn(row, __fmul_rn(w[dx], s[dy * SW + dx]));
    acc = __fadd_rn(acc, __fmul_rn(w[4 + dy], row));
  }
  return acc;
}

// The tile's source box, lo and hi per axis, in float: each coordinate is
// monotonic in x and in y, with the signs of its two coefficients, so its
// least and greatest values over the tile are at known corners.
template <int MODE>
__device__ __forceinline__ void tile_box(const Inverse& m, float xa, float xb, float ya,
                                         float yb, float& xlo, float& xhi, float& ylo,
                                         float& yhi) {
  constexpr int lo = Taps<MODE>::lo, span = Taps<MODE>::n - 1;
  const float* h = m.h;
  const bool x0 = h[0] >= 0.f, x1 = h[1] >= 0.f, y0 = h[3] >= 0.f, y1 = h[4] >= 0.f;
  float xs, ys;
  affine_map(m, x0 ? xa : xb, x1 ? ya : yb, xs, ys);
  xlo = tap_base<MODE>(xs) + lo;
  affine_map(m, x0 ? xb : xa, x1 ? yb : ya, xs, ys);
  xhi = tap_base<MODE>(xs) + (lo + span);
  affine_map(m, y0 ? xa : xb, y1 ? ya : yb, xs, ys);
  ylo = tap_base<MODE>(ys) + lo;
  affine_map(m, y0 ? xb : xa, y1 ? yb : ya, xs, ys);
  yhi = tap_base<MODE>(ys) + (lo + span);
}

// SW x SH: the box a block stages per channel. kWarps warps share the
// tile's 16 output patches of 8x4 (8 warps for small outputs, 4, with more
// patches each, for large ones); the bound of 24 warps per SM leaves up to
// 85 registers a thread.
template <int MODE, int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 24 / kWarps)
warp_staged_kernel(const float* __restrict__ src, float* __restrict__ out, int C, int H,
                   int W, int OH, int OW, Inverse m, int SW, int SH, bool pairs) {
  extern __shared__ __align__(16) float stage[];
  constexpr int lo = Taps<MODE>::lo;
  constexpr int kPerThread = kTileX * kTileY / (32 * kWarps);
  const int tx0 = blockIdx.x * kTileX;
  const int ty0 = blockIdx.y * kTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t oplane = static_cast<size_t>(OH) * OW;
  // output i of this thread: lane (x, y) of the 8x4 patch warp + kWarps * i;
  // with a box row pitch of 8 mod 32 words a patch's taps spread over the
  // banks, rotated or not (a row of 32 outputs, or x-adjacent output pairs
  // with 8-byte stores, measured slower: scripts/bench_torch_warp_variants.py)
  int ox[kPerThread], oy[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int p = (threadIdx.x >> 5) + kWarps * i, lane = threadIdx.x & 31;
    ox[i] = tx0 + 8 * (p & 3) + (lane & 7);
    oy[i] = ty0 + 4 * (p >> 2) + (lane >> 3);
  }

  float xlo, xhi, ylo, yhi;
  tile_box<MODE>(m, static_cast<float>(tx0), static_cast<float>(min(tx0 + kTileX, OW) - 1),
                 static_cast<float>(ty0), static_cast<float>(min(ty0 + kTileY, OH) - 1),
                 xlo, xhi, ylo, yhi);
  if (!(xhi >= 0.f && xlo <= W - 1 && yhi >= 0.f && ylo <= H - 1)) {
    // every tap of the tile lies outside the source: border zeros
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (ox[i] < OW && oy[i] < OH)
        for (int c = 0; c < C; ++c)
          out[c * oplane + static_cast<size_t>(oy[i]) * OW + ox[i]] = 0.f;
    }
    return;
  }
  if (pairs) {   // whole column pairs: start on an even column, end on an odd one
    xlo = __fmul_rn(2.f, floorf(__fmul_rn(0.5f, xlo)));
    xhi = __fadd_rn(__fmul_rn(2.f, floorf(__fmul_rn(0.5f, xhi))), 1.f);
  }
  // the host's plan bounds every tile's box; a box over it means that bound
  // is wrong, and the launch stops with an error rather than stage part of it
  if (xhi - xlo + 1.f > SW || yhi - ylo + 1.f > SH) __trap();
  const int bx = static_cast<int>(xlo), by = static_cast<int>(ylo);
  const int bw = static_cast<int>(xhi - xlo) + 1, bh = static_cast<int>(yhi - ylo) + 1;
  if (pairs)
    stage_channels<true, 32 * kWarps>(stage, src, plane, C, bx, by, bw, bh, H, W, SW, SH);
  else
    stage_channels<false, 32 * kWarps>(stage, src, plane, C, bx, by, bw, bh, H, W, SW, SH);

  // while the copies fly: each output's first tap in the box and its
  // weights, for every channel
  constexpr int kW = MODE == 0 ? 1 : MODE == 1 ? 4 : 8;
  int off[kPerThread];
  bool valid[kPerThread];
  float w[kPerThread][kW];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    float xs, ys;
    affine_map(m, static_cast<float>(ox[i]), static_cast<float>(oy[i]), xs, ys);
    const float x0 = tap_base<MODE>(xs), y0 = tap_base<MODE>(ys);
    // outputs past the image's edge read the box's first word, unstored
    valid[i] = ox[i] < OW && oy[i] < OH;
    off[i] = valid[i] ? (static_cast<int>(y0) + lo - by) * SW + static_cast<int>(x0) + lo - bx
                      : 0;
    if (MODE == 0) {
      w[i][0] = 0.f;
    } else if (MODE == 1) {
      const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
      const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
      w[i][0] = __fmul_rn(gx, gy);
      w[i][1] = __fmul_rn(fx, gy);
      w[i][2] = __fmul_rn(gx, fy);
      w[i][3] = __fmul_rn(fx, fy);
    } else {
      cubic_weights(__fsub_rn(xs, x0), w[i]);
      cubic_weights(__fsub_rn(ys, y0), w[i] + 4);
    }
  }

  const int stage_floats = SW * SH;
  cp_async_wait<0>();  // this thread's copies have landed
  __syncthreads();     // ... and every thread's
  for (int c = 0; c < C; ++c) {
    const float* s = stage + c * stage_floats;
    float* o = out + c * oplane;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float v = sample_staged<MODE>(s + off[i], SW, w[i]);
      if (valid[i]) o[static_cast<size_t>(oy[i]) * OW + ox[i]] = v;
    }
  }
}

template <int MODE, int kWarps>
cudaError_t launch_staged(size_t smem, cudaStream_t stream, const float* src, float* out,
                          int C, int H, int W, int OH, int OW, const Inverse& m, int SW, int SH,
                          bool pairs) {
  auto kernel = warp_staged_kernel<MODE, kWarps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kStagedSmemBytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((OW + kTileX - 1) / kTileX, (OH + kTileY - 1) / kTileY);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(src, out, C, H, W, OH, OW, m, SW, SH, pairs);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_staged_mode(bool wide, size_t smem, cudaStream_t stream, const float* src,
                               float* out, int C, int H, int W, int OH, int OW,
                               const Inverse& m, int SW, int SH, bool pairs) {
  return wide ? launch_staged<MODE, 4>(smem, stream, src, out, C, H, W, OH, OW, m, SW, SH, pairs)
              : launch_staged<MODE, 8>(smem, stream, src, out, C, H, W, OH, OW, m, SW, SH, pairs);
}

}  // namespace

// src: (C, H, W) float32, out: (C, OH, OW) float32, both contiguous;
// hinv: the inverse map's nine entries, row-major; mode 0/1/2.
FRTM_EXPORT int frtm_warp_affine_f32(const float* src, float* out, int C,
                                     int H, int W, int OH, int OW,
                                     const float* hinv, int mode, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Inverse m;
  for (int k = 0; k < 9; ++k) m.h[k] = hinv[k];
  dim3 block(kDirectX, kDirectY);
  dim3 grid((OW + kDirectX - 1) / kDirectX, (OH + kDirectY - 1) / kDirectY);
  if (mode == 0)
    warp_direct_kernel<0><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else if (mode == 1)
    warp_direct_kernel<1><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else if (mode == 2)
    warp_direct_kernel<2><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The staged variant: as above, for an affine inverse (bottom row exactly
// 0, 0, 1) whose 16x32-tile source boxes are at most box_h x (box_w - 2)
// (box_w even, with two columns for pair alignment; box_w is the row pitch)
// and whose C channels of that box fit in 96 KB. Refuses
// (cudaErrorInvalidValue) anything else.
FRTM_EXPORT int frtm_warp_affine_staged_f32(const float* src, float* out, int C, int H,
                                            int W, int OH, int OW, const float* hinv,
                                            int mode, int box_w, int box_h, int device,
                                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Inverse m;
  for (int k = 0; k < 9; ++k) m.h[k] = hinv[k];
  const size_t smem = sizeof(float) * static_cast<size_t>(C) * box_w * box_h;
  if (m.h[6] != 0.f || m.h[7] != 0.f || m.h[8] != 1.f || box_w < 2 || box_w % 2 ||
      box_h < 1 || C < 1 || smem > kStagedSmemBytes ||
      static_cast<long long>(H) * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  const long long tiles_y = (OH + kTileY - 1) / kTileY;
  const long long tiles = tiles_y * ((OW + kTileX - 1) / kTileX);
  int sms;
  if (tiles_y > 65535) return cudaErrorInvalidValue;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  // many tiles (a full frame): 4 warps of 4 patches; few (a paste box): 8 of 2
  const bool wide = tiles >= 4LL * sms;
  const bool pairs = W % 2 == 0 && reinterpret_cast<size_t>(src) % 8 == 0;
  if (mode == 0)
    return launch_staged_mode<0>(wide, smem, stream, src, out, C, H, W, OH, OW, m, box_w,
                                 box_h, pairs);
  if (mode == 1)
    return launch_staged_mode<1>(wide, smem, stream, src, out, C, H, W, OH, OW, m, box_w,
                                 box_h, pairs);
  if (mode == 2)
    return launch_staged_mode<2>(wide, smem, stream, src, out, C, H, W, OH, OW, m, box_w,
                                 box_h, pairs);
  return cudaErrorInvalidValue;
}
