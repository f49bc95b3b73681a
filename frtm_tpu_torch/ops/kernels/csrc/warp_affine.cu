// Kernel 3: affine image warp with cv2.warpAffine semantics — nearest /
// bilinear / bicubic (Keys A=-0.75) taps, constant-zero border. Replaces
// frtm_tpu/ops/pallas/warp.py::warp_affine_pallas (with its _affine_coefs).
//
// The caller passes the nine entries of the INVERSE 3x3 map (the forward
// matrix is inverted on the host, as cv2 does). One thread per output pixel
// maps (x, y) to the source coordinate (h0 x + h1 y + h2) / (h6 x + h7 y + h8),
// (h3 x + h4 y + h5) / (...) and gathers 1, 4 or 16 taps per channel; a tap
// outside the source contributes zero. Every float operation is
// round-to-nearest and in the order of frtm_tpu/ops/warp.py::_resample and
// the port's plain version (no FMA contraction), so on the card the two agree
// bit for bit, nearest-mode rounding included.
//
// Bound: bytes — each output reads at most 16 source values per channel,
// mostly from cache, and does a few dozen flops. The TPU kernel's one-hot
// selection-matrix products (99.6% multiplications by zero) worked around the
// TPU's lack of a vector gather; a GPU gathers directly.
#include "common.cuh"

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

struct Inverse {
  float h[9];
};

__device__ __forceinline__ float cubic_weight(float t) {
  // a = -0.75: (a+2) = 1.25, (a+3) = 2.25, 5a = -3.75, 8a = -6, 4a = -3
  const float x = fabsf(t);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  if (x < 1.f)
    return __fadd_rn(__fsub_rn(__fmul_rn(1.25f, x3), __fmul_rn(2.25f, x2)), 1.f);
  if (x < 2.f)
    return __fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(-0.75f, x3),
                                         __fmul_rn(-3.75f, x2)),
                               __fmul_rn(-6.f, x)),
                     -3.f);
  return 0.f;
}

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

template <int MODE>  // 0 nearest, 1 bilinear, 2 bicubic
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
warp_affine_kernel(const float* __restrict__ src, float* __restrict__ out,
                   int C, int H, int W, int OH, int OW, Inverse m) {
  const int ox = blockIdx.x * kThreadsX + threadIdx.x;
  const int oy = blockIdx.y * kThreadsY + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  const float xo = static_cast<float>(ox);
  const float yo = static_cast<float>(oy);
  const float* h = m.h;
  const float xn = __fadd_rn(__fadd_rn(__fmul_rn(h[0], xo), __fmul_rn(h[1], yo)), h[2]);
  const float yn = __fadd_rn(__fadd_rn(__fmul_rn(h[3], xo), __fmul_rn(h[4], yo)), h[5]);
  const float wn = __fadd_rn(__fadd_rn(__fmul_rn(h[6], xo), __fmul_rn(h[7], yo)), h[8]);
  const float xs = __fdiv_rn(xn, wn);
  const float ys = __fdiv_rn(yn, wn);

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t oplane = static_cast<size_t>(OH) * OW;
  float* o = out + static_cast<size_t>(oy) * OW + ox;

  if (MODE == 0) {
    const int ix = to_index(floorf(__fadd_rn(xs, 0.5f)), W);
    const int iy = to_index(floorf(__fadd_rn(ys, 0.5f)), H);
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
  dim3 block(kThreadsX, kThreadsY);
  dim3 grid((OW + kThreadsX - 1) / kThreadsX, (OH + kThreadsY - 1) / kThreadsY);
  if (mode == 0)
    warp_affine_kernel<0><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else if (mode == 1)
    warp_affine_kernel<1><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else if (mode == 2)
    warp_affine_kernel<2><<<grid, block, 0, stream>>>(src, out, C, H, W, OH, OW, m);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
