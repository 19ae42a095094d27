// Triage triangulation and inverse-depth refresh for every track: the
// confidence-weighted line-intersection normal equations, a closed-form,
// trace-normalised Tikhonov 3x3 solve, the anchor camera's in-front and
// field-of-view checks, and the bearing / inverse-depth refresh.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::triage_refresh_fused (:930) ->
// _triage_call (:867) -> _triage_kernel (:771).
//
// The arithmetic is the TPU kernel's, term for term, with its own floors:
// direction norm >= 1e-30, Gram scale >= 1e-20 and |det| >= 1e-38 (in both
// types), |z| >= 1e-30, |W_v| >= 1e-30, and m = W_v / |W_v| computed
// directly (not through the angle round trip). The TPU kernel's
// channel-first planes are not copied: inputs keep the natural (F, M, 3)
// layout.
//
// Design: one thread per track, a sequential loop over its M observations
// (the plain version sums in the same order), over a grid of (track blocks,
// B sequences): the batched form (the JAX custom_vmap rule's batch grid,
// pallas_kernels.py:911-928) is blockIdx.y, a single call is B = 1, and
// each sequence reads and writes at its own base offsets, so a batched
// launch gives each sequence the bits of a single launch. The file is built without
// multiply-add contraction, so every product and sum rounds as in the plain
// version, which makes the ok and field-of-view decisions bitwise equal
// between the two. What bounds it on the H100: at F x M = 768 x 32 it reads
// ~0.7 MB (0.2 us at 3.35 TB/s) and does ~1.3 MFLOP: bytes; at this size a
// launch of 12 small blocks is mostly latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
triage_kernel(const T* __restrict__ base, const T* __restrict__ dir,
              const T* __restrict__ w, const T* __restrict__ Ra,
              const T* __restrict__ ta, const T* __restrict__ K,
              const T* __restrict__ Ki, T eps, T width, T height,
              T* __restrict__ m_out, T* __restrict__ rho_out,
              unsigned char* __restrict__ ok_out, int F, int M) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  base += sq * F * M * 3;
  dir += sq * F * M * 3;
  w += sq * F * M;
  Ra += sq * F * 9;
  ta += sq * F * 3;
  K += sq * 9;
  Ki += sq * 9;
  m_out += sq * F * 3;
  rho_out += sq * F;
  ok_out += sq * F;

  // X = sum w (I - d d^T), y = sum w (I - d d^T) b over the observations
  T X00 = T(0), X01 = T(0), X02 = T(0), X11 = T(0), X12 = T(0), X22 = T(0);
  T y0 = T(0), y1 = T(0), y2 = T(0);
  for (int m = 0; m < M; ++m) {
    const size_t o = (size_t)f * M + m;
    const T b0 = base[o * 3], b1 = base[o * 3 + 1], b2 = base[o * 3 + 2];
    const T d0 = dir[o * 3], d1 = dir[o * 3 + 1], d2 = dir[o * 3 + 2];
    const T wm = w[o];
    T n = sqrt_t(d0 * d0 + d1 * d1 + d2 * d2);
    n = (n < T(1e-30)) ? T(1e-30) : n;
    const T e0 = d0 / n, e1 = d1 / n, e2 = d2 / n;
    X00 = X00 + wm * (T(1) - e0 * e0);
    X01 = X01 + wm * (T(0) - e0 * e1);
    X02 = X02 + wm * (T(0) - e0 * e2);
    X11 = X11 + wm * (T(1) - e1 * e1);
    X12 = X12 + wm * (T(0) - e1 * e2);
    X22 = X22 + wm * (T(1) - e2 * e2);
    const T db = e0 * b0 + e1 * b1 + e2 * b2;
    y0 = y0 + wm * (b0 - e0 * db);
    y1 = y1 + wm * (b1 - e1 * db);
    y2 = y2 + wm * (b2 - e2 * db);
  }

  // closed-form trace-normalised Tikhonov 3x3 inverse applied to y
  T scale = (X00 + X11 + X22) / T(3);
  scale = (scale < T(1e-20)) ? T(1e-20) : scale;
  const T a = X00 / scale + eps, b = X01 / scale, c = X02 / scale;
  const T d = X11 / scale + eps, e = X12 / scale, g = X22 / scale + eps;
  const T co00 = d * g - e * e;
  const T co01 = c * e - b * g;
  const T co02 = b * e - c * d;
  const T co11 = a * g - c * c;
  const T co12 = c * b - a * e;
  const T co22 = a * d - b * b;
  T det = a * co00 + b * co01 + c * co02;
  det = (abs_t(det) < T(1e-38)) ? T(1e-38) : det;
  const T inv_det = T(1) / (det * scale);
  const T Wp0 = (co00 * y0 + co01 * y1 + co02 * y2) * inv_det;
  const T Wp1 = (co01 * y0 + co11 * y1 + co12 * y2) * inv_det;
  const T Wp2 = (co02 * y0 + co12 * y1 + co22 * y2) * inv_det;

  // anchor camera frame: Ci = Ra^T (Wp - ta)
  T R[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = Ra[(size_t)f * 9 + i];
  const T dx = Wp0 - ta[(size_t)f * 3];
  const T dy = Wp1 - ta[(size_t)f * 3 + 1];
  const T dz = Wp2 - ta[(size_t)f * 3 + 2];
  const T Ci0 = R[0] * dx + R[3] * dy + R[6] * dz;
  const T Ci1 = R[1] * dx + R[4] * dy + R[7] * dz;
  const T Ci2 = R[2] * dx + R[5] * dy + R[8] * dz;

  // pinhole projection and the field-of-view test
  const T z = (abs_t(Ci2) < T(1e-30)) ? T(1e-30) : Ci2;
  const T u = (K[0] * Ci0 + K[1] * Ci1 + K[2] * Ci2) / z;
  const T v = (K[3] * Ci0 + K[4] * Ci1 + K[5] * Ci2) / z;
  const bool ok = (Ci2 > T(0)) && (u >= T(0)) && (u < width) && (v >= T(0)) && (v < height);

  // bearing refresh: W_v = Ra K^-1 [u, v, 1], m = W_v / |W_v|
  const T cx = Ki[0] * u + Ki[1] * v + Ki[2];
  const T cy = Ki[3] * u + Ki[4] * v + Ki[5];
  const T cz = Ki[6] * u + Ki[7] * v + Ki[8];
  const T Wv0 = R[0] * cx + R[1] * cy + R[2] * cz;
  const T Wv1 = R[3] * cx + R[4] * cy + R[5] * cz;
  const T Wv2 = R[6] * cx + R[7] * cy + R[8] * cz;
  T nrm = sqrt_t(Wv0 * Wv0 + Wv1 * Wv1 + Wv2 * Wv2);
  nrm = (nrm < T(1e-30)) ? T(1e-30) : nrm;
  m_out[(size_t)f * 3] = Wv0 / nrm;
  m_out[(size_t)f * 3 + 1] = Wv1 / nrm;
  m_out[(size_t)f * 3 + 2] = Wv2 / nrm;
  rho_out[f] = T(1) / z;
  ok_out[f] = ok ? 1 : 0;
}

template <typename T>
int launch(const void* base, const void* dir, const void* w, const void* Ra,
           const void* ta, const void* K, const void* Ki, double eps, double width,
           double height, void* m, void* rho, void* ok, int F, int M, int B,
           cudaStream_t stream) {
  if (F < 1 || M < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + kThreads - 1) / kThreads, B);
  triage_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(base), static_cast<const T*>(dir), static_cast<const T*>(w),
      static_cast<const T*>(Ra), static_cast<const T*>(ta), static_cast<const T*>(K),
      static_cast<const T*>(Ki), T(eps), T(width), T(height), static_cast<T*>(m),
      static_cast<T*>(rho), static_cast<unsigned char*>(ok), F, M);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences (K and K^-1 too)
MSCKF_EXPORT int msckf_triage_f32(const void* base, const void* dir, const void* w,
                                  const void* Ra, const void* ta, const void* K,
                                  const void* Ki, double eps, double width, double height,
                                  void* m, void* rho, void* ok, int F, int M, int B,
                                  void* stream) {
  return launch<float>(base, dir, w, Ra, ta, K, Ki, eps, width, height, m, rho, ok, F, M, B,
                       static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_triage_f64(const void* base, const void* dir, const void* w,
                                  const void* Ra, const void* ta, const void* K,
                                  const void* Ki, double eps, double width, double height,
                                  void* m, void* rho, void* ok, int F, int M, int B,
                                  void* stream) {
  return launch<double>(base, dir, w, Ra, ta, K, Ki, eps, width, height, m, rho, ok, F, M, B,
                        static_cast<cudaStream_t>(stream));
}
