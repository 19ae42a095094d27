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
// layout. The file is built without multiply-add contraction, and each of
// the nine sums over observations is taken in m order starting from 0, as
// the plain version takes it, so m, rho and ok are bitwise equal to the
// plain version's.
//
// What bounds it on the H100: at F x M = 768 x 32 it reads ~0.7 MB (0.2 us
// at 3.35 TB/s) and does ~1.3 MFLOP: bytes, but at this size the time is
// latency, so the design keeps every thread's loads in one round trip and
// the track's sums off one serial chain. What is left is that round trip
// per pass and the IEEE divisions and square roots (the file is built
// without contraction): at B = 32 each pass's observation phase is a
// dependent chain (a square root, three divisions) that the blocks
// resident on an SM do not hide, and the per-track epilogue's chain is
// about as long as the load.
//
// Design: lanes over (track, observation), the epilogues side by side. A
// block takes `tracks` whole tracks (the wrapper's plan,
// ops/kernels.py::triage_plan: 4 at the main path's 768 x 32, 192 blocks
// over the 132 SMs; 32 at B = 32) and walks them in passes of g tracks x
// mc observations (g = 8, mc = M at M = 32; one track in spans of 256
// past M = 256; a pass is one contiguous span of the inputs):
//   1. the block starts the copy of the pass's line_base, line_dir and
//      weights (and, once, the tracks' anchor poses, K and K^-1) into
//      shared memory by cp.async, 16 bytes a copy where the span starts on
//      16 bytes, every copy in flight at once: one round trip a pass;
//   2. each lane takes one observation: the normalised direction (norm,
//      floor, three divisions) and its nine terms w (delta - e e) and
//      w (b - e (e . b)), written to shared memory at (track, term) rows of
//      an odd pitch, so the summing lanes below hit distinct banks;
//   3. after one barrier, 9 lanes per track each add one term's row in m
//      order to a running sum held in a register across spans: nine
//      independent chains in place of one chain of 9 M dependent steps;
//   4. after the passes, one lane per track solves, tests and refreshes, as
//      the TPU kernel's epilogue does: up to 32 epilogues side by side.
// The grid is (track blocks, B sequences): the batched form (the JAX
// custom_vmap rule's batch grid, pallas_kernels.py:911-928) is blockIdx.y,
// a single call is B = 1, and each sequence reads and writes at its own
// base offsets; the plan decides where a term is computed, never the order
// of a sum, so a batched launch gives each sequence the bits of a single
// launch. Any F >= 1 and M >= 1; a ragged last block is masked. Shared
// memory stays under the 48 KB a block gets without an opt-in.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // observations of one pass, and the block's threads
constexpr int kMaxTracks = 32;    // tracks of a block: one warp of epilogues
constexpr int kTerms = 9;         // X00 X01 X02 X11 X12 X22 y0 y1 y2
constexpr size_t kSmemLimit = 48 * 1024;

__host__ __device__ inline int round_v(int n, int v) { return (n + v - 1) / v * v; }

// the odd pitch of a term row, in elements
__host__ __device__ inline int term_pitch(int mc) { return mc | 1; }

// shared-memory layout, in elements of T, for blocks of `tracks` tracks
// walked in passes of g tracks x mc observations: a pass's base and dir
// (3 g mc each) and w (g mc); the block's anchor rotations (9 tracks) and
// translations (3 tracks), K and K^-1 (9 each); a pass's terms (9 g rows
// of term_pitch); the block's sums (9 tracks); every array starts on 16
// bytes
template <typename T>
struct Layout {
  int base, dir, w, R, t, K, Ki, term, sum, total;
  __host__ __device__ Layout(int tracks, int g, int mc) {
    constexpr int V = 16 / sizeof(T);
    base = 0;
    dir = base + round_v(3 * g * mc, V);
    w = dir + round_v(3 * g * mc, V);
    R = w + round_v(g * mc, V);
    t = R + round_v(9 * tracks, V);
    K = t + round_v(3 * tracks, V);
    Ki = K + round_v(9, V);
    term = Ki + round_v(9, V);
    sum = term + round_v(kTerms * g * term_pitch(mc), V);
    total = sum + round_v(kTerms * tracks, V);
  }
};

// Starts the copy of n contiguous elements from global to shared memory:
// 16 bytes a copy where src starts on 16 bytes (dst always does), else one
// element. Every copy of a pass is in flight at once.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) cp_async<16>(dst + i * V, src + i * V);
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) cp_async<sizeof(T)>(dst + i, src + i);
}

// one track's epilogue, the TPU kernel's: the closed-form trace-normalised
// Tikhonov 3x3 solve of its sums S, the anchor frame, the projection and
// field-of-view test, and the refresh of track f
template <typename T>
__device__ __forceinline__ void epilogue(const T* S, const T* R, const T* tv, const T* Kp,
                                         const T* Kip, T eps, T width, T height, size_t f,
                                         T* __restrict__ m_out, T* __restrict__ rho_out,
                                         unsigned char* __restrict__ ok_out) {
  const T X00 = S[0], X01 = S[1], X02 = S[2], X11 = S[3], X12 = S[4], X22 = S[5];
  const T y0 = S[6], y1 = S[7], y2 = S[8];

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
  const T dx = Wp0 - tv[0];
  const T dy = Wp1 - tv[1];
  const T dz = Wp2 - tv[2];
  const T Ci0 = R[0] * dx + R[3] * dy + R[6] * dz;
  const T Ci1 = R[1] * dx + R[4] * dy + R[7] * dz;
  const T Ci2 = R[2] * dx + R[5] * dy + R[8] * dz;

  // pinhole projection and the field-of-view test
  const T z = (abs_t(Ci2) < T(1e-30)) ? T(1e-30) : Ci2;
  const T u = (Kp[0] * Ci0 + Kp[1] * Ci1 + Kp[2] * Ci2) / z;
  const T v = (Kp[3] * Ci0 + Kp[4] * Ci1 + Kp[5] * Ci2) / z;
  const bool ok = (Ci2 > T(0)) && (u >= T(0)) && (u < width) && (v >= T(0)) && (v < height);

  // bearing refresh: W_v = Ra K^-1 [u, v, 1], m = W_v / |W_v|
  const T cx = Kip[0] * u + Kip[1] * v + Kip[2];
  const T cy = Kip[3] * u + Kip[4] * v + Kip[5];
  const T cz = Kip[6] * u + Kip[7] * v + Kip[8];
  const T Wv0 = R[0] * cx + R[1] * cy + R[2] * cz;
  const T Wv1 = R[3] * cx + R[4] * cy + R[5] * cz;
  const T Wv2 = R[6] * cx + R[7] * cy + R[8] * cz;
  T nrm = sqrt_t(Wv0 * Wv0 + Wv1 * Wv1 + Wv2 * Wv2);
  nrm = (nrm < T(1e-30)) ? T(1e-30) : nrm;
  m_out[f * 3] = Wv0 / nrm;
  m_out[f * 3 + 1] = Wv1 / nrm;
  m_out[f * 3 + 2] = Wv2 / nrm;
  rho_out[f] = T(1) / z;
  ok_out[f] = ok ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
triage_kernel(const T* __restrict__ base, const T* __restrict__ dir,
              const T* __restrict__ w, const T* __restrict__ Ra,
              const T* __restrict__ ta, const T* __restrict__ K,
              const T* __restrict__ Ki, T eps, T width, T height,
              T* __restrict__ m_out, T* __restrict__ rho_out,
              unsigned char* __restrict__ ok_out, int F, int M, int tracks, int g, int mc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Layout<T> L(tracks, g, mc);
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * tracks;
  const int nh = min(tracks, F - f0);  // tracks of this block (the last may be ragged)
  const size_t sq = blockIdx.y;        // the sequence of a batched launch
  const size_t first = sq * F + f0;    // the block's first track, over the batch

  copy_async(sm + L.R, Ra + first * 9, 9 * nh);
  copy_async(sm + L.t, ta + first * 3, 3 * nh);
  copy_async(sm + L.K, K + sq * 9, 9);
  copy_async(sm + L.Ki, Ki + sq * 9, 9);

  const int pitch = term_pitch(mc);
  const T* row = sm + L.term + tid * pitch;
  // passes: g tracks at a time, each in spans of mc observations
  for (int s0 = 0; s0 < nh; s0 += g) {
    const int ng = min(g, nh - s0);  // tracks of this pass
    T part = T(0);
    for (int m0 = 0; m0 < M; m0 += mc) {
      const int mp = min(mc, M - m0);  // observations of this pass
      // ng tracks x mp observations: contiguous, since a pass spans whole
      // tracks (m0 == 0, mp == M) or the plan gives it one track
      const size_t o = (first + s0) * M + m0;
      copy_async(sm + L.base, base + o * 3, 3 * ng * mp);
      copy_async(sm + L.dir, dir + o * 3, 3 * ng * mp);
      copy_async(sm + L.w, w + o, ng * mp);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      for (int ob = tid; ob < ng * mp; ob += blockDim.x) {
        const int tr = ob / mp, m = ob - tr * mp;
        const T* b = sm + L.base + ob * 3;
        const T* d = sm + L.dir + ob * 3;
        const T b0 = b[0], b1 = b[1], b2 = b[2];
        const T d0 = d[0], d1 = d[1], d2 = d[2];
        const T wm = sm[L.w + ob];
        T n = sqrt_t(d0 * d0 + d1 * d1 + d2 * d2);
        n = (n < T(1e-30)) ? T(1e-30) : n;
        const T e0 = d0 / n, e1 = d1 / n, e2 = d2 / n;
        const T db = e0 * b0 + e1 * b1 + e2 * b2;
        T* out = sm + L.term + tr * kTerms * pitch + m;
        out[0 * pitch] = wm * (T(1) - e0 * e0);
        out[1 * pitch] = wm * (T(0) - e0 * e1);
        out[2 * pitch] = wm * (T(0) - e0 * e2);
        out[3 * pitch] = wm * (T(1) - e1 * e1);
        out[4 * pitch] = wm * (T(0) - e1 * e2);
        out[5 * pitch] = wm * (T(1) - e2 * e2);
        out[6 * pitch] = wm * (b0 - e0 * db);
        out[7 * pitch] = wm * (b1 - e1 * db);
        out[8 * pitch] = wm * (b2 - e2 * db);
      }
      __syncthreads();
      // lane (track, term) adds its row in m order, across the spans
      if (tid < kTerms * ng)
        for (int m = 0; m < mp; ++m) part = part + row[m];
      // the sums have read the terms before the next pass overwrites them
      __syncthreads();
    }
    if (tid < kTerms * ng) sm[L.sum + s0 * kTerms + tid] = part;
  }
  __syncthreads();
  // one lane per track: the block's epilogues run side by side
  if (tid < nh)
    epilogue(sm + L.sum + tid * kTerms, sm + L.R + tid * 9, sm + L.t + tid * 3, sm + L.K,
             sm + L.Ki, eps, width, height, first + tid, m_out, rho_out, ok_out);
}

template <typename T>
int launch(const void* base, const void* dir, const void* w, const void* Ra,
           const void* ta, const void* K, const void* Ki, double eps, double width,
           double height, void* m, void* rho, void* ok, int F, int M, int B, int tracks,
           int g, int mc, int threads, int smem, cudaStream_t stream) {
  // the plan (ops/kernels.py::triage_plan): a pass of several tracks only
  // where it holds them whole, a thread for every lane of the sums and of
  // the epilogue, and the layout's bytes
  if (F < 1 || M < 1 || B < 1 || B > 65535 || tracks < 1 || tracks > kMaxTracks || g < 1 ||
      g > tracks || mc < 1 || mc > M || g * mc > kMaxThreads || (g > 1 && mc != M) ||
      threads % 32 != 0 || threads > kMaxThreads || threads < kTerms * g || threads < tracks ||
      (size_t)smem != Layout<T>(tracks, g, mc).total * sizeof(T) || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + tracks - 1) / tracks, B);
  triage_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(base), static_cast<const T*>(dir), static_cast<const T*>(w),
      static_cast<const T*>(Ra), static_cast<const T*>(ta), static_cast<const T*>(K),
      static_cast<const T*>(Ki), T(eps), T(width), T(height), static_cast<T*>(m),
      static_cast<T*>(rho), static_cast<unsigned char*>(ok), F, M, tracks, g, mc);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences (K and K^-1 too);
// tracks, g, mc, threads and smem are the plan's tracks per block, tracks
// and observations per pass, threads per block and shared-memory bytes
MSCKF_EXPORT int msckf_triage_f32(const void* base, const void* dir, const void* w,
                                  const void* Ra, const void* ta, const void* K,
                                  const void* Ki, double eps, double width, double height,
                                  void* m, void* rho, void* ok, int F, int M, int B, int tracks,
                                  int g, int mc, int threads, int smem,
                                  void* stream) {
  return launch<float>(base, dir, w, Ra, ta, K, Ki, eps, width, height, m, rho, ok, F, M, B,
                       tracks, g, mc, threads, smem, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_triage_f64(const void* base, const void* dir, const void* w,
                                  const void* Ra, const void* ta, const void* K,
                                  const void* Ki, double eps, double width, double height,
                                  void* m, void* rho, void* ok, int F, int M, int B, int tracks,
                                  int g, int mc, int threads, int smem,
                                  void* stream) {
  return launch<double>(base, dir, w, Ra, ta, K, Ki, eps, width, height, m, rho, ok, F, M, B,
                        tracks, g, mc, threads, smem, static_cast<cudaStream_t>(stream));
}
