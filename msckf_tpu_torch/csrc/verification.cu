// Two-tier geometric verification scores for every (track, observation)
// pair: baseline |t12|, homography symmetric transfer error with
// H = K R12 K^-1, and the signed epipolar residual x2^T K^-T [t12]x R12 K^-1 x1.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::verification_scores (:752) ->
// _verification_call (:692) -> _verification_kernel (:626).
//
// The arithmetic is the TPU kernel's, term for term: R12 = R1^T camR,
// t12 = R1^T (camt - t1), the same 1e-30 guard on the projected z (kept
// because the slice's configuration selects this kernel, not the unguarded
// XLA form), and the reference's literal comparison of H^-1 x2 against the
// CURRENT keypoint.
//
// Design: a pure elementwise pass, one thread per pair, over a grid of
// (pair blocks, B sequences): the batched form (the JAX custom_vmap rule's
// batch grid axis, pallas_kernels.py:737-750) is blockIdx.y, a single call
// is B = 1, and each sequence reads and writes at its own base offsets, so
// a batched launch gives each sequence the bits of a single launch. A
// block copies its sequence's current camera pose, K and K^-1 (30 values)
// into shared memory, so every thread reads them as broadcast values; each
// thread reads its 14 pair values and the track's keypoint and writes 3
// scores. What bounds it on the H100: at F x M = 24,576 pairs it moves
// ~1.7 MB (0.5 us at 3.35 TB/s) and does ~11 MFLOP (0.2 us at 67 TFLOP/s
// f32) per sequence: bytes, and at this size mostly the launch itself.
#include "common.cuh"

namespace {

// (3x3) @ (3x3), row-major, with the summation order of the TPU kernel's
// plane helpers (k = 0, 1, 2)
template <typename T>
__device__ __forceinline__ void mm(const T* A, const T* B, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                       A[i * 3 + 2] * B[2 * 3 + j];
}

template <typename T>
__device__ __forceinline__ void mv(const T* A, const T* x, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = A[i * 3 + 0] * x[0] + A[i * 3 + 1] * x[1] + A[i * 3 + 2] * x[2];
}

template <typename T>
__global__ void verification_kernel(const T* __restrict__ R1, const T* __restrict__ t1,
                                    const T* __restrict__ kp1, const T* __restrict__ kp2,
                                    const T* __restrict__ consts, T* __restrict__ homo,
                                    T* __restrict__ epi, T* __restrict__ base, int F, int M) {
  __shared__ T C[30];
  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  if (threadIdx.x < 30) C[threadIdx.x] = consts[sq * 30 + threadIdx.x];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * M) return;
  const size_t pairs = (size_t)F * M;
  R1 += sq * pairs * 9;
  t1 += sq * pairs * 3;
  kp1 += sq * pairs * 2;
  kp2 += sq * F * 2;
  homo += sq * pairs;
  epi += sq * pairs;
  base += sq * pairs;
  const int f = idx / M;
  const T* camR = C;
  const T* camt = C + 9;
  const T* K = C + 12;
  const T* Ki = C + 21;

  T R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = R1[(size_t)idx * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t1[(size_t)idx * 3 + i];
  const T x1 = kp1[(size_t)idx * 2], y1 = kp1[(size_t)idx * 2 + 1];
  const T x2 = kp2[(size_t)f * 2], y2 = kp2[(size_t)f * 2 + 1];

  // T_C1_C2 = T1^-1 T2: R12 = R1^T camR, t12 = R1^T (camt - t1)
  T R12[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R12[i * 3 + j] = R[0 * 3 + i] * camR[0 * 3 + j] + R[1 * 3 + i] * camR[1 * 3 + j] +
                       R[2 * 3 + i] * camR[2 * 3 + j];
  T d[3], t12[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = camt[i] - t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t12[i] = R[0 * 3 + i] * d[0] + R[1 * 3 + i] * d[1] + R[2 * 3 + i] * d[2];
  base[idx] = sqrt_t(t12[0] * t12[0] + t12[1] * t12[1] + t12[2] * t12[2]);

  // homography branch: H = K R12 K^-1, H^-1 = K R12^T K^-1
  T KR[9], H[9], R12T[9], Hinv[9];
  mm(K, R12, KR);
  mm(KR, Ki, H);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R12T[i * 3 + j] = R12[j * 3 + i];
  mm(K, R12T, KR);
  mm(KR, Ki, Hinv);
  const T x2h[3] = {x2, y2, T(1)};
  const T x1h[3] = {x1, y1, T(1)};
  T x1p[3], x2p[3];
  mv(Hinv, x2h, x1p);
  mv(H, x1h, x2p);
  const T z1 = (abs_t(x1p[2]) < T(1e-30)) ? T(1e-30) : x1p[2];
  const T z2 = (abs_t(x2p[2]) < T(1e-30)) ? T(1e-30) : x2p[2];
  const T e1x = x2 - x1p[0] / z1, e1y = y2 - x1p[1] / z1;
  const T e2x = x1 - x2p[0] / z2, e2y = y1 - x2p[1] / z2;
  homo[idx] = T(0.5) * (sqrt_t(e1x * e1x + e1y * e1y) + sqrt_t(e2x * e2x + e2y * e2y));

  // epipolar branch: Fm = K^-T [t12]x R12 K^-1; score = x2^T Fm x1, signed
  const T sk[9] = {T(0), -t12[2], t12[1], t12[2], T(0), -t12[0], -t12[1], t12[0], T(0)};
  T KiT[9], SR[9], tmp[9], Fm[9], Fx1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) KiT[i * 3 + j] = Ki[j * 3 + i];
  mm(sk, R12, SR);
  mm(KiT, SR, tmp);
  mm(tmp, Ki, Fm);
  mv(Fm, x1h, Fx1);
  epi[idx] = x2h[0] * Fx1[0] + x2h[1] * Fx1[1] + x2h[2] * Fx1[2];
}

template <typename T>
int launch(const void* R1, const void* t1, const void* kp1, const void* kp2,
           const void* consts, void* homo, void* epi, void* base, int F, int M, int B,
           cudaStream_t stream) {
  if (F < 1 || M < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((F * M + threads - 1) / threads, B);
  verification_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(R1), static_cast<const T*>(t1), static_cast<const T*>(kp1),
      static_cast<const T*>(kp2), static_cast<const T*>(consts), static_cast<T*>(homo),
      static_cast<T*>(epi), static_cast<T*>(base), F, M);
  return (int)cudaGetLastError();
}

}  // namespace

// consts: (B, 30) = camR (9) | camt (3) | K (9) | K^-1 (9) per sequence;
// every other array carries a leading axis of B sequences
MSCKF_EXPORT int msckf_verification_f32(const void* R1, const void* t1, const void* kp1,
                                        const void* kp2, const void* consts, void* homo,
                                        void* epi, void* base, int F, int M, int B,
                                        void* stream) {
  return launch<float>(R1, t1, kp1, kp2, consts, homo, epi, base, F, M, B,
                       static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_verification_f64(const void* R1, const void* t1, const void* kp1,
                                        const void* kp2, const void* consts, void* homo,
                                        void* epi, void* base, int F, int M, int B,
                                        void* stream) {
  return launch<double>(R1, t1, kp1, kp2, consts, homo, epi, base, F, M, B,
                        static_cast<cudaStream_t>(stream));
}
