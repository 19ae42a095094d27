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
// CURRENT keypoint. The file is built without multiply-add contraction, and
// every product and sum is taken in the plain version's order
// (ops/kernels.py::verification_scores_plain), so the three scores are
// bitwise equal to it.
//
// What bounds it on the H100: per pair it reads 14 values (R1, t1, kp1)
// and writes 3: at the main path's 768 x 32 pairs ~1.7 MB in f32 (0.5 us at
// 3.35 TB/s), at B = 32 sequences 53.6 MB (16 us). Without contraction a
// pair is also ~440 FP32 instructions (FMUL, FADD), four IEEE divisions and
// three IEEE square roots (cuobjdump counts ~840 SASS instructions in the
// body, slow paths included): at B = 32 about as long on the FP32 pipes
// (132 SMs x 4 schedulers, one warp instruction a cycle) as the bytes take.
// A single call is the launch, one load round trip and one lane's chain at a
// few warps an SM.
//
// Design: one lane a pair, 128 lanes a block (the plan,
// ops/kernels.py::verification_plan), so the main path's 768 x 32 pairs
// fill 192 blocks over the 132 SMs. Each lane loads its 16 values straight
// from device memory (L1 merges a warp's strided loads into whole lines),
// and the sequence's camera pose, K and K^-1 (30 values) itself, from four
// pointers, each with its stride a sequence (0 where the sequences share
// it, as K and K^-1 do on the batched loop): the launcher gathers nothing
// into one array first. The constants' addresses are the same across a
// warp, so each of those loads is one transaction, served by L1 after the
// first warp, and they are in flight with the pair's own: no shared memory
// and no barrier, so no warp waits for a copy of the constants (a block
// copying them into shared memory behind a barrier measured slower). Each
// lane writes its three scores, coalesced: a pair costs the fewest issued
// instructions, and the warps an SM holds overlap each other's round trips
// and chains. A block's pairs staged in shared memory by 16-byte cp.async
// copies, each pair's chain split over three lanes (each recomputing R12),
// and a per-warp cp.async ring were built, bitwise equal, and measured
// slower at both sizes (PERF.md, section 6): the split adds instructions
// to a pass that issue already bounds, and a wait on staged copies adds to
// every round trip what direct loads overlap. The grid is
// (pair blocks, B sequences): the batched form (the JAX custom_vmap rule's
// batch grid axis, pallas_kernels.py:737-750) is blockIdx.y, a single call
// is B = 1, and each sequence reads and writes at its own base offsets, so
// a batched launch gives each sequence the bits of a single launch.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

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
__global__ void __launch_bounds__(kMaxThreads)
    verification_kernel(const T* __restrict__ R1, const T* __restrict__ t1,
                        const T* __restrict__ kp1, const T* __restrict__ kp2,
                        const T* __restrict__ camR, const T* __restrict__ camt,
                        const T* __restrict__ K, const T* __restrict__ Kinv, int sR, int st,
                        int sK, int sKi, T* __restrict__ homo, T* __restrict__ epi,
                        T* __restrict__ base, int F, int M) {
  const size_t sq = blockIdx.y;  // the sequence of a batched launch
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

  T R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = R1[(size_t)idx * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t1[(size_t)idx * 3 + i];
  const T x1 = kp1[(size_t)idx * 2], y1 = kp1[(size_t)idx * 2 + 1];
  const T x2 = kp2[(size_t)f * 2], y2 = kp2[(size_t)f * 2 + 1];
  // the sequence's camR | camt | K | K^-1: one address across the warp, so
  // one transaction a load
  T C[30];
#pragma unroll
  for (int i = 0; i < 9; ++i) C[i] = __ldg(camR + sq * sR + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) C[9 + i] = __ldg(camt + sq * st + i);
#pragma unroll
  for (int i = 0; i < 9; ++i) C[12 + i] = __ldg(K + sq * sK + i);
#pragma unroll
  for (int i = 0; i < 9; ++i) C[21 + i] = __ldg(Kinv + sq * sKi + i);
  const T* cR = C;
  const T* ct = C + 9;
  const T* Kc = C + 12;
  const T* Ki = C + 21;

  // T_C1_C2 = T1^-1 T2: R12 = R1^T camR, t12 = R1^T (camt - t1)
  T R12[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R12[i * 3 + j] = R[0 * 3 + i] * cR[0 * 3 + j] + R[1 * 3 + i] * cR[1 * 3 + j] +
                       R[2 * 3 + i] * cR[2 * 3 + j];
  T d[3], t12[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = ct[i] - t[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t12[i] = R[0 * 3 + i] * d[0] + R[1 * 3 + i] * d[1] + R[2 * 3 + i] * d[2];
  base[idx] = sqrt_t(t12[0] * t12[0] + t12[1] * t12[1] + t12[2] * t12[2]);

  // homography branch: H = K R12 K^-1, H^-1 = K R12^T K^-1
  T KR[9], H[9], R12T[9], Hinv[9];
  mm(Kc, R12, KR);
  mm(KR, Ki, H);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R12T[i * 3 + j] = R12[j * 3 + i];
  mm(Kc, R12T, KR);
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
int launch(const void* R1, const void* t1, const void* kp1, const void* kp2, const void* camR,
           const void* camt, const void* K, const void* Kinv, int sR, int st, int sK, int sKi,
           void* homo, void* epi, void* base, int F, int M, int B, int threads,
           cudaStream_t stream) {
  // the plan (ops/kernels.py::verification_plan): whole warps, up to
  // kMaxThreads a block; a constant's stride is its size, or 0 where the
  // sequences share it
  if (F < 1 || M < 1 || B < 1 || B > 65535 || (long long)F * M > INT_MAX - kMaxThreads ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || (sR != 0 && sR != 9) ||
      (st != 0 && st != 3) || (sK != 0 && sK != 9) || (sKi != 0 && sKi != 9))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F * M + threads - 1) / threads, B);
  verification_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(R1), static_cast<const T*>(t1), static_cast<const T*>(kp1),
      static_cast<const T*>(kp2), static_cast<const T*>(camR), static_cast<const T*>(camt),
      static_cast<const T*>(K), static_cast<const T*>(Kinv), sR, st, sK, sKi,
      static_cast<T*>(homo), static_cast<T*>(epi), static_cast<T*>(base), F, M);
  return (int)cudaGetLastError();
}

}  // namespace

// R1 (B, F, M, 3, 3), t1 (B, F, M, 3), kp1 (B, F, M, 2), kp2 (B, F, 2);
// camR, K and Kinv (B, 3, 3) and camt (B, 3) with strides sR, sK, sKi = 9
// and st = 3, or one for all sequences with stride 0; homo, epi and base
// (B, F, M). threads is the plan's threads (pairs) a block.
MSCKF_EXPORT int msckf_verification_f32(const void* R1, const void* t1, const void* kp1,
                                        const void* kp2, const void* camR, const void* camt,
                                        const void* K, const void* Kinv, int sR, int st,
                                        int sK, int sKi, void* homo, void* epi, void* base,
                                        int F, int M, int B, int threads, void* stream) {
  return launch<float>(R1, t1, kp1, kp2, camR, camt, K, Kinv, sR, st, sK, sKi, homo, epi, base,
                       F, M, B, threads, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_verification_f64(const void* R1, const void* t1, const void* kp1,
                                        const void* kp2, const void* camR, const void* camt,
                                        const void* K, const void* Kinv, int sR, int st,
                                        int sK, int sKi, void* homo, void* epi, void* base,
                                        int F, int M, int B, int threads, void* stream) {
  return launch<double>(R1, t1, kp1, kp2, camR, camt, K, Kinv, sR, st, sK, sKi, homo, epi,
                        base, F, M, B, threads, static_cast<cudaStream_t>(stream));
}
