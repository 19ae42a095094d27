// 15x15 IMU-block covariance recurrence over a block of nt ticks:
//   P <- Phi_i P Phi_i^T + Qd_i, then P <- (P + P^T) / 2
//   Phi_acc <- Phi_i Phi_acc
// with each tick's diag(P)[0:3] and diag(P)[12:15] written out.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::p15_recurrence_fused (:970) ->
// _p15_recurrence_kernel (:951). Phi_i and Qd_i come precomputed from the
// batched per-tick math in filter/propagation.py::_phi_q_block.
//
// Design: one block of 256 threads per sequence, one thread per entry of
// the 15x15 (225 active). A single call is one block; the batched form
// (what pallas_call's own vmap rule makes of the TPU kernel: a leading
// grid axis) runs one block per sequence, each at its own base offsets, so
// every sequence gets the bits of a single launch. P, Phi_acc, the current
// Phi_i and the intermediate Phi_i P live in shared memory; each tick is
// four barrier-separated phases (load Phi_i; Phi_i P and Phi_i Phi_acc;
// (Phi_i P) Phi_i^T + Qd_i; symmetrize). What bounds it on the H100: at
// nt = 9 it reads and writes ~19 KB and does ~0.19 MFLOP per sequence,
// nanoseconds of work for the card; its time is the launch latency and the
// 4 x nt barriers of one SM.
#include "common.cuh"

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
p15_kernel(const T* __restrict__ P0, const T* __restrict__ Phi, const T* __restrict__ Qd,
           T* __restrict__ P_out, T* __restrict__ acc_out, T* __restrict__ sig, int nt) {
  __shared__ T P[kNN], Ph[kNN], Acc[kNN], Tm[kNN], Pn[kNN];
  const size_t sq = blockIdx.x;  // the sequence of a batched launch
  P0 += sq * kNN;
  Phi += sq * nt * kNN;
  Qd += sq * nt * kNN;
  P_out += sq * kNN;
  acc_out += sq * kNN;
  sig += sq * nt * 6;
  const int t = threadIdx.x;
  const bool act = t < kNN;
  const int i = t / kN, j = t - (t / kN) * kN;
  if (act) {
    P[t] = P0[t];
    Acc[t] = (i == j) ? T(1) : T(0);
  }
  __syncthreads();
  for (int b = 0; b < nt; ++b) {
    if (act) Ph[t] = Phi[(size_t)b * kNN + t];
    __syncthreads();
    T acc_new = T(0);
    if (act) {
      T s = T(0);
      for (int k = 0; k < kN; ++k) {
        s = s + Ph[i * kN + k] * P[k * kN + j];
        acc_new = acc_new + Ph[i * kN + k] * Acc[k * kN + j];
      }
      Tm[t] = s;
    }
    __syncthreads();
    if (act) {
      T s = T(0);
      for (int k = 0; k < kN; ++k) s = s + Tm[i * kN + k] * Ph[j * kN + k];
      Pn[t] = s + Qd[(size_t)b * kNN + t];
      Acc[t] = acc_new;  // every read of Acc happened before the barrier above
    }
    __syncthreads();
    if (act) P[t] = T(0.5) * (Pn[t] + Pn[j * kN + i]);
    __syncthreads();
    if (t < 6) {
      const int d = (t < 3) ? t : t + 9;  // rows 0:3 and 12:15
      sig[(size_t)b * 6 + t] = P[d * kN + d];
    }
  }
  if (act) {
    P_out[t] = P[t];
    acc_out[t] = Acc[t];
  }
}

template <typename T>
int launch(const void* P0, const void* Phi, const void* Qd, void* P, void* acc, void* sig,
           int nt, int B, cudaStream_t stream) {
  if (nt < 1 || B < 1) return (int)cudaErrorInvalidValue;
  p15_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(P0), static_cast<const T*>(Phi), static_cast<const T*>(Qd),
      static_cast<T*>(P), static_cast<T*>(acc), static_cast<T*>(sig), nt);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences; Phi and Qd hold nt ticks
MSCKF_EXPORT int msckf_p15_recurrence_f32(const void* P0, const void* Phi, const void* Qd,
                                          void* P, void* acc, void* sig, int nt, int B,
                                          void* stream) {
  return launch<float>(P0, Phi, Qd, P, acc, sig, nt, B, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_p15_recurrence_f64(const void* P0, const void* Phi, const void* Qd,
                                          void* P, void* acc, void* sig, int nt, int B,
                                          void* stream) {
  return launch<double>(P0, Phi, Qd, P, acc, sig, nt, B, static_cast<cudaStream_t>(stream));
}
