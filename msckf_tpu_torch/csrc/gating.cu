// Chi-square gating statistic gamma_u = r_u^T S_u^{-1} r_u for a batch of
// SPD systems S (U, n, n), r (U, n), n <= 64.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::batched_gating_gamma (:276) ->
// _gating_call (:170) -> _gating_kernel_blocked (:103).
//
// Algorithm (the TPU kernel's): right-looking Cholesky in panels of NB = 8
// columns with the forward substitution fused in, gamma = sum_j y_j^2, read
// by pivot rows; the recurrence is block_gating_gamma in common.cuh, shared
// with the fused update-terms kernel.
//
// The batched form (B sequences of U systems) is this launch over the B * U
// systems flattened, as the JAX custom_vmap rule does (pallas_kernels.py
// :258-273): each system's block runs the same code at its own offset.
//
// Design: one thread block per system. S (16 KB in f32, 32 KB in f64) lives
// in shared memory for the whole factorization; per column the block
// computes the corrected pivot row (O(n) work over the panel's earlier
// columns), then the column of L and the substitution step; once per panel
// it applies the rank-NB trailing update to the whole n x n tile. What
// bounds it on the H100: at U = 128 systems it reads 2 MB, 0.6 us at
// 3.35 TB/s, and does ~12 MFLOP; in practice it runs far above both, held
// by the 3 barriers per column of a sequential 64-column recurrence and by
// using only 128 of the card's SMs with one block each. Later work: several
// systems per block, register-tiled trailing updates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gating_kernel(const T* __restrict__ S, const T* __restrict__ r,
              T* __restrict__ gamma, int n) {
  __shared__ T A[kGateMaxN * kGateMaxN];
  __shared__ T panel[kGateNB * kGateMaxN];
  __shared__ T rowj[kGateMaxN];
  __shared__ T rr[kGateMaxN];

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const T* Su = S + (size_t)u * n * n;
  for (int e = tid; e < n * n; e += blockDim.x) A[e] = Su[e];
  for (int c = tid; c < n; c += blockDim.x) rr[c] = r[(size_t)u * n + c];
  __syncthreads();

  const T g = block_gating_gamma(A, rr, panel, rowj, n);
  if (tid == 0) gamma[u] = g;
}

template <typename T>
int launch(const void* S, const void* r, void* gamma, int U, int n,
           cudaStream_t stream) {
  if (n < 1 || n > kGateMaxN || U < 1) return (int)cudaErrorInvalidValue;
  gating_kernel<T><<<U, kThreads, 0, stream>>>(
      static_cast<const T*>(S), static_cast<const T*>(r),
      static_cast<T*>(gamma), n);
  return (int)cudaGetLastError();
}

}  // namespace

MSCKF_EXPORT int msckf_gating_f32(const void* S, const void* r, void* gamma,
                                  int U, int n, void* stream) {
  return launch<float>(S, r, gamma, U, n, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_gating_f64(const void* S, const void* r, void* gamma,
                                  int U, int n, void* stream) {
  return launch<double>(S, r, gamma, U, n, static_cast<cudaStream_t>(stream));
}
