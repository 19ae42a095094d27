// Shared helpers for the port's hand-written kernels (sm_90a).
//
// Every kernel is templated on float and double and exported through a
// plain C interface (one *_f32 and one *_f64 entry point each) that takes
// device pointers, sizes and a cudaStream_t, launches on that stream and
// returns the launch's cudaError_t. The wrappers in ops/kernels.py bind
// them with ctypes, allocate every output, and raise on a nonzero return.
#pragma once

#include <cuda_runtime.h>

// the single- and double-precision math functions, by argument type
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

#define MSCKF_EXPORT extern "C" __attribute__((visibility("default")))

// Chi-square statistic gamma = r^T S^-1 r of one SPD system, n <= kGateMaxN,
// by the TPU gating kernel's recurrence: right-looking Cholesky in panels of
// kGateNB columns with the forward substitution fused in, gamma = sum_j y_j^2.
// The pivot column is read as the pivot ROW of the working matrix (S built as
// H P H^T + sigma^2 I is not bitwise symmetric, and the row is what the TPU
// kernel factors); rsqrt of a non-positive pivot poisons gamma (NaN or inf),
// so `gamma <= crit` fails the gate.
//
// Called by every thread of a block. A (n x n, row stride n) and rr (n) lie
// in shared memory and are overwritten; panel (kGateNB x kGateMaxN) and rowj
// (kGateMaxN) are shared scratch. Returns gamma on thread 0 (the value on the
// other threads is meaningless). Ends on a barrier.
constexpr int kGateMaxN = 64;
constexpr int kGateNB = 8;

template <typename T>
__device__ T block_gating_gamma(T* A, T* rr, T* panel, T* rowj, int n) {
  const int tid = threadIdx.x;
  T g = T(0);  // the running sum, kept by thread 0
  for (int k0 = 0; k0 < n; k0 += kGateNB) {
    const int w = min(kGateNB, n - k0);
    for (int j = 0; j < w; ++j) {
      const int jj = k0 + j;
      // pivot row with this panel's earlier columns applied
      for (int c = tid; c < n; c += blockDim.x) {
        T x = A[jj * n + c];
        for (int k = 0; k < j; ++k) x = x - panel[k * kGateMaxN + c] * panel[k * kGateMaxN + jj];
        rowj[c] = x;
      }
      __syncthreads();
      const T inv_sqrt_d = rsqrt_t(rowj[jj]);
      const T yj = rr[jj] * inv_sqrt_d;
      // column of L (zero above the pivot) and one substitution step;
      // rr[jj] itself is not written here, so reading it above is safe
      for (int c = tid; c < n; c += blockDim.x) {
        const T l = (c >= jj) ? rowj[c] * inv_sqrt_d : T(0);
        panel[j * kGateMaxN + c] = l;
        if (c > jj) rr[c] = rr[c] - l * yj;
      }
      if (tid == 0) g = g + yj * yj;
      __syncthreads();
    }
    // one trailing pass per panel: A -= sum_j l_j l_j^T
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int a = e / n, b = e - a * n;
      T upd = panel[a] * panel[b];
      for (int j = 1; j < w; ++j) upd = upd + panel[j * kGateMaxN + a] * panel[j * kGateMaxN + b];
      A[e] = A[e] - upd;
    }
    __syncthreads();
  }
  return g;
}
