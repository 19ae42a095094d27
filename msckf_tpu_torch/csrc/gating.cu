// Chi-square gating statistic gamma_u = r_u^T S_u^{-1} r_u for a batch of
// SPD systems S (U, n, n), r (U, n), any n >= 1.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::batched_gating_gamma (:276) ->
// _gating_call (:170) -> _gating_kernel_blocked (:103).
//
// The device code is gate.cuh's (one warp per system, S's upper triangle in
// shared memory or, where it does not fit, in a global scratch the wrapper
// allocates; the design notes are there), shared with the fused update
// terms' gate launch. The batched form (B sequences of U systems) is
// this launch over the B * U systems flattened, as the JAX custom_vmap rule
// does (pallas_kernels.py:258-273).
//
// What bounds it on the H100: at U = 128 systems of n = 64 in float32 it
// needs S's upper triangle and r, 1.1 MB, 0.33 us at 3.35 TB/s, and does
// ~12 MFLOP. It runs far above both: each
// system is a serial recurrence of 64 pivots, each a chain of shuffles, an
// rsqrt and FMAs, so its time is the latency of one warp's chain (plus,
// batched, the waves of warps an SM holds).
#include "gate.cuh"

namespace {

template <typename T>
int launch(const void* S, const void* r, void* gamma, void* scratch, int U, int n,
           cudaStream_t stream) {
  if (n < 1 || U < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_gate<T, false>(static_cast<const T*>(S), static_cast<const T*>(r),
                                    static_cast<T*>(gamma), nullptr, nullptr, nullptr,
                                    static_cast<T*>(scratch), U, n, stream);
}

template <typename T>
int scratch_elems(int n) {
  int warps = 0;
  size_t elems = 0;
  if (n < 1) return -(int)cudaErrorInvalidValue;
  const cudaError_t err = gate_plan<T>(n, &warps, &elems);
  return err == cudaSuccess ? (int)elems : -(int)err;
}

}  // namespace

// S, r, gamma, scratch (null, or U * msckf_gate_scratch(n) elements), U, n
MSCKF_EXPORT int msckf_gating_f32(const void* S, const void* r, void* gamma, void* scratch,
                                  int U, int n, void* stream) {
  return launch<float>(S, r, gamma, scratch, U, n, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_gating_f64(const void* S, const void* r, void* gamma, void* scratch,
                                  int U, int n, void* stream) {
  return launch<double>(S, r, gamma, scratch, U, n, static_cast<cudaStream_t>(stream));
}

// elements of global scratch the gate needs per system of n rows on the
// current device: 0 where its working set fits in shared memory; negative,
// minus a cudaError_t, on failure
MSCKF_EXPORT int msckf_gate_scratch_f32(int n) { return scratch_elems<float>(n); }
MSCKF_EXPORT int msckf_gate_scratch_f64(int n) { return scratch_elems<double>(n); }
