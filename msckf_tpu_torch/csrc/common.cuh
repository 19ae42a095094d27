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
