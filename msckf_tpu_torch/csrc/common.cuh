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

// 16 bytes of T, and a pair, for vector loads and stores
template <typename T>
struct alignas(16) V16 {
  T v[16 / sizeof(T)];
};
template <typename T>
struct alignas(2 * sizeof(T)) V2 {
  T v[2];
};

// cp.async of N bytes (4, 8 or 16) from global to shared memory; 16-byte
// copies bypass L1
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(N)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 16-byte load
template <typename T>
__device__ __forceinline__ V16<T> ld16(const T* p) {
  return *reinterpret_cast<const V16<T>*>(p);
}

constexpr int kMaxDevices = 64;

// The dynamic-shared-memory opt-in of the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes, asked once per device
inline cudaError_t smem_optin(size_t* bytes) {
  static int cached[kMaxDevices] = {};
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *bytes = (size_t)cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = v;
  *bytes = (size_t)v;
  return err;
}

// The dynamic-shared-memory opt-in of one kernel, made once per device and
// raised only when a call needs more than the last one set
struct OptIn {
  size_t bytes[kMaxDevices] = {};
  cudaError_t ensure(const void* fn, size_t need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices && need <= bytes[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err == cudaSuccess && dev < kMaxDevices) bytes[dev] = need;
    return err;
  }
};
