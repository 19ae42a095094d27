// Fused EKF update terms over the whole update batch: the nullspace
// projector applied to r and H, the innovation covariance S, the chi-square
// gate by in-kernel Cholesky, and the masked information accumulation
// A = sum H~^T H~, c = sum H~^T r~ over the tracks that pass.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::update_terms_fused (:560) ->
// _update_terms_call (:464) -> _update_terms_kernel (:303).
//
// Per track u (H (2M, D), Hf (2M, 3), r (2M)), the TPU kernel's arithmetic:
// W = (Hf^T Hf / s + eps I)^-1 / s by the closed-form adjugate with its
// floors s >= 1e-20 and |det| >= 1e-38; r~ = r - Hf W Hf^T r;
// H~ = H - Hf W Hf^T H; S = H~ P H~^T + sigma^2 I with the full D x D P;
// gamma = r~^T S^-1 r~ by block_gating_gamma (common.cuh, the gating
// kernel's pivot-row Cholesky); passed = sel_ok & (gamma <= crit), where a
// NaN crit or gamma fails. Rows of a rejected track are selected out (not
// multiplied by 0), so an inf row adds exact zeros to A and c.
//
// Design, two launches counted as one call, each over a grid with a second
// axis of B sequences: the batched form (the JAX custom_vmap rule's
// (B, tiles) grid, pallas_kernels.py:544-558) is blockIdx.y, a single call
// is B = 1, and each sequence reads and writes at its own base offsets and
// sums in the same fixed order, so a batched launch gives each sequence
// the bits of a single launch:
//   1. update_track_kernel, one block per track. H~ is formed in shared
//      memory and written to a global scratch (U, 2M, D) with r~; S is built
//      in row panels of kPanel rows (H~[panel] P, then against all of H~), so H~,
//      S and one panel of H~ P fit in shared memory (168 KB in f64 at
//      2M = 64, D = 192: the dynamic-shared-memory opt-in). Then the gate.
//   2. update_accumulate_kernel: one block per 32 x 32 tile of A and one per
//      32 entries of c; each sums over all U * 2M rows of the scratch in row
//      order, masked by passed. No atomics: repeated runs give the same bits.
// The filter calls it over the camera span (D = 6N = 192 at the reference
// capacities; the IMU columns of H are zero). What bounds it on the H100
// there, with U = 128, 2M = 64: ~1.04 GFLOP (H~ P per track, the symmetric
// S per track and the symmetric A over 8192 rows) against ~13 MB moved in
// f64: operations, ~0.016 ms at 67 TFLOP/s (f32 outside the tensor cores,
// f64 on them). This first design runs on scalar FMAs with one block per
// track (launch 1) and 42 blocks (launch 2), far from that; later work:
// tensor-core tiles (DMMA in f64), more blocks per track, a split-K
// accumulation, and only one triangle of S and A.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 16;  // rows of S built per pass
constexpr int kTile = 32;   // edge of an A tile in launch 2

// Row stride of H~ in shared memory: odd, so that the S loop's threads,
// which read one column of consecutive rows, hit distinct banks (at
// D = 192 = 6 * 32 a stride of D puts a whole warp on one bank)
__host__ __device__ inline int h_stride(int D) { return D | 1; }

__host__ __device__ inline size_t track_smem_elems(int R2, int D) {
  return (size_t)R2 * h_stride(D)  // H, then H~
         + (size_t)R2 * 3      // Hf
         + R2                  // r, then r~
         + kGateMaxN           // the gate's working copy of r~
         + 3 * (size_t)D       // C = W Hf^T H
         + (size_t)kPanel * D  // one panel of H~ P
         + (size_t)R2 * R2     // S
         + kGateNB * kGateMaxN + kGateMaxN  // the gate's panel and pivot row
         + 16;                 // 9 sums, 6 entries of W
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_track_kernel(const T* __restrict__ H, const T* __restrict__ Hf,
                    const T* __restrict__ r, const T* __restrict__ P,
                    const T* __restrict__ crit, const unsigned char* __restrict__ sel_ok,
                    T sigma2, T eps, T* __restrict__ Ht, T* __restrict__ rt,
                    unsigned char* __restrict__ passed, int U, int R2, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Hs = reinterpret_cast<T*>(smem_raw);
  const int ld = h_stride(D);
  T* Hfs = Hs + (size_t)R2 * ld;
  T* rs = Hfs + R2 * 3;
  T* rr = rs + R2;
  T* C = rr + kGateMaxN;
  T* HP = C + 3 * (size_t)D;
  T* S = HP + (size_t)kPanel * D;
  T* panel = S + R2 * R2;
  T* rowj = panel + kGateNB * kGateMaxN;
  T* sums = rowj + kGateMaxN;

  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  H += sq * U * R2 * D;
  Hf += sq * U * R2 * 3;
  r += sq * U * R2;
  P += sq * D * D;
  crit += sq * U;
  sel_ok += sq * U;
  Ht += sq * U * R2 * D;
  rt += sq * U * R2;
  passed += sq * U;
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t hoff = (size_t)u * R2 * D;
  for (int e = tid; e < R2 * D; e += blockDim.x) Hs[(e / D) * ld + e % D] = H[hoff + e];
  for (int e = tid; e < R2 * 3; e += blockDim.x) Hfs[e] = Hf[(size_t)u * R2 * 3 + e];
  for (int e = tid; e < R2; e += blockDim.x) rs[e] = r[(size_t)u * R2 + e];
  __syncthreads();

  // Hf^T Hf (6 entries) and Hf^T r (3), one thread each, rows in order
  if (tid < 9) {
    const int gi[6] = {0, 0, 0, 1, 1, 2};
    const int gj[6] = {0, 1, 2, 1, 2, 2};
    T acc = T(0);
    if (tid < 6) {
      for (int q = 0; q < R2; ++q) acc = acc + Hfs[q * 3 + gi[tid]] * Hfs[q * 3 + gj[tid]];
    } else {
      for (int q = 0; q < R2; ++q) acc = acc + Hfs[q * 3 + tid - 6] * rs[q];
    }
    sums[tid] = acc;
  }
  __syncthreads();
  if (tid == 0) {
    const T g00 = sums[0], g01 = sums[1], g02 = sums[2];
    const T g11 = sums[3], g12 = sums[4], g22 = sums[5];
    T scale = (g00 + g11 + g22) / T(3);
    scale = (scale < T(1e-20)) ? T(1e-20) : scale;
    const T a = g00 / scale + eps, b = g01 / scale, c = g02 / scale;
    const T d = g11 / scale + eps, e = g12 / scale, f = g22 / scale + eps;
    const T co00 = d * f - e * e;
    const T co01 = c * e - b * f;
    const T co02 = b * e - c * d;
    const T co11 = a * f - c * c;
    const T co12 = c * b - a * e;
    const T co22 = a * d - b * b;
    T det = a * co00 + b * co01 + c * co02;
    det = (abs_t(det) < T(1e-38)) ? T(1e-38) : det;
    const T inv_det = T(1) / (det * scale);
    sums[9] = co00 * inv_det;
    sums[10] = co01 * inv_det;
    sums[11] = co02 * inv_det;
    sums[12] = co11 * inv_det;
    sums[13] = co12 * inv_det;
    sums[14] = co22 * inv_det;
  }
  __syncthreads();
  const T W00 = sums[9], W01 = sums[10], W02 = sums[11];
  const T W11 = sums[12], W12 = sums[13], W22 = sums[14];

  // C = W (Hf^T H), one column per thread
  for (int d = tid; d < D; d += blockDim.x) {
    T B0 = T(0), B1 = T(0), B2 = T(0);
    for (int q = 0; q < R2; ++q) {
      const T h = Hs[q * ld + d];
      B0 = B0 + Hfs[q * 3] * h;
      B1 = B1 + Hfs[q * 3 + 1] * h;
      B2 = B2 + Hfs[q * 3 + 2] * h;
    }
    C[d] = W00 * B0 + W01 * B1 + W02 * B2;
    C[D + d] = W01 * B0 + W11 * B1 + W12 * B2;
    C[2 * D + d] = W02 * B0 + W12 * B1 + W22 * B2;
  }
  // r~ = r - Hf W (Hf^T r)
  if (tid < R2) {
    const T t0 = sums[6], t1 = sums[7], t2 = sums[8];
    const T w0 = W00 * t0 + W01 * t1 + W02 * t2;
    const T w1 = W01 * t0 + W11 * t1 + W12 * t2;
    const T w2 = W02 * t0 + W12 * t1 + W22 * t2;
    const T v = rs[tid] - (Hfs[tid * 3] * w0 + Hfs[tid * 3 + 1] * w1 + Hfs[tid * 3 + 2] * w2);
    rs[tid] = v;
    rr[tid] = v;
    rt[(size_t)u * R2 + tid] = v;
  }
  __syncthreads();
  // H~ = H - Hf C, in place, and out to the scratch
  for (int e = tid; e < R2 * D; e += blockDim.x) {
    const int q = e / D, d = e - q * D;
    const T v = Hs[q * ld + d] - (Hfs[q * 3] * C[d] + Hfs[q * 3 + 1] * C[D + d] +
                                  Hfs[q * 3 + 2] * C[2 * D + d]);
    Hs[q * ld + d] = v;
    Ht[hoff + e] = v;
  }
  __syncthreads();

  // S = H~ P H~^T + sigma^2 I, kPanel rows at a time
  for (int p0 = 0; p0 < R2; p0 += kPanel) {
    const int np = min(kPanel, R2 - p0);
    // HP = H~[p0 : p0 + np] P: one column per thread, the rows in registers
    for (int d = tid; d < D; d += blockDim.x) {
      T acc[kPanel];
#pragma unroll
      for (int i = 0; i < kPanel; ++i) acc[i] = T(0);
      for (int e = 0; e < D; ++e) {
        const T pe = P[(size_t)e * D + d];
#pragma unroll
        for (int i = 0; i < kPanel; ++i)
          if (i < np) acc[i] = acc[i] + Hs[(p0 + i) * ld + e] * pe;
      }
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
        if (i < np) HP[i * D + d] = acc[i];
    }
    __syncthreads();
    for (int e = tid; e < np * R2; e += blockDim.x) {
      const int i = e / R2, j = e - i * R2;
      T acc = T(0);
      for (int d = 0; d < D; ++d) acc = acc + HP[i * D + d] * Hs[j * ld + d];
      if (p0 + i == j) acc = acc + sigma2;
      S[(p0 + i) * R2 + j] = acc;
    }
    __syncthreads();
  }

  const T gamma = block_gating_gamma(S, rr, panel, rowj, R2);
  if (tid == 0) passed[u] = (sel_ok[u] && gamma <= crit[u]) ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_accumulate_kernel(const T* __restrict__ Ht, const T* __restrict__ rt,
                         const unsigned char* __restrict__ passed, T* __restrict__ A,
                         T* __restrict__ c, int U, int R2, int D) {
  __shared__ T sa[kTile][kTile + 1];
  __shared__ T sb[kTile][kTile + 1];
  constexpr int kRows = kThreads / kTile;  // 8 thread rows of 32
  const int nt = (D + kTile - 1) / kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int rows = U * R2;
  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  Ht += sq * rows * D;
  rt += sq * rows;
  passed += sq * U;
  A += sq * D * D;
  c += sq * D;

  if (blockIdx.x < nt * nt) {
    // A[a0 : a0 + 32, b0 : b0 + 32]; thread (tx, ty) holds rows ty + 8k
    const int a0 = (blockIdx.x / nt) * kTile, b0 = (blockIdx.x % nt) * kTile;
    T acc[kTile / kRows];
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k) acc[k] = T(0);
    for (int q0 = 0; q0 < rows; q0 += kTile) {
      for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
        const int i = e / kTile, j = e - i * kTile, q = q0 + i;
        const bool live = q < rows && passed[q / R2];
        sa[i][j] = (live && a0 + j < D) ? Ht[(size_t)q * D + a0 + j] : T(0);
        sb[i][j] = (live && b0 + j < D) ? Ht[(size_t)q * D + b0 + j] : T(0);
      }
      __syncthreads();
      for (int i = 0; i < kTile; ++i) {
        const T bv = sb[i][tx];
#pragma unroll
        for (int k = 0; k < kTile / kRows; ++k) acc[k] = acc[k] + sa[i][ty + kRows * k] * bv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k) {
      const int a = a0 + ty + kRows * k, b = b0 + tx;
      if (a < D && b < D) A[(size_t)a * D + b] = acc[k];
    }
  } else {
    // c[c0 : c0 + 32]: each thread row sums every 8th row, then the 8
    // partial sums are added in a fixed order
    const int col = (blockIdx.x - nt * nt) * kTile + tx;
    T acc = T(0);
    if (col < D) {
      for (int q = ty; q < rows; q += kRows) {
        const T v = Ht[(size_t)q * D + col] * rt[q];
        acc = acc + (passed[q / R2] ? v : T(0));
      }
    }
    sa[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && col < D) {
      T s = sa[0][tx];
      for (int k = 1; k < kRows; ++k) s = s + sa[k][tx];
      c[col] = s;
    }
  }
}

template <typename T>
int launch(const void* H, const void* Hf, const void* r, const void* P, const void* crit,
           const void* sel_ok, void* Ht, void* rt, void* A, void* c, void* passed,
           int U, int R2, int D, int B, double sigma2, double eps, cudaStream_t stream) {
  if (U < 1 || R2 < 1 || R2 > kGateMaxN || D < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = track_smem_elems(R2, D) * sizeof(T);
  // the shared-memory opt-in, made once per device and raised only when a
  // call needs more than the last one set
  constexpr int kMaxDevices = 64;
  static size_t smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute((const void*)update_track_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) smem_set[dev] = smem;
  }
  update_track_kernel<T><<<dim3(U, B), kThreads, smem, stream>>>(
      static_cast<const T*>(H), static_cast<const T*>(Hf), static_cast<const T*>(r),
      static_cast<const T*>(P), static_cast<const T*>(crit),
      static_cast<const unsigned char*>(sel_ok), T(sigma2), T(eps), static_cast<T*>(Ht),
      static_cast<T*>(rt), static_cast<unsigned char*>(passed), U, R2, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (D + kTile - 1) / kTile;
  update_accumulate_kernel<T><<<dim3(nt * nt + nt, B), kThreads, 0, stream>>>(
      static_cast<const T*>(Ht), static_cast<const T*>(rt),
      static_cast<const unsigned char*>(passed), static_cast<T*>(A), static_cast<T*>(c),
      U, R2, D);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences (Ht and rt, the
// per-track scratch, too)
MSCKF_EXPORT int msckf_update_terms_f32(const void* H, const void* Hf, const void* r,
                                        const void* P, const void* crit, const void* sel_ok,
                                        void* Ht, void* rt, void* A, void* c, void* passed,
                                        int U, int R2, int D, int B, double sigma2,
                                        double eps, void* stream) {
  return launch<float>(H, Hf, r, P, crit, sel_ok, Ht, rt, A, c, passed, U, R2, D, B, sigma2,
                       eps, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_update_terms_f64(const void* H, const void* Hf, const void* r,
                                        const void* P, const void* crit, const void* sel_ok,
                                        void* Ht, void* rt, void* A, void* c, void* passed,
                                        int U, int R2, int D, int B, double sigma2,
                                        double eps, void* stream) {
  return launch<double>(H, Hf, r, P, crit, sel_ok, Ht, rt, A, c, passed, U, R2, D, B, sigma2,
                        eps, static_cast<cudaStream_t>(stream));
}
