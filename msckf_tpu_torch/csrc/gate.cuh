// The chi-square gate gamma = r^T S^-1 r of a batch of SPD systems, one warp
// per system: the device code of the gating kernel (gating.cu) and of the
// fused update terms' gate launch (update_terms.cu).
//
// Algorithm (the TPU kernel's, msckf_tpu/ops/pallas_kernels.py::
// _gating_kernel_blocked :103): right-looking Cholesky in panels of
// kGatePanel = 8 columns with the forward substitution fused in,
// gamma = sum_j y_j^2 in column order. The pivot column is read as the pivot
// ROW of the working matrix (S built as H P H^T + sigma^2 I is not bitwise
// symmetric, and the row is what the TPU kernel factors); rsqrt of a
// non-positive pivot poisons gamma (NaN or inf), so `gamma <= crit` fails.
//
// Design for the H100:
// - One warp per system, up to kGateWarps systems per block; the recurrence
//   synchronizes with __syncwarp and __shfl_sync only, never with a block
//   barrier. Lanes own columns; the pivot, r at the pivot and the panel's L
//   values are broadcast by shuffle, so the serial chain of a pivot is a few
//   shuffles, an rsqrt and two FMAs, with no shared-memory round trip. Every
//   lane accumulates gamma in column order (the same bits); lane 0 writes it.
// - Only the upper triangle of the working matrix: the recurrence reads row
//   jj from column jj rightwards and nothing else, and factored rows are
//   overwritten by rows of L^T. Updates are deferred (left-looking): a row is
//   brought up to date, panel sum by panel sum, only when its panel starts,
//   so every entry of the triangle gets the subtractions of the
//   right-looking form and no entry outside it is touched. The rows of a
//   panel start at the panel's first column (gate_base), so that an earlier
//   panel's 8 x 8 block at the current panel's columns, which every lane
//   needs, comes as 16-byte broadcast loads. Lanes otherwise read along a
//   row (consecutive columns), so no padding is needed to hit 32 distinct
//   banks. S's triangle and r are copied in by cp.async, every copy of the
//   warp in flight at once.
// - Any n >= 1. A warp's shared memory is the triangle and r, 9.5 KB at
//   n = 64 in f32 (19.0 KB in f64). The block holds as many systems (1 to 4)
//   as the device's opt-in takes; where one system does not fit (f64
//   n >= 237, f32 n >= 333 on the H100's 232,448 bytes), both live in a
//   global scratch that the wrapper allocates (gate_plan), and the same
//   code runs on it.
// - Each system's arithmetic depends on n alone, never on its warp, block
//   or batch position, so a batched launch equals B single launches bitwise.
#pragma once

#include <algorithm>

#include "common.cuh"

// internal linkage: each source that includes this header has its own
// kernels and opt-in records
namespace {

constexpr int kGatePanel = 8;  // columns per panel (the TPU kernel's nb)
constexpr int kGateWarps = 4;  // systems per block, at most

// The working triangle's layout: the rows of panel P = a / 8 hold columns
// [8P, n4) (n4 = n rounded up to 4), so every row starts on 16 bytes and an
// earlier panel's 8 x 8 block at a later panel's columns is two (f32) or
// four (f64) 16-byte words. Entry (a, b), b >= 8P, lies at gate_base(a) + b.
__host__ __device__ inline int gate_base(int a, int n4) {
  const int P = a >> 3;
  return 8 * P * n4 - 32 * P * (P - 1) + (a - 8 * P) * (n4 - 8 * P) - 8 * P;
}

// elements of the triangle (whole panels, plus one panel's width of slack
// for the block loads of a last, narrower panel) and of one system's
// working set (the triangle and r)
__host__ __device__ inline int gate_tri(int n) {
  const int n4 = (n + 3) & ~3, np = (n + 7) / 8;
  return 8 * np * n4 - 32 * np * (np - 1) + 8;
}
__host__ __device__ inline int gate_elems(int n) { return gate_tri(n) + ((n + 3) & ~3); }

// One panel of warp_gate_gamma: rows k0..k0+w-1. WC = kGatePanel for a
// full panel (w known at compile time, so that the panel's loops carry no
// branches), 0 for the last, narrower one (w = wd).
template <typename T, int WC>
__device__ __forceinline__ void gate_panel(T* A, T* rr, int n, int n4, int k0, int wd, T& g) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int w = WC ? WC : wd;
  T inv[kGatePanel], y[kGatePanel], lb[kGatePanel][kGatePanel];
  for (int c0 = k0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < n;
    // the panel's rows at column c (row k0 + j is read from column k0 + j)
    T x[kGatePanel];
#pragma unroll
    for (int j = 0; j < kGatePanel; ++j)
      x[j] = (j < w && live && c >= k0 + j) ? A[gate_base(k0 + j, n4) + c] : T(0);
    // minus each earlier panel's sum, one panel at a time: its rows at
    // column c, and its 8 x 8 block at this panel's columns (broadcasts)
    for (int q0 = 0; q0 < k0; q0 += kGatePanel) {
      T upd[kGatePanel];
#pragma unroll
      for (int i = 0; i < kGatePanel; ++i) {
        const int base = gate_base(q0 + i, n4);
        const T lci = live ? A[base + c] : T(0);
        T b[kGatePanel];
#pragma unroll
        for (int v = 0; v < kGatePanel; v += V) {
          const V16<T> t = *reinterpret_cast<const V16<T>*>(A + base + k0 + v);
#pragma unroll
          for (int e = 0; e < V; ++e) b[v + e] = t.v[e];
        }
#pragma unroll
        for (int j = 0; j < kGatePanel; ++j)
          if (j < w) upd[j] = i == 0 ? b[j] * lci : upd[j] + b[j] * lci;
      }
#pragma unroll
      for (int j = 0; j < kGatePanel; ++j)
        if (j < w) x[j] = x[j] - upd[j];
    }
    T rc = live ? rr[c] : T(0);
    if (c0 == k0) {
      // the panel's pivots: lane j holds the pivot row's entry at column
      // k0 + j; every lane takes the same pivot by shuffle
#pragma unroll
      for (int j = 0; j < kGatePanel; ++j) {
        if (j < w) {
          inv[j] = rsqrt_t(__shfl_sync(kAll, x[j], j));
          y[j] = __shfl_sync(kAll, rc, j) * inv[j];
          const T l = x[j] * inv[j];
          x[j] = l;
          if (lane > j) rc = rc - l * y[j];
#pragma unroll
          for (int jp = j + 1; jp < kGatePanel; ++jp) {
            if (jp < w) {
              lb[j][jp] = __shfl_sync(kAll, l, jp);
              x[jp] = x[jp] - l * lb[j][jp];
            }
          }
          g = g + y[j] * y[j];
        }
      }
    } else {
      // the same steps from the warp-uniform values the pivots left
#pragma unroll
      for (int j = 0; j < kGatePanel; ++j) {
        if (j < w) {
          const T l = x[j] * inv[j];
          x[j] = l;
          rc = rc - l * y[j];
#pragma unroll
          for (int jp = j + 1; jp < kGatePanel; ++jp)
            if (jp < w) x[jp] = x[jp] - l * lb[j][jp];
        }
      }
    }
    // the panel's rows of L^T past the diagonal, and r, back
#pragma unroll
    for (int j = 0; j < kGatePanel; ++j)
      if (j < w && live && c > k0 + j) A[gate_base(k0 + j, n4) + c] = x[j];
    if (live) rr[c] = rc;
  }
}

// gamma of one system, by one warp. A: the triangle (gate_base) holding S's
// upper triangle, whose row i is overwritten by row i of L^T once its panel
// is factored; rr: r (overwritten). Both are private to the warp. Returns
// gamma on every lane.
//
// Left-looking by panels, in the right-looking recurrence's order: the
// panel's rows k0..k0+w-1 are brought up to date when the panel starts, by
// subtracting each earlier panel's sum sum_j l_j[a] l_j[b] in turn (the
// TPU kernel subtracts the same sums from the whole trailing matrix at the
// end of each panel). Lanes own columns c = strip + lane over strips of 32
// from k0; a lane keeps the panel's w rows at its column in registers. The
// first strip holds the panel's own w columns: there the w pivots run with
// shuffles alone (the pivot, r at the pivot, and the pivot row's L values
// for the panel's later rows), and every other strip then replays the
// pivots from the warp-uniform values they left (1/sqrt(d), y and the
// panel's block of L).
template <typename T>
__device__ T warp_gate_gamma(T* A, T* rr, int n) {
  const int n4 = (n + 3) & ~3;
  T g = T(0);
  for (int k0 = 0; k0 < n; k0 += kGatePanel) {
    if (n - k0 >= kGatePanel)
      gate_panel<T, kGatePanel>(A, rr, n, n4, k0, kGatePanel, g);
    else
      gate_panel<T, 0>(A, rr, n, n4, k0, n - k0, g);
    __syncwarp();
  }
  return g;
}

// one element from global to shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T))
               : "memory");
}

// One warp per system s < nsys: S (nsys, n, n) row-major (only the upper
// triangle is read), r (nsys, n). kPass: passed[s] = sel_ok[s] && gamma <=
// crit[s] (a NaN fails); else gamma[s]. kGlobal: the working sets lie in
// scratch (nsys * gate_elems(n) elements of global memory), else in shared
// memory (a separate instance, so that the compiler sees shared accesses),
// filled by cp.async: every copy of the warp in flight at once.
template <typename T, bool kPass, bool kGlobal>
__global__ void __launch_bounds__(32 * kGateWarps)
gate_kernel(const T* __restrict__ S, const T* __restrict__ r, T* __restrict__ gamma,
            const T* __restrict__ crit, const unsigned char* __restrict__ sel_ok,
            unsigned char* __restrict__ passed, T* __restrict__ scratch, int nsys, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const size_t s = (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= (size_t)nsys) return;
  const int n4 = (n + 3) & ~3;
  T* A = kGlobal ? scratch + s * gate_elems(n)
                 : reinterpret_cast<T*>(smem_raw) + (threadIdx.x >> 5) * gate_elems(n);
  T* rr = A + gate_tri(n);

  // S's upper triangle and r
  const T* Ss = S + s * n * n;
  for (int a = 0; a < n; ++a) {
    const int base = gate_base(a, n4);
    for (int c = a + lane; c < n; c += 32) {
      if constexpr (kGlobal)
        A[base + c] = Ss[(size_t)a * n + c];
      else
        cp_async_elem(A + base + c, Ss + (size_t)a * n + c);
    }
  }
  for (int c = lane; c < n; c += 32) {
    if constexpr (kGlobal)
      rr[c] = r[s * n + c];
    else
      cp_async_elem(rr + c, r + s * n + c);
  }
  if constexpr (!kGlobal) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const T g = warp_gate_gamma(A, rr, n);
  if (lane == 0) {
    if constexpr (kPass)
      passed[s] = (sel_ok[s] && g <= crit[s]) ? 1 : 0;
    else
      gamma[s] = g;
  }
}

// Where a system's working set goes: in shared memory (*scratch_elems = 0,
// *warps systems per block) or, where one does not fit the device's opt-in,
// in a global scratch of *scratch_elems per system (kGateWarps per block).
template <typename T>
cudaError_t gate_plan(int n, int* warps, size_t* scratch_elems) {
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const size_t bytes = gate_elems(n) * sizeof(T);
  if (bytes <= optin) {
    *warps = (int)std::min((size_t)kGateWarps, optin / bytes);
    *scratch_elems = 0;
  } else {
    *warps = kGateWarps;
    *scratch_elems = gate_elems(n);
  }
  return cudaSuccess;
}

// Launches gate_kernel over nsys systems on the stream; scratch must hold
// nsys * the plan's scratch_elems elements where the plan asks for one.
template <typename T, bool kPass>
cudaError_t launch_gate(const T* S, const T* r, T* gamma, const T* crit,
                        const unsigned char* sel_ok, unsigned char* passed, T* scratch,
                        int nsys, int n, cudaStream_t stream) {
  static OptIn opt;
  int warps = 0;
  size_t scratch_elems = 0;
  cudaError_t err = gate_plan<T>(n, &warps, &scratch_elems);
  if (err != cudaSuccess) return err;
  const int blocks = (nsys + warps - 1) / warps;
  if (scratch_elems > 0) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    gate_kernel<T, kPass, true><<<blocks, 32 * warps, 0, stream>>>(
        S, r, gamma, crit, sel_ok, passed, scratch, nsys, n);
  } else {
    const size_t smem = warps * gate_elems(n) * sizeof(T);
    err = opt.ensure((const void*)gate_kernel<T, kPass, false>, smem);
    if (err != cudaSuccess) return err;
    gate_kernel<T, kPass, false><<<blocks, 32 * warps, smem, stream>>>(
        S, r, gamma, crit, sel_ok, passed, nullptr, nsys, n);
  }
  return cudaGetLastError();
}

}  // namespace
