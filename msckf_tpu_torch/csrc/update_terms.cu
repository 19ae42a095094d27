// Fused EKF update terms over the whole update batch: the nullspace
// projector applied to r and H, the innovation covariance S, the chi-square
// gate by Cholesky, and the masked information accumulation
// A = sum H~^T H~, c = sum H~^T r~ over the tracks that pass.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::update_terms_fused (:560) ->
// _update_terms_call (:464) -> _update_terms_kernel (:303).
//
// Per track u (H (2M, D), Hf (2M, 3), r (2M)), the TPU kernel's arithmetic:
// W = (Hf^T Hf / s + eps I)^-1 / s by the closed-form adjugate with its
// floors s >= 1e-20 and |det| >= 1e-38; r~ = r - Hf W Hf^T r;
// H~ = H - Hf W Hf^T H; S = H~ P H~^T + sigma^2 I with the full D x D P;
// gamma = r~^T S^-1 r~ by gate.cuh's pivot-row Cholesky (the gating
// kernel's); passed = sel_ok & (gamma <= crit), where a NaN crit or gamma
// fails. Rows of a rejected track are skipped (never multiplied by 0), so
// an inf row adds exact zeros to A and c.
//
// What bounds it on the H100 at the filter's shapes (U = 128 tracks,
// 2M = 64 rows, D = 6N = 192 camera columns): ~1.04 GFLOP (H~ P per track,
// the symmetric S per track and the symmetric A over 8192 rows) against
// ~13 MB moved in f64: operations, 0.0156 ms in f32 at 67 TFLOP/s.
//
// Design: four launches counted as one call, any 2M >= 1 and D >= 1, each
// over a grid whose second axis is the B sequences of a batched call
// (blockIdx.y; a single call is B = 1; the gate flattens B * U tracks).
// Each sequence reads and writes at its own offsets and sums in a fixed
// order that depends on U, 2M and D only, so a batched launch gives each
// sequence the bits of its single launch, and repeated calls the same bits.
//   1. The per-track terms, in one of two forms chosen by shape
//      (fast_track_path): the fast form while 2M <= 64 and its working set
//      fits the device's shared-memory opt-in, else the general form.
//      Fast: update_track_kernel, one block of 256 threads per track. H is
//      copied into shared memory with cp.async (16-byte copies when D is a
//      multiple of 16 bytes) while the block reads Hf and r; the projector
//      forms H~ in place and writes H~ and r~ to a scratch (16-byte stores
//      where the row length allows). H~P is built in column panels of 96:
//      P streams through two shared-memory stages of 16 rows x 96 columns,
//      filled by cp.async one stage ahead of the arithmetic, so every
//      element of P is read from L2 once per track. Each thread holds a
//      4 x 6 register tile of the panel and a 4 x 4 tile of S (both
//      triangles computed; the upper one written). H~'s row stride is an odd
//      number of 16-byte words, so the 8 rows read in one phase of a 16-byte
//      load hit 8 distinct bank groups. Shared memory at D = 192: 90,432
//      bytes in f32 (two blocks per SM), 179,840 in f64 (one); the fast form
//      holds D <= 672 in f32 and D <= 288 in f64 on the H100.
//      General: update_project_kernel (the projector, one block per track,
//      H read from L2), then update_s_kernel (S by 64 x 64 tiles on and
//      above the diagonal, one block per track and tile, H~ and P streamed
//      through shared memory in 32-deep chunks).
//      Both write S + sigma^2 I's upper triangle to a (B, U, 2M, 2M) scratch.
//   2. gate_kernel (gate.cuh): one warp per track over that scratch and r~,
//      writing passed. The gate is the gating kernel's code, so the
//      recurrence exists once.
//   3. update_partial_kernel, a split over rows of the lower triangle of A:
//      the U tracks are cut into chunks of whole tracks (the wrapper's plan,
//      ops/kernels.py::update_chunk_plan: 8 tracks = 512 rows at 2M = 64,
//      the TPU kernel's own tile), and one block computes one 64 x 64 tile
//      of A's lower triangle for one chunk: 6 tiles x 16 chunks = 96 blocks
//      at the filter's shapes, 3,072 at B = 32. The chunk's gate decisions
//      are one warp ballot; only the rows of passed tracks are staged, in
//      units of 32 rows, double-buffered by cp.async. Each thread holds a
//      4 x 4 register tile, 16 FMAs per two 16-byte loads. The diagonal
//      tiles also stage r~ and sum the chunk's part of c. The partials go to
//      a (B, chunks, D, D) and a (B, chunks, D) scratch that the wrapper
//      allocates. Shared memory: 34,048 bytes in f32, 68,096 in f64.
//   4. update_reduce_kernel sums the partials in chunk order, one thread per
//      entry of A (read from the lower triangle, so A is bitwise symmetric)
//      and of c. No atomics anywhere.
// f32 runs on the FMA units (no TF32), f64 on DFMA. What still holds it
// back: no tensor cores (DMMA in f64 is later work), and the gate's serial
// pivots (64 per track at the filter's shapes).
#include <climits>

#include "gate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;         // rows of H~ a fast track block holds (2M padded)
constexpr int kCols = 96;         // columns of one panel of H~ P
constexpr int kK = 16;            // rows of P per stage
constexpr int kTile = 64;         // edge of an A tile in launch 2
constexpr int kUnit = 32;         // rows per stage in launch 2
constexpr int kMaxChunkTracks = 32;  // a chunk's decisions are one warp ballot

// Starts the copy of a rows x cols block of a row-major global matrix (row
// stride lds) into shared memory (row stride ldd): entries with row <
// rows_valid and col < cols_valid by cp.async, the others set to zero. cols
// and ldd are multiples of V; with vec (D a multiple of V, so that every row
// starts on 16 bytes) each copy moves 16 bytes, else one element.
template <typename T>
__device__ void load_async(T* dst, int ldd, const T* src, size_t lds, int rows, int rows_valid,
                           int cols, int cols_valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int nv = cols / V;
    for (int e = threadIdx.x; e < rows * nv; e += blockDim.x) {
      const int i = e / nv, j = (e - i * nv) * V;
      T* d = dst + i * ldd + j;
      if (i < rows_valid && j < cols_valid)
        cp_async<16>(d, src + i * lds + j);
      else
        *reinterpret_cast<V16<T>*>(d) = V16<T>{};
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int i = e / cols, j = e - i * cols;
      T* d = dst + i * ldd + j;
      if (i < rows_valid && j < cols_valid)
        cp_async<sizeof(T)>(d, src + i * lds + j);
      else
        *d = T(0);
    }
  }
}

// ---------------------------------------------------------------------------
// launch 1: per-track projector, H~ P and S (the fast form, 2M <= kRows)
// ---------------------------------------------------------------------------

__host__ __device__ inline int n_panels(int D) { return (D + kCols - 1) / kCols; }

// Row stride of H~ in shared memory: the panels' columns plus one 16-byte
// word, an odd number of 16-byte words (n_panels * kCols is a multiple of
// 32 elements in f32 and of 16 in f64)
template <typename T>
__host__ __device__ inline int h_stride(int D) {
  return n_panels(D) * kCols + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ inline size_t track_smem_elems(int D) {
  return (size_t)kRows * h_stride<T>(D)  // H, then H~ (rows past 2M zero)
         + (size_t)kRows * kCols         // one panel of H~ P
         + 2 * kK * kCols                // two stages of P
         + kRows * 3 + kRows             // Hf; r, then r~
         + 3 * (size_t)D                 // C = W Hf^T H
         + 16;                           // 9 sums, 6 entries of W
}

// The projector's weights, by every thread of the block: the sums Hf^T Hf
// (6) and Hf^T r (3), one thread each over the rows in order, then
// W = (Hf^T Hf / s + eps I)^-1 / s by the closed-form adjugate with the TPU
// kernel's floors. Hfs (R2 x 3) and rs (R2) lie in shared memory; sums (16,
// shared) holds Hf^T r in [6, 9) and W's six entries in [9, 15) on return.
// Ends on a barrier.
template <typename T>
__device__ void projector_weights(const T* Hfs, const T* rs, T* sums, int R2, T eps) {
  const int tid = threadIdx.x;
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
}

// r~ = r - Hf W (Hf^T r) for row q, from projector_weights' sums
template <typename T>
__device__ __forceinline__ T project_r(const T* Hfs, const T* rs, const T* sums, int q) {
  const T W00 = sums[9], W01 = sums[10], W02 = sums[11];
  const T W11 = sums[12], W12 = sums[13], W22 = sums[14];
  const T t0 = sums[6], t1 = sums[7], t2 = sums[8];
  const T w0 = W00 * t0 + W01 * t1 + W02 * t2;
  const T w1 = W01 * t0 + W11 * t1 + W12 * t2;
  const T w2 = W02 * t0 + W12 * t1 + W22 * t2;
  return rs[q] - (Hfs[q * 3] * w0 + Hfs[q * 3 + 1] * w1 + Hfs[q * 3 + 2] * w2);
}

// C[:, d] = W (Hf^T H[:, d]) for every column d, one column per thread;
// h(q, d) reads H
template <typename T, typename HAt>
__device__ void projector_c(const T* Hfs, const T* sums, T* C, int R2, int D, HAt h) {
  const T W00 = sums[9], W01 = sums[10], W02 = sums[11];
  const T W11 = sums[12], W12 = sums[13], W22 = sums[14];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    T B0 = T(0), B1 = T(0), B2 = T(0);
    for (int q = 0; q < R2; ++q) {
      const T x = h(q, d);
      B0 = B0 + Hfs[q * 3] * x;
      B1 = B1 + Hfs[q * 3 + 1] * x;
      B2 = B2 + Hfs[q * 3 + 2] * x;
    }
    C[d] = W00 * B0 + W01 * B1 + W02 * B2;
    C[D + d] = W01 * B0 + W11 * B1 + W12 * B2;
    C[2 * D + d] = W02 * B0 + W12 * B1 + W22 * B2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
update_track_kernel(const T* __restrict__ H, const T* __restrict__ Hf,
                    const T* __restrict__ r, const T* __restrict__ P, T sigma2, T eps,
                    T* __restrict__ Ht, T* __restrict__ rt, T* __restrict__ Ss, int U, int R2,
                    int D) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = h_stride<T>(D);
  const int dp = n_panels(D) * kCols;
  T* Hs = reinterpret_cast<T*>(smem_raw);
  T* HP = Hs + (size_t)kRows * ldh;
  T* Ps = HP + kRows * kCols;
  T* Hfs = Ps + 2 * kK * kCols;
  T* rs = Hfs + kRows * 3;
  T* C = rs + kRows;
  T* sums = C + 3 * (size_t)D;

  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  const int u = blockIdx.x;
  const size_t trk = sq * U + u;
  H += sq * U * R2 * D;
  Hf += sq * U * R2 * 3;
  r += sq * U * R2;
  P += sq * D * D;
  Ht += sq * U * R2 * D;
  rt += sq * U * R2;
  const int tid = threadIdx.x;
  const bool vec = D % V == 0;
  const size_t hoff = (size_t)u * R2 * D;

  // group 1: H (zero past 2M rows and D columns); group 2: the first stage
  // of P, in flight through the projector
  load_async(Hs, ldh, H + hoff, D, kRows, R2, dp, D, vec);
  cp_async_commit();
  const int nk = (D + kK - 1) / kK;
  const int steps = n_panels(D) * nk;
  auto load_p = [&](int s) {
    const int p = s / nk, k0 = (s - p * nk) * kK;
    load_async(Ps + (s & 1) * kK * kCols, kCols, P + (size_t)k0 * D + p * kCols, D, kK,
               D - k0, kCols, D - p * kCols, vec);
  };
  load_p(0);
  cp_async_commit();
  for (int e = tid; e < R2 * 3; e += blockDim.x) Hfs[e] = Hf[(size_t)u * R2 * 3 + e];
  for (int e = tid; e < R2; e += blockDim.x) rs[e] = r[(size_t)u * R2 + e];
  cp_async_wait<1>();  // H has landed
  __syncthreads();

  projector_weights(Hfs, rs, sums, R2, eps);
  projector_c(Hfs, sums, C, R2, D, [&](int q, int d) { return Hs[q * ldh + d]; });
  if (tid < R2) rt[(size_t)u * R2 + tid] = project_r(Hfs, rs, sums, tid);
  __syncthreads();
  // H~ = H - Hf C, in place, and out to the scratch: V columns per step
  // (16-byte loads and stores) when D allows, else one
  auto project = [&](int q, int d) {
    return Hs[q * ldh + d] - (Hfs[q * 3] * C[d] + Hfs[q * 3 + 1] * C[D + d] +
                              Hfs[q * 3 + 2] * C[2 * D + d]);
  };
  if (vec) {
    const int nv = D / V;
    for (int e = tid; e < R2 * nv; e += blockDim.x) {
      const int q = e / nv, d = (e - q * nv) * V;
      V16<T> h;
#pragma unroll
      for (int t = 0; t < V; ++t) h.v[t] = project(q, d + t);
      *reinterpret_cast<V16<T>*>(Hs + q * ldh + d) = h;
      *reinterpret_cast<V16<T>*>(Ht + hoff + (size_t)q * D + d) = h;
    }
  } else {
    for (int e = tid; e < R2 * D; e += blockDim.x) {
      const int q = e / D, d = e - q * D;
      const T v = project(q, d);
      Hs[q * ldh + d] = v;
      Ht[hoff + e] = v;
    }
  }

  // H~P panel by panel, P streamed through two stages; S accumulated after
  // each panel. Thread (rg, cg): H~P rows rg + 16i, columns 2cg + 32j +
  // {0, 1} of the panel; S rows rg + 16i, columns cg + 16j.
  const int rg = tid >> 4, cg = tid & 15;
  T s[4][4];
  T acc[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = T(0);
  for (int st = 0; st < steps; ++st) {
    const int p = st / nk, kc = st - p * nk;
    if (st + 1 < steps) load_p(st + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed
    __syncthreads();     // (and, on the first step, H~ is complete)
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 6; ++c) acc[i][c] = T(0);
    }
    const T* pst = Ps + (st & 1) * kK * kCols + 2 * cg;
    const T* hrow = Hs + rg * ldh + kc * kK;
#pragma unroll
    for (int kk = 0; kk < kK; kk += V) {
      V16<T> a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld16(hrow + 16 * i * ldh + kk);
#pragma unroll
      for (int t = 0; t < V; ++t) {
        T b[6];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const V2<T> pb = *reinterpret_cast<const V2<T>*>(pst + (kk + t) * kCols + 32 * j);
          b[2 * j] = pb.v[0];
          b[2 * j + 1] = pb.v[1];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 6; ++c) acc[i][c] = acc[i][c] + a[i].v[t] * b[c];
      }
    }
    __syncthreads();  // the next step's copy reuses this stage
    if (kc == nk - 1) {
      // the panel to shared memory, then S += panel H~[:, panel]^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          V2<T> v;
          v.v[0] = acc[i][2 * j];
          v.v[1] = acc[i][2 * j + 1];
          *reinterpret_cast<V2<T>*>(HP + (rg + 16 * i) * kCols + 2 * cg + 32 * j) = v;
        }
      __syncthreads();
      const T* xrow = HP + rg * kCols;
      const T* yrow = Hs + cg * ldh + p * kCols;
#pragma unroll 2
      for (int dd = 0; dd < kCols; dd += V) {
        V16<T> x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = ld16(xrow + 16 * i * kCols + dd);
          y[i] = ld16(yrow + 16 * i * ldh + dd);
        }
#pragma unroll
        for (int t = 0; t < V; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + x[i].v[t] * y[j].v[t];
      }
      __syncthreads();  // the next panel overwrites HP
    }
  }

  // the upper triangle of S + sigma^2 I to the scratch, for the gate launch
  T* Su = Ss + trk * R2 * R2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = rg + 16 * i, col = cg + 16 * j;
      if (col < R2 && col >= row) Su[row * R2 + col] = (row == col) ? s[i][j] + sigma2 : s[i][j];
    }
}

// ---------------------------------------------------------------------------
// launch 1, the general form (any 2M and D): the projector, then S by tiles
// ---------------------------------------------------------------------------

// The projector alone, one block per track: H is read from global memory
// (L2) where the fast form holds it in shared memory; H~ and r~ go to the
// scratch. Shared memory: Hf, r, C and the sums, (4 (2M) + 3 D + 16)
// elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
update_project_kernel(const T* __restrict__ H, const T* __restrict__ Hf,
                      const T* __restrict__ r, T eps, T* __restrict__ Ht, T* __restrict__ rt,
                      int U, int R2, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Hfs = reinterpret_cast<T*>(smem_raw);
  T* rs = Hfs + (size_t)R2 * 3;
  T* C = rs + R2;
  T* sums = C + 3 * (size_t)D;
  const size_t trk = (size_t)blockIdx.y * U + blockIdx.x;
  const T* Hu = H + trk * R2 * D;
  T* Hu_t = Ht + trk * R2 * D;
  for (int e = threadIdx.x; e < R2 * 3; e += blockDim.x) Hfs[e] = Hf[trk * R2 * 3 + e];
  for (int e = threadIdx.x; e < R2; e += blockDim.x) rs[e] = r[trk * R2 + e];
  __syncthreads();
  projector_weights(Hfs, rs, sums, R2, eps);
  projector_c(Hfs, sums, C, R2, D, [&](int q, int d) { return Hu[(size_t)q * D + d]; });
  for (int q = threadIdx.x; q < R2; q += blockDim.x) rt[trk * R2 + q] = project_r(Hfs, rs, sums, q);
  __syncthreads();
  for (size_t e = threadIdx.x; e < (size_t)R2 * D; e += blockDim.x) {
    const int q = (int)(e / D), d = (int)(e - (size_t)q * D);
    Hu_t[e] = Hu[e] - (Hfs[q * 3] * C[d] + Hfs[q * 3 + 1] * C[D + d] + Hfs[q * 3 + 2] * C[2 * D + d]);
  }
}

// S = H~ P H~^T + sigma^2 I by 64 x 64 tiles on and above the diagonal, one
// block per (track, tile): for each chunk of kSC columns l of P, the block
// forms X = H~[rows] P[:, l] (64 x kSC; H~ and P streamed through shared
// memory in kSC-deep chunks of k), then adds X H~[cols, l]^T to its
// register tile. Writes the tile's entries with column >= row.
constexpr int kSC = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_s_kernel(const T* __restrict__ Ht, const T* __restrict__ P, T sigma2,
                T* __restrict__ Ss, int U, int R2, int D) {
  __shared__ T Hs[kTile][kSC + 1];  // H~: the row tile's, then the column tile's
  __shared__ T Pk[kSC][kSC + 1];
  __shared__ T Xs[kTile][kSC + 1];
  const int nt = (R2 + kTile - 1) / kTile;
  const int npairs = nt * (nt + 1) / 2;
  const int u = blockIdx.x / npairs;
  int ta = blockIdx.x - u * npairs, tb = 0;  // ta <= tb
  while (ta > tb) {
    ta -= tb + 1;
    ++tb;
  }
  const int a0 = ta * kTile, b0 = tb * kTile;
  const size_t sq = blockIdx.y;
  const size_t trk = sq * U + u;
  const T* Hu = Ht + trk * R2 * D;
  P += sq * D * D;
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;  // X: column tx, rows ty + 8i
  const int sx = tid & 15, sy = tid >> 4;  // S: rows sy + 16i, columns sx + 16j
  auto load_h = [&](int r0, int c0) {
    for (int e = tid; e < kTile * kSC; e += kThreads) {
      const int i = e / kSC, k = e - i * kSC;
      const int row = r0 + i, col = c0 + k;
      Hs[i][k] = (row < R2 && col < D) ? Hu[(size_t)row * D + col] : T(0);
    }
  };
  T s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = T(0);
  const int nk = (D + kSC - 1) / kSC;
  for (int lc = 0; lc < nk; ++lc) {
    T x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = T(0);
    for (int kc = 0; kc < nk; ++kc) {
      load_h(a0, kc * kSC);
      for (int e = tid; e < kSC * kSC; e += kThreads) {
        const int k = e / kSC, l = e - k * kSC;
        const int kk = kc * kSC + k, ll = lc * kSC + l;
        Pk[k][l] = (kk < D && ll < D) ? P[(size_t)kk * D + ll] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kSC; ++k) {
        const T p = Pk[k][tx];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = x[i] + Hs[ty + 8 * i][k] * p;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Xs[ty + 8 * i][tx] = x[i];
    load_h(b0, lc * kSC);
    __syncthreads();
#pragma unroll 4
    for (int l = 0; l < kSC; ++l) {
      T xa[4], hb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[i] = Xs[sy + 16 * i][l];
        hb[i] = Hs[sx + 16 * i][l];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] + xa[i] * hb[j];
    }
    __syncthreads();
  }
  T* Su = Ss + trk * R2 * R2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + sy + 16 * i, b = b0 + sx + 16 * j;
      if (b < R2 && b >= a) Su[(size_t)a * R2 + b] = (a == b) ? s[i][j] + sigma2 : s[i][j];
    }
}

// ---------------------------------------------------------------------------
// launch 2: partial sums of A's lower triangle and of c, one chunk each
// ---------------------------------------------------------------------------

constexpr size_t partial_smem_elems() {
  return 2 * 2 * (size_t)kUnit * kTile  // two stages of the a and b columns
         + 2 * kUnit                    // two stages of r~
         + 4 * kTile;                   // c's four row-lane sums
}

// the index of the n-th set bit of m (n < popc(m))
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_partial_kernel(const T* __restrict__ Ht, const T* __restrict__ rt,
                      const unsigned char* __restrict__ passed, T* __restrict__ Apart,
                      T* __restrict__ cpart, int U, int R2, int D, int tpc) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kF = 4 / V;  // 16-byte words in a thread's 4 rows (or columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + 2 * kUnit * kTile;
  T* rs = Bs + 2 * kUnit * kTile;
  T* red = rs + 2 * kUnit;

  // the block's tile (ta, tb), tb <= ta, and chunk
  const int nt = (D + kTile - 1) / kTile;
  const int ntri = nt * (nt + 1) / 2;
  const int chunk = blockIdx.x / ntri;
  int tb = blockIdx.x - chunk * ntri, ta = 0;
  while (tb > ta) {
    tb -= ta + 1;
    ++ta;
  }
  const int a0 = ta * kTile, b0 = tb * kTile;
  const bool diag = ta == tb;

  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  const int nch = (U + tpc - 1) / tpc;
  Ht += sq * U * R2 * D;
  rt += sq * U * R2;
  passed += sq * U;
  Apart += (sq * nch + chunk) * D * D;
  cpart += (sq * nch + chunk) * D;
  const int tid = threadIdx.x;
  const int u0 = chunk * tpc, ntr = min(tpc, U - u0);
  const int lane = tid & 31;
  const unsigned live = __ballot_sync(0xffffffffu, lane < ntr && passed[u0 + lane]);
  const int upt = (R2 + kUnit - 1) / kUnit;  // units of kUnit rows per track
  const int nunits = __popc(live) * upt;
  const bool vec = D % V == 0;

  // unit n: rows [q0, q0 + nr) of the n / upt-th passed track of the chunk
  auto unit_rows = [&](int n) { return min(kUnit, R2 - (n % upt) * kUnit); };
  auto load_unit = [&](int n) {
    const int t = nth_bit(live, n / upt), q0 = (n % upt) * kUnit, nr = unit_rows(n);
    const size_t row = (size_t)(u0 + t) * R2 + q0;
    const int stage = (n & 1) * kUnit;
    load_async(As + stage * kTile, kTile, Ht + row * D + a0, D, nr, nr, kTile, D - a0, vec);
    if (diag) {
      if (tid < nr) cp_async<sizeof(T)>(rs + stage + tid, rt + row + tid);
    } else {
      load_async(Bs + stage * kTile, kTile, Ht + row * D + b0, D, nr, nr, kTile, D - b0, vec);
    }
  };

  // thread (tx, ty): rows a0 + V ty + 16 V m + t, columns b0 + V tx + 16 V m + t
  const int tx = tid & 15, ty = tid >> 4;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
  T cacc = T(0);
  if (nunits > 0) load_unit(0);
  cp_async_commit();
  for (int n = 0; n < nunits; ++n) {
    if (n + 1 < nunits) load_unit(n + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int nr = unit_rows(n);
    const T* as = As + (n & 1) * kUnit * kTile;
    const T* bs = diag ? as : Bs + (n & 1) * kUnit * kTile;
    for (int q = 0; q < nr; ++q) {
      T x[4], y[4];
#pragma unroll
      for (int m = 0; m < kF; ++m) {
        const V16<T> xv = ld16(as + q * kTile + V * ty + 16 * V * m);
        const V16<T> yv = ld16(bs + q * kTile + V * tx + 16 * V * m);
#pragma unroll
        for (int t = 0; t < V; ++t) {
          x[m * V + t] = xv.v[t];
          y[m * V + t] = yv.v[t];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + x[i] * y[j];
    }
    if (diag) {  // c: column tid % 64, every 4th row from tid / 64
      const T* rst = rs + (n & 1) * kUnit;
      for (int q = tid >> 6; q < nr; q += 4) cacc = cacc + as[q * kTile + (tid & 63)] * rst[q];
    }
    __syncthreads();  // the next copy reuses this stage
  }

#pragma unroll
  for (int mi = 0; mi < kF; ++mi)
#pragma unroll
    for (int ti = 0; ti < V; ++ti) {
      const int i = mi * V + ti, a = a0 + V * ty + 16 * V * mi + ti;
      if (a >= D) continue;
#pragma unroll
      for (int mj = 0; mj < kF; ++mj) {
        const int b = b0 + V * tx + 16 * V * mj;
        if (vec) {
          if (b < D) {
            V16<T> v;
#pragma unroll
            for (int tj = 0; tj < V; ++tj) v.v[tj] = acc[i][mj * V + tj];
            *reinterpret_cast<V16<T>*>(Apart + (size_t)a * D + b) = v;
          }
        } else {
#pragma unroll
          for (int tj = 0; tj < V; ++tj)
            if (b + tj < D) Apart[(size_t)a * D + b + tj] = acc[i][mj * V + tj];
        }
      }
    }
  if (diag) {
    red[tid] = cacc;  // red[lane * 64 + column]
    __syncthreads();
    if (tid < kTile && a0 + tid < D)
      cpart[a0 + tid] = ((red[tid] + red[kTile + tid]) + red[2 * kTile + tid]) + red[3 * kTile + tid];
  }
}

// ---------------------------------------------------------------------------
// launch 3: the partials summed in chunk order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
update_reduce_kernel(const T* __restrict__ Apart, const T* __restrict__ cpart,
                     T* __restrict__ A, T* __restrict__ c, int D, int nch) {
  const size_t sq = blockIdx.y;  // the sequence of a batched launch
  const size_t dd = (size_t)D * D;
  Apart += sq * nch * dd;
  cpart += sq * nch * D;
  A += sq * dd;
  c += sq * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < D * D) {
    const int a = e / D, b = e - a * D;
    const size_t at = a >= b ? (size_t)a * D + b : (size_t)b * D + a;
    T s = Apart[at];
#pragma unroll 4
    for (int k = 1; k < nch; ++k) s = s + Apart[k * dd + at];
    A[e] = s;
  } else if (e < D * D + D) {
    const int a = e - D * D;
    T s = cpart[a];
#pragma unroll 4
    for (int k = 1; k < nch; ++k) s = s + cpart[(size_t)k * D + a];
    c[a] = s;
  }
}

// The fast launch 1 holds a track's 2M <= kRows rows of H and its working
// set in the device's shared-memory opt-in; any other shape takes the
// general launch 1. Chosen by shape, never on failure.
template <typename T>
cudaError_t fast_track_path(int R2, int D, bool* fast) {
  size_t optin = 0;
  const cudaError_t err = smem_optin(&optin);
  *fast = R2 <= kRows && track_smem_elems<T>(D) * sizeof(T) <= optin;
  return err;
}

template <typename T>
int launch(const void* H, const void* Hf, const void* r, const void* P, const void* crit,
           const void* sel_ok, void* Ht, void* rt, void* Ss, void* gsc, void* Apart, void* cpart,
           void* A, void* c, void* passed, int U, int R2, int D, int B, int tpc, double sigma2,
           double eps, cudaStream_t stream) {
  if (U < 1 || R2 < 1 || D < 1 || B < 1 || B > 65535 || tpc < 1 || tpc > kMaxChunkTracks ||
      (size_t)B * U > (size_t)INT_MAX)
    return (int)cudaErrorInvalidValue;
  static OptIn track_opt, project_opt, partial_opt;
  bool fast = false;
  cudaError_t err = fast_track_path<T>(R2, D, &fast);
  if (err != cudaSuccess) return (int)err;
  const T* Ht_c = static_cast<const T*>(Ht);
  const T* rt_c = static_cast<const T*>(rt);
  if (fast) {
    const size_t smem1 = track_smem_elems<T>(D) * sizeof(T);
    err = track_opt.ensure((const void*)update_track_kernel<T>, smem1);
    if (err != cudaSuccess) return (int)err;
    update_track_kernel<T><<<dim3(U, B), kThreads, smem1, stream>>>(
        static_cast<const T*>(H), static_cast<const T*>(Hf), static_cast<const T*>(r),
        static_cast<const T*>(P), T(sigma2), T(eps), static_cast<T*>(Ht), static_cast<T*>(rt),
        static_cast<T*>(Ss), U, R2, D);
  } else {
    const size_t smemp = (4 * (size_t)R2 + 3 * (size_t)D + 16) * sizeof(T);
    err = project_opt.ensure((const void*)update_project_kernel<T>, smemp);
    if (err != cudaSuccess) return (int)err;
    update_project_kernel<T><<<dim3(U, B), kThreads, smemp, stream>>>(
        static_cast<const T*>(H), static_cast<const T*>(Hf), static_cast<const T*>(r), T(eps),
        static_cast<T*>(Ht), static_cast<T*>(rt), U, R2, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nt = (R2 + kTile - 1) / kTile;
    update_s_kernel<T><<<dim3(U * (nt * (nt + 1) / 2), B), kThreads, 0, stream>>>(
        Ht_c, static_cast<const T*>(P), T(sigma2), static_cast<T*>(Ss), U, R2, D);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the gate over the B * U tracks: passed = sel_ok && gamma <= crit
  err = launch_gate<T, true>(static_cast<const T*>(Ss), rt_c, nullptr,
                             static_cast<const T*>(crit), static_cast<const unsigned char*>(sel_ok),
                             static_cast<unsigned char*>(passed), static_cast<T*>(gsc), B * U, R2,
                             stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = partial_smem_elems() * sizeof(T);
  err = partial_opt.ensure((const void*)update_partial_kernel<T>, smem2);
  if (err != cudaSuccess) return (int)err;
  const int nch = (U + tpc - 1) / tpc;
  const int nt = (D + kTile - 1) / kTile;
  update_partial_kernel<T><<<dim3(nch * (nt * (nt + 1) / 2), B), kThreads, smem2, stream>>>(
      Ht_c, rt_c, static_cast<const unsigned char*>(passed), static_cast<T*>(Apart),
      static_cast<T*>(cpart), U, R2, D, tpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  update_reduce_kernel<T><<<dim3((D * D + D + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      static_cast<const T*>(Apart), static_cast<const T*>(cpart), static_cast<T*>(A),
      static_cast<T*>(c), D, nch);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences (the per-track scratch
// Ht, rt, Ss (B, U, 2M, 2M; its upper triangle is written) and the
// partials Apart (B, chunks, D, D), cpart (B, chunks, D) too); gsc is the
// gate's global scratch (null, or B * U * msckf_gate_scratch(2M) elements);
// tpc is the chunk plan's tracks per chunk
MSCKF_EXPORT int msckf_update_terms_f32(const void* H, const void* Hf, const void* r,
                                        const void* P, const void* crit, const void* sel_ok,
                                        void* Ht, void* rt, void* Ss, void* gsc, void* Apart,
                                        void* cpart, void* A, void* c, void* passed, int U,
                                        int R2, int D, int B, int tpc, double sigma2,
                                        double eps, void* stream) {
  return launch<float>(H, Hf, r, P, crit, sel_ok, Ht, rt, Ss, gsc, Apart, cpart, A, c, passed,
                       U, R2, D, B, tpc, sigma2, eps, static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_update_terms_f64(const void* H, const void* Hf, const void* r,
                                        const void* P, const void* crit, const void* sel_ok,
                                        void* Ht, void* rt, void* Ss, void* gsc, void* Apart,
                                        void* cpart, void* A, void* c, void* passed, int U,
                                        int R2, int D, int B, int tpc, double sigma2,
                                        double eps, void* stream) {
  return launch<double>(H, Hf, r, P, crit, sel_ok, Ht, rt, Ss, gsc, Apart, cpart, A, c, passed,
                        U, R2, D, B, tpc, sigma2, eps, static_cast<cudaStream_t>(stream));
}
