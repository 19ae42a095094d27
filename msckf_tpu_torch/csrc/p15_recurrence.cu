// 15x15 IMU-block covariance recurrence over a block of nt ticks:
//   P <- Phi_i P Phi_i^T + Qd_i, then P <- (P + P^T) / 2
//   Phi_acc <- Phi_i Phi_acc
// with each tick's diag(P)[0:3] and diag(P)[12:15] written out.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::p15_recurrence_fused (:970) ->
// _p15_recurrence_kernel (:951). Phi_i and Qd_i come precomputed from the
// batched per-tick math in filter/propagation.py::_phi_q_block.
//
// What bounds it on the H100: at nt = 9 it moves ~19 KB and does ~0.19
// MFLOP per sequence (roofline 0.0000057 ms in f32): nothing. The
// recurrence is serial, so its time is the chain of the ticks: per tick two
// dependent 15 x 15 x 15 products (T = Phi_i P, then T Phi_i^T) with a
// barrier after each. The chain floor, two dependent 15-term dot products
// and two barriers, is ~300 to 400 cycles a tick (~0.2 us at 1.7 GHz), ~2 us
// for nt = 9. On one SM the products are bound by shared memory: a 16-byte
// load of a warp costs one wavefront per active quarter-warp whatever it
// broadcasts, so a product of 1 x 3 register tiles (75 lanes) takes ~200
// wavefronts; larger tiles cut the wavefronts but lengthen each lane's
// dependent stream, which one warp per scheduler cannot hide.
//
// Design: one block of 256 threads per sequence. A single call is one
// block; the batched form (what pallas_call's own vmap rule makes of the
// TPU kernel: a leading grid axis) runs one block per sequence, each at its
// own base offsets, so every sequence gets the bits of a single launch.
// - No device memory on the chain: Phi_i and Qd_i come into a
//   shared-memory ring of two slots of C ticks (the wrapper's plan,
//   ops/kernels.py::p15_plan: C = min(nt, 9) in f32, min(nt, 4) in f64,
//   within the 48 KB a block gets without an opt-in) by cp.async, Phi_i
//   into zero-padded 16 x 16 rows, all eight warps issuing; the next
//   chunk's copy is in flight while the current chunk runs.
// - P is symmetric after its first tick, so phase 2 computes its upper
//   triangle once and mirrors it (P0 is symmetrized when it is loaded:
//   Phi sym(P0) Phi^T is what the plain version's symmetrize gives), into
//   the other of two P buffers, so that a warp may write P' while another
//   still reads P.
// - float32: warps 0-3 run the chain on the CUDA cores (FMA), each warp on
//   its own rows of P (30 entries of the upper triangle each): phase 1
//   computes the warp's rows of T in 1 x 3 tiles, a __syncwarp (phase 2
//   reads only the warp's own rows of T), phase 2 one entry a lane in
//   three partial sums of 5 (a dependent chain of 5 multiply-adds, not 15),
//   then one named barrier of the four warps: one block barrier a tick.
// - float64: warps 0-1 run the chain on the tensor cores (DMMA m8n8k4, a
//   16 x 8 column block a warp), two named barriers a tick.
// - Phi_acc off P's chain: warps 4-5 compute Phi_i Phi_acc on the tensor
//   cores (3xTF32 m16n8k8 in float32: x = hi + lo, hi hi + hi lo + lo hi,
//   float32's precision; DMMA in float64) with a named barrier of their own,
//   into the other of two Phi_acc buffers (held transposed).
#include "common.cuh"

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
constexpr int kPad = 16;       // matrices in shared memory: 16 x 16, row and column 15 zero
constexpr int kPitch = 20;     // their row stride in elements: 16-byte rows; a quarter-warp's
                               // 16-byte loads of 8 rows, and a warp's fragment loads, hit
                               // distinct banks
constexpr int kMat = kPad * kPitch;
constexpr int kThreads = 256;  // warps 0-3: P's chain; 4-5: Phi_acc's; all copy the ticks in
constexpr size_t kSmemLimit = 48 * 1024;

// elements of one tick in the ring: Phi_i as a padded matrix, then Qd_i as
// it is (15 x 15), rounded to 16 bytes
template <typename T>
__host__ __device__ constexpr int tick_elems() {
  return (kMat + kNN + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) * (16 / (int)sizeof(T));
}

// two P buffers, Phi_i P, and two Phi_acc buffers, then the ring's slots
// (two, or one when a single chunk holds every tick)
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int C, int chunks) {
  return (5 * (size_t)kMat + (size_t)(chunks > 1 ? 2 : 1) * C * tick_elems<T>()) * sizeof(T);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// CUDA-core products (the float32 P chain): rows of padded matrices by
// 16-byte loads, k = 0..14 (the 16th entry of a row is padding)
// ---------------------------------------------------------------------------

// acc[c] = sum_k a[k] b_c[k] in k order, for NB rows b_c of b
template <typename T, int NB>
__device__ __forceinline__ void dot_rows(T (&acc)[NB], const T* a, const T* b) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < NB; ++c) acc[c] = T(0);
#pragma unroll
  for (int q = 0; q < kPad / V; ++q) {
    const V16<T> x = ld16(a + q * V);
    V16<T> y[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) y[c] = ld16(b + c * kPitch + q * V);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (q * V + e < kN)
#pragma unroll
        for (int c = 0; c < NB; ++c) acc[c] = acc[c] + x.v[e] * y[c].v[e];
  }
}

// sum_k a[k] b[k] as three interleaved partial sums over k = 0..4, 5..9 and
// 10..14, added at the end: a dependent chain of 5 multiply-adds, not 15
template <typename T>
__device__ __forceinline__ T dot_split(const T* a, const T* b) {
  constexpr int V = 16 / sizeof(T);
  T s[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int q = 0; q < kPad / V; ++q) {
    const V16<T> x = ld16(a + q * V), y = ld16(b + q * V);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int k = q * V + e;
      if (k < kN) s[k / 5] = s[k / 5] + x.v[e] * y.v[e];
    }
  }
  return s[0] + s[1] + s[2];
}

// ---------------------------------------------------------------------------
// tensor-core products (Phi_acc in both types, the float64 P chain)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}

// x as hi + lo, both tf32: the 3xTF32 products hi hi + hi lo + lo hi keep
// float32's precision (the dropped lo lo term is ~2^-22 relative)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// One warp's 16 x 8 column block n0 .. n0 + 7 of D = A B (padded 16 x 16
// matrices, k = 0..15) on the tensor cores, B given by the rows of its
// transpose (Bt[n][k] = B[k][n]): the lane's four fragment positions q hold
// D[frag_row(q)][frag_col(n0, q)]. float: m16n8k8 TF32, three products a
// step; double: m8n8k4, two 8 x 8 tiles.
__device__ __forceinline__ int frag_row(int q) { return (threadIdx.x % 32) / 4 + (q / 2) * 8; }
__device__ __forceinline__ int frag_col(int n0, int q) {
  return n0 + 2 * (threadIdx.x % 4) + (q % 2);
}

template <typename T>
__device__ __forceinline__ void mma_block(T (&d)[4], const T* A, const T* Bt, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* a0 = A + g * kPitch + t;
  const T* a1 = a0 + 8 * kPitch;
  const T* b0 = Bt + (n0 + g) * kPitch + t;
  if constexpr (sizeof(T) == 4) {
    float hh[4] = {}, hl[4] = {}, lh[4] = {};
#pragma unroll
    for (int ks = 0; ks < kPad; ks += 8) {
      unsigned ah[4], al[4], bh[2], bl[2];
      split_tf32(a0[ks], ah[0], al[0]);
      split_tf32(a1[ks], ah[1], al[1]);
      split_tf32(a0[ks + 4], ah[2], al[2]);
      split_tf32(a1[ks + 4], ah[3], al[3]);
      split_tf32(b0[ks], bh[0], bl[0]);
      split_tf32(b0[ks + 4], bh[1], bl[1]);
      mma_tf32(hh, ah, bh);
      mma_tf32(hl, ah, bl);
      mma_tf32(lh, al, bh);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) d[q] = hh[q] + (hl[q] + lh[q]);
  } else {
    double c0[2] = {}, c1[2] = {};
#pragma unroll
    for (int ks = 0; ks < kPad; ks += 4) {
      mma_f64(c0, a0[ks], b0[ks]);
      mma_f64(c1, a1[ks], b0[ks]);
    }
    d[0] = c0[0];
    d[1] = c0[1];
    d[2] = c1[0];
    d[3] = c1[1];
  }
}

// starts the copy of ticks [t0, t0 + n) of Phi (into padded rows) and Qd (as
// it is) into a ring slot: thread e copies entry e of every tick
template <typename T>
__device__ __forceinline__ void start_chunk(T* slot, const T* __restrict__ Phi,
                                            const T* __restrict__ Qd, int t0, int n) {
  const int e = threadIdx.x;  // kThreads >= kNN
  const int i = e / kN, j = e - i * kN;
  if (e < kNN)
    for (int tk = 0; tk < n; ++tk) {
      T* dst = slot + tk * tick_elems<T>();
      const size_t src = (size_t)(t0 + tk) * kNN + e;
      cp_async<sizeof(T)>(dst + i * kPitch + j, Phi + src);
      cp_async<sizeof(T)>(dst + kMat + e, Qd + src);
    }
  cp_async_commit();
}

// the rows of P each of the four float32 P warps owns, 30 entries of P's
// upper triangle a warp (-1: none)
__constant__ int kRowsOf[4][4] = {{0, 1, 14, -1}, {2, 3, 12, 13}, {4, 5, 10, 11}, {6, 7, 8, 9}};

template <typename T>
__global__ void __launch_bounds__(kThreads)
p15_kernel(const T* __restrict__ P0, const T* __restrict__ Phi, const T* __restrict__ Qd,
           T* __restrict__ P_out, T* __restrict__ acc_out, T* __restrict__ sig, int nt, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ps = reinterpret_cast<T*>(smem_raw);  // two buffers of P (symmetric), by rows
  T* Tm = Ps + 2 * kMat;                   // Phi_i P, by rows
  T* Acc = Tm + kMat;                      // two buffers of Phi_acc transposed
  T* ring = Acc + 2 * kMat;
  const int slot_elems = C * tick_elems<T>();
  const size_t sq = blockIdx.x;  // the sequence of a batched launch
  P0 += sq * kNN;
  Phi += sq * nt * kNN;
  Qd += sq * nt * kNN;
  P_out += sq * kNN;
  acc_out += sq * kNN;
  sig += sq * nt * 6;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int chunks = (nt + C - 1) / C;

  start_chunk(ring, Phi, Qd, 0, min(C, nt));
  if (chunks > 1)
    start_chunk(ring + slot_elems, Phi, Qd, C, min(C, nt - C));
  else
    cp_async_commit();  // an empty group, so that the wait below is the same

  // P0 symmetrized (the plain version symmetrizes Phi P0 Phi^T, which is
  // Phi sym(P0) Phi^T) in buffer 0; every later P is symmetric, so only its
  // upper triangle is computed and mirrored. The padding of every matrix
  // (row and column 15; the ring's Phi too, which the copies leave alone)
  // is zero, as the tensor-core products sum over k = 0..15.
  for (int e = tid; e < kMat; e += kThreads) {
    const int i = e / kPitch, j = e - i * kPitch;
    const bool in = i < kN && j < kN;
    Ps[e] = in ? T(0.5) * (P0[i * kN + j] + P0[j * kN + i]) : T(0);
    Ps[kMat + e] = T(0);
    Tm[e] = T(0);
    Acc[e] = (in && i == j) ? T(1) : T(0);
    Acc[kMat + e] = T(0);
    if (!in)
      for (int tk = 0; tk < (chunks > 1 ? 2 : 1) * C; ++tk) ring[tk * tick_elems<T>() + e] = T(0);
  }

  // float32 P warp w, phase 1: lane l of the first 5 x rows computes
  // entries 3 J1 .. 3 J1 + 2 of row i1 of Phi_i P; phase 2: lane l of the
  // first 30 computes entry (i2, j2) of P's upper triangle in the warp's rows
  int i1 = -1, J1 = 0, i2 = -1, j2 = 0;
  if (sizeof(T) == 4 && warp < 4) {
    const int r = lane / 5;
    if (r < 4) i1 = kRowsOf[warp][r];
    J1 = lane - r * 5;
    int l = lane;
    for (int q = 0; q < 4 && i2 < 0; ++q) {
      const int row = kRowsOf[warp][q];
      if (row < 0) break;
      if (l < kN - row) {
        i2 = row;
        j2 = row + l;
      } else {
        l -= kN - row;
      }
    }
  }
  cp_async_wait<1>();  // chunk 0 has landed
  __syncthreads();

  for (int c = 0; c < chunks; ++c) {
    T* slot = ring + (c & 1) * slot_elems;
    const int n = min(C, nt - c * C);
    for (int tk = 0; tk < n; ++tk) {
      const T* Ph = slot + tk * tick_elems<T>();
      const T* Q = Ph + kMat;
      const int b = c * C + tk;  // the tick
      const T* Pc = Ps + (b & 1) * kMat;
      T* Pn = Ps + ((b + 1) & 1) * kMat;
      if (sizeof(T) == 4 && warp < 4) {
        // float32 P chain on the CUDA cores, each warp on its own rows:
        // phase 1, T = Phi_i P (P symmetric: its rows are its columns)
        if (i1 >= 0) {
          T t[3];
          dot_rows<T, 3>(t, Ph + i1 * kPitch, Pc + 3 * J1 * kPitch);
#pragma unroll
          for (int k = 0; k < 3; ++k) Tm[i1 * kPitch + 3 * J1 + k] = t[k];
        }
        __syncwarp();  // phase 2 reads only this warp's rows of T
        // phase 2: P' = T Phi_i^T + sym(Qd_i), upper triangle, mirrored
        if (i2 >= 0) {
          const T v = dot_split(Tm + i2 * kPitch, Ph + j2 * kPitch) +
                      T(0.5) * (Q[i2 * kN + j2] + Q[j2 * kN + i2]);
          Pn[i2 * kPitch + j2] = v;
          Pn[j2 * kPitch + i2] = v;
          if (j2 == i2 && (i2 < 3 || i2 >= 12))
            sig[(size_t)b * 6 + (i2 < 3 ? i2 : i2 - 9)] = v;
        }
        bar_sync(1, 128);
      } else if (sizeof(T) == 8 && warp < 2) {
        // float64 P chain on the tensor cores, a 16 x 8 column block a warp:
        // phase 1, T = Phi_i P
        const int n0 = 8 * warp;
        T d[4];
        mma_block<T>(d, Ph, Pc, n0);
#pragma unroll
        for (int q = 0; q < 4; ++q) Tm[frag_row(q) * kPitch + frag_col(n0, q)] = d[q];
        bar_sync(1, 64);
        // phase 2: P' = T Phi_i^T + sym(Qd_i), upper triangle, mirrored
        mma_block<T>(d, Tm, Ph, n0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = frag_row(q), j = frag_col(n0, q);
          if (i <= j && j < kN) {
            const T v = d[q] + T(0.5) * (Q[i * kN + j] + Q[j * kN + i]);
            Pn[i * kPitch + j] = v;
            Pn[j * kPitch + i] = v;
            if (i == j && (i < 3 || i >= 12)) sig[(size_t)b * 6 + (i < 3 ? i : i - 9)] = v;
          }
        }
        bar_sync(1, 64);
      } else if (warp == 4 || warp == 5) {
        // Phi_acc' = Phi_i Phi_acc on the tensor cores, off P's chain
        // (Bt = Phi_acc^T, held so; the product is stored transposed)
        const int n0 = 8 * (warp - 4);
        T d[4];
        mma_block<T>(d, Ph, Acc + (b & 1) * kMat, n0);
        T* An = Acc + ((b + 1) & 1) * kMat;
#pragma unroll
        for (int q = 0; q < 4; ++q) An[frag_col(n0, q) * kPitch + frag_row(q)] = d[q];
        bar_sync(2, 64);
      }
    }
    cp_async_wait<0>();  // the next chunk has landed
    __syncthreads();     // and every read of this slot is done: refill it
    if (c + 2 < chunks) start_chunk(slot, Phi, Qd, (c + 2) * C, min(C, nt - (c + 2) * C));
  }
  // P's and Phi_acc's last products went to buffers nt & 1
  for (int e = tid; e < kNN; e += kThreads) {
    const int i = e / kN, j = e - i * kN;
    P_out[e] = Ps[(nt & 1) * kMat + i * kPitch + j];
    acc_out[e] = Acc[(nt & 1) * kMat + j * kPitch + i];
  }
}

template <typename T>
int launch(const void* P0, const void* Phi, const void* Qd, void* P, void* acc, void* sig,
           int nt, int B, int C, int smem, cudaStream_t stream) {
  // the plan (ops/kernels.py::p15_plan): C ticks a chunk, and the layout's
  // bytes within what a block gets without an opt-in
  if (nt < 1 || B < 1 || C < 1 || C > nt ||
      (size_t)smem != smem_bytes<T>(C, (nt + C - 1) / C) || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  p15_kernel<T><<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(P0), static_cast<const T*>(Phi), static_cast<const T*>(Qd),
      static_cast<T*>(P), static_cast<T*>(acc), static_cast<T*>(sig), nt, C);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences; Phi and Qd hold nt
// ticks; C and smem are the plan's ticks per chunk and shared-memory bytes
MSCKF_EXPORT int msckf_p15_recurrence_f32(const void* P0, const void* Phi, const void* Qd,
                                          void* P, void* acc, void* sig, int nt, int B, int C,
                                          int smem, void* stream) {
  return launch<float>(P0, Phi, Qd, P, acc, sig, nt, B, C, smem,
                       static_cast<cudaStream_t>(stream));
}

MSCKF_EXPORT int msckf_p15_recurrence_f64(const void* P0, const void* Phi, const void* Qd,
                                          void* P, void* acc, void* sig, int nt, int B, int C,
                                          int smem, void* stream) {
  return launch<double>(P0, Phi, Qd, P, acc, sig, nt, B, C, smem,
                        static_cast<cudaStream_t>(stream));
}
