// nt sequential OC-EKF propagation ticks in one kernel.
//
// Replaces msckf_tpu/ops/pallas_kernels.py::propagate_block_fused (:1216) ->
// _propagate_block_call (:1148) -> _propagate_block_kernel (:1020), which
// itself follows filter/propagation.py::_phi_q_for_tick. Per tick:
//   * nominal integration: Rodrigues rotation increment about the gyro axis,
//     explicit Euler velocity/position with the 1/2 a dt^2 term;
//   * F, Fdt, and the third-order Taylor Phi = I + Fdt + Fdt^2/2 + Fdt^3/6;
//   * the observability-constrained fix-up of Phi's rotation, velocity and
//     position columns, with the null state = the pre-tick state, or the
//     constructor identity while prop_count == 0;
//   * Q = (Phi G) diag(Qc) (Phi G)^T dt with G's block structure;
//   * P15 <- Phi P15 Phi^T + Q (symmetrized) and Phi_acc <- Phi Phi_acc;
//   * a masked commit, so a padding tick leaves every carried value as it
//     was, and the per-tick R, p, v and sigma diagonals.
// The arithmetic is the TPU kernel's; its layout is not: prop_count comes
// in as an int64 and last_ts as a scalar, not packed into a float row.
//
// What bounds it on the H100: at nt = 1 it moves under 3 KB and does ~45
// KFLOP a sequence (bounds 0.0000009 ms by bytes, 0.0000007 by operations,
// f32), so neither bounds it; its time is the launch (a one-element fill
// takes 0.0010 ms of device time), one round trip to memory, and the tick's
// chain of dependent steps, which alone (loads replaced by values, one
// store) takes 0.00327 ms in f32 and 0.00560 in f64 (on an H100 80GB HBM3
// at 700 W, by a probe that is not part of the repository; PERF.md,
// section 6).
//
// Design: a block of 256 threads a sequence (a single call is one block;
// the batched form, the JAX custom_vmap rule's batch grid at
// pallas_kernels.py:1197-1214, one block a sequence at its own offsets, so
// every sequence gets the bits of a single launch), thread t owning entry t
// of each 15 x 15 matrix and entry t of Phi G. Every thread issues all of
// its loads at entry, tick 0's inputs among them, and tick b + 1's before
// tick b's arithmetic, so nothing waits on a second round trip. Every
// thread runs the tick's serial section (integration, null state, the
// fix-up's vectors) in its own registers: the same instructions on the same
// values, so the same bits, with nothing handed out through shared memory.
// An entry of the fix-up is corrected by its owner, which forms its row's
// three Taylor entries itself; Phi_acc lives in two buffers, read from one
// and written to the other. Each sum keeps the order k = 0..14; Fdt^2 and
// Fdt^3 leave out the terms that F's block structure makes exact zeros;
// rows read whole are read by 16-byte loads (Phi and the first product at a
// row stride of 16). Six __syncthreads() a tick, none before the loop; the
// kernel it replaces had 11 a tick and one before the loop, with thread 0
// alone loading the state and each tick's inputs and running the serial
// section and the fix-up while the others waited. Device time at nt = 1
// (chip_smoke.py --phases device,kernels, in turns with the parent on one
// H100 80GB HBM3 at 700 W): f32 0.0039 ms single and at B = 32, the
// parent's 0.0043 to 0.0044 and 0.0045; f64 0.0063 to 0.0064, the parent's
// 0.0060 to 0.0061 (the serial section's f64 divisions, root, sine and
// cosine run in all eight warps). Not shipped: one warp a sequence, each
// lane owning 7 or 8 entries and __syncwarp() in place of the barriers,
// right but 0.0120 to 0.0130 ms in f32 (same probe) whether its entries
// were unrolled (6,176 SASS instructions) or not (1,760): the one warp runs
// the 225 entries' chains one after another, and its chain alone takes
// 0.0109 ms.
#include "common.cuh"

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
constexpr int kS = 16;         // row stride of Phi and Tm in shared memory
constexpr int kThreads = 256;  // one entry of each 15 x 15 matrix a thread

template <typename T>
__device__ __forceinline__ void skew3(const T* w, T* S) {
  S[0] = T(0);  S[1] = -w[2]; S[2] = w[1];
  S[3] = w[2];  S[4] = T(0);  S[5] = -w[0];
  S[6] = -w[1]; S[7] = w[0];  S[8] = T(0);
}

template <typename T>
__device__ __forceinline__ void mm3(const T* A, const T* B, T* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                       A[i * 3 + 2] * B[2 * 3 + j];
}

template <typename T>
__device__ __forceinline__ void mv3(const T* A, const T* x, T* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = A[i * 3 + 0] * x[0] + A[i * 3 + 1] * x[1] + A[i * 3 + 2] * x[2];
}

// a[k] for an index that differs between threads, by selects: an indexed
// register array would go to local memory
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int k) {
  T r = a[0];
#pragma unroll
  for (int m = 1; m < N; ++m) r = (k == m) ? a[m] : r;
  return r;
}

// N entries of a row in shared memory, 16-aligned, by 16-byte loads
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, T (&r)[N]) {
  constexpr int W = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < N; c += W) {
    const V16<T> x = ld16(src + c);
#pragma unroll
    for (int w = 0; w < W; ++w) r[c + w] = x.v[w];
  }
}

// The one 3-block K through which (Fdt^2)(I, J) = sum_K Fdt(I, K) Fdt(K, J)
// is not an exact zero, or -1. F's nonzero blocks are (0,0), (0,1), (2,0),
// (2,3) and (4,2), so Fdt^2 has (0,0), (0,1), (2,0), (2,1) through K = 0
// and (4,0), (4,3) through K = 2.
__device__ __forceinline__ int k_square(int I, int J) {
  if ((I == 0 || I == 2) && J < 2) return 0;
  return (I == 4 && (J == 0 || J == 3)) ? 2 : -1;
}

// the same for (Fdt^3)(I, J) = sum_K (Fdt^2)(I, K) Fdt(K, J): (0,0), (0,1),
// (2,0), (2,1), (4,0) and (4,1), each through K = 0
__device__ __forceinline__ int k_cube(int I, int J) {
  return ((I == 0 || I == 2 || I == 4) && J < 2) ? 0 : -1;
}

// (Phi)(i, j) = I + Fdt + Fdt^2 / 2 + Fdt^3 / 6 before the fix-up, from Fdt
// and Fdt^2 in shared memory
template <typename T>
__device__ __forceinline__ T taylor(const T* Fd, const T* Fd2, int i, int j) {
  const int K = k_cube(i / 3, j / 3);
  T a = T(0);
  if (K >= 0) {
#pragma unroll
    for (int k = 3 * K; k < 3 * K + 3; ++k) a = a + Fd2[i * kN + k] * Fd[k * kN + j];
  }
  const T id = (i == j) ? T(1) : T(0);
  return id + Fd[i * kN + j] + T(0.5) * Fd2[i * kN + j] + (T(1) / T(6)) * a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
propagate_kernel(const T* __restrict__ R0, const T* __restrict__ p0,
                 const T* __restrict__ v0, const T* __restrict__ bg,
                 const T* __restrict__ ba, const T* __restrict__ last_ts,
                 const long long* __restrict__ prop_count, const T* __restrict__ ts,
                 const T* __restrict__ gyro, const T* __restrict__ acc,
                 const unsigned char* __restrict__ valid, const T* __restrict__ qc,
                 const T* __restrict__ grav, const T* __restrict__ P15_in,
                 T* __restrict__ R_out, T* __restrict__ p_out, T* __restrict__ v_out,
                 T* __restrict__ lts_out, long long* __restrict__ pc_out,
                 T* __restrict__ P15_out, T* __restrict__ acc_out,
                 T* __restrict__ outR, T* __restrict__ outp, T* __restrict__ outv,
                 T* __restrict__ outsig, int qc_stride, int g_stride, int nt) {
  // the sequence of a batched launch: every array at its own offset, qc
  // and gravity at theirs (0 where the sequences share them)
  const size_t sq = blockIdx.x;
  R0 += sq * 9;
  p0 += sq * 3;
  v0 += sq * 3;
  bg += sq * 3;
  ba += sq * 3;
  last_ts += sq;
  prop_count += sq;
  ts += sq * nt;
  gyro += sq * nt * 3;
  acc += sq * nt * 3;
  valid += sq * nt;
  qc += sq * qc_stride;
  grav += sq * g_stride;
  P15_in += sq * kNN;
  R_out += sq * 9;
  p_out += sq * 3;
  v_out += sq * 3;
  lts_out += sq;
  pc_out += sq;
  P15_out += sq * kNN;
  acc_out += sq * kNN;
  outR += sq * nt * 9;
  outp += sq * nt * 3;
  outv += sq * nt * 3;
  outsig += sq * nt * 6;
  // Phi_acc in two buffers, read from one and written to the other a tick
  __shared__ __align__(16) T P15[kNN], Acc[2][kNN], Fd[kNN], Fd2[kNN], Pn[kNN];
  __shared__ __align__(16) T Phi[kN * kS], Tm[kN * kS], PG[kN * 12];

  const int t = threadIdx.x;
  const bool act = t < kNN;
  const int i = t / kN, j = t % kN;
  int cur = 0;

  // --- one round of loads: every thread the whole carried state, the
  // constants and tick 0's inputs (one address across a warp); P15 one
  // entry a thread ---
  T R[9], p[3], v[3], b_g[3], b_a[3], g[3], q[12];
  T c_gy[3], c_ac[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = p0[k];
    v[k] = v0[k];
    b_g[k] = bg[k];
    b_a[k] = ba[k];
    g[k] = grav[k];
    c_gy[k] = gyro[k];
    c_ac[k] = acc[k];
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) q[k] = qc[k];
  T lts = last_ts[0];
  long long pc = prop_count[0];
  T c_ts = ts[0];
  bool c_ok = valid[0] != 0;
  if (act) {
    P15[t] = P15_in[t];
    Acc[0][t] = (i == j) ? T(1) : T(0);
  }

  for (int b = 0; b < nt; ++b) {
    // tick b + 1's inputs, in flight during tick b's arithmetic
    T n_ts = c_ts, n_gy[3] = {c_gy[0], c_gy[1], c_gy[2]}, n_ac[3] = {c_ac[0], c_ac[1], c_ac[2]};
    bool n_ok = false;
    if (b + 1 < nt) {
      n_ts = ts[b + 1];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        n_gy[k] = gyro[(b + 1) * 3 + k];
        n_ac[k] = acc[(b + 1) * 3 + k];
      }
      n_ok = valid[b + 1] != 0;
    }

    // --- the serial section, in every thread's registers ---
    T gy[3], ac[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gy[k] = c_gy[k] - b_g[k];
      ac[k] = c_ac[k] - b_a[k];
    }
    const T dt = c_ts - lts;
    const T w_norm = sqrt_t(gy[0] * gy[0] + gy[1] * gy[1] + gy[2] * gy[2]);
    const T theta = w_norm * dt;
    const T wn = (w_norm < T(1e-30)) ? T(1) : w_norm;
    const T axis[3] = {gy[0] / wn, gy[1] / wn, gy[2] / wn};
    T Kx[9], KK[9], dR[9], Rnew[9];
    skew3(axis, Kx);
    mm3(Kx, Kx, KK);
    const T sn = sin_t(theta), cs = T(1) - cos_t(theta);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const T id = (k % 4 == 0) ? T(1) : T(0);
      dR[k] = (theta > T(0)) ? id + sn * Kx[k] + cs * KK[k] : id;
    }
    mm3(R, dR, Rnew);
    T aw[3], pnew[3], vnew[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)  // row form of R @ acc - g
      aw[r] = ac[0] * R[r * 3 + 0] + ac[1] * R[r * 3 + 1] + ac[2] * R[r * 3 + 2] - g[r];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pnew[k] = p[k] + v[k] * dt + T(0.5) * aw[k] * dt * dt;
      vnew[k] = v[k] + aw[k] * dt;
    }
    T ska[9], RskA[9], sg[9];
    skew3(ac, ska);
    mm3(Rnew, ska, RskA);
    skew3(gy, sg);

    // the null state and the fix-up's vectors
    const bool first = pc == 0;
    T Rn[9], vn[3], pn[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rn[k] = first ? ((k % 4 == 0) ? T(1) : T(0)) : R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vn[k] = first ? T(0) : v[k];
      pn[k] = first ? T(0) : p[k];
    }
    T u[3];
    mv3(Rn, g, u);
    const T uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
    const T sr[3] = {u[0] / uu, u[1] / uu, u[2] / uu};
    T dv[3], dp[3], sk[9], w1[3], w2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dv[k] = vn[k] - vnew[k];
      dp[k] = dt * vn[k] + pn[k] - pnew[k];
    }
    skew3(dv, sk);
    mv3(sk, g, w1);
    skew3(dp, sk);
    mv3(sk, g, w2);

    // --- Fdt, from the registers ---
    if (act) {
      T f = T(0);
      if (i < 3) {
        if (j < 3) f = -pick(sg, i * 3 + j);
        else if (j < 6) f = (j - 3 == i) ? T(-1) : T(0);
      } else if (i >= 6 && i < 9) {
        if (j < 3) f = -pick(RskA, (i - 6) * 3 + j);
        else if (j >= 9 && j < 12) f = -pick(Rnew, (i - 6) * 3 + (j - 9));
      } else if (i >= 12) {
        if (j >= 6 && j < 9) f = (j - 6 == i - 12) ? T(1) : T(0);
      }
      Fd[t] = f * dt;
    }
    __syncthreads();

    // --- Fdt^2 over the one block of terms that are not exact zeros ---
    if (act) {
      const int K = k_square(i / 3, j / 3);
      T a = T(0);
      if (K >= 0) {
#pragma unroll
        for (int k = 3 * K; k < 3 * K + 3; ++k) a = a + Fd[i * kN + k] * Fd[k * kN + j];
      }
      Fd2[t] = a;
    }
    __syncthreads();

    // --- Phi with the fix-up: the rotation block is Rnew Rn^T; an entry of
    // the velocity or position rows in columns 0-2 is corrected by its
    // owner, which forms the row's three Taylor entries itself ---
    if (act) {
      T x;
      if (i < 3 && j < 3) {
        x = pick(Rnew, i * 3 + 0) * pick(Rn, j * 3 + 0) +
            pick(Rnew, i * 3 + 1) * pick(Rn, j * 3 + 1) +
            pick(Rnew, i * 3 + 2) * pick(Rn, j * 3 + 2);
      } else if (j < 3 && ((i >= 6 && i < 9) || i >= 12)) {
        const T row[3] = {taylor(Fd, Fd2, i, 0), taylor(Fd, Fd2, i, 1), taylor(Fd, Fd2, i, 2)};
        const T Au = row[0] * u[0] + row[1] * u[1] + row[2] * u[2];
        const T w = (i < 9) ? pick(w1, i - 6) : pick(w2, i - 12);
        x = pick(row, j) - (Au - w) * pick(sr, j);
      } else {
        x = taylor(Fd, Fd2, i, j);
      }
      Phi[i * kS + j] = x;
    }
    __syncthreads();

    // --- PG = Phi G blockwise ---
    if (t < kN * 12) {
      const int r = t / 12, c = t % 12;
      const T* row = Phi + r * kS;
      T x;
      if (c < 3) x = -row[c];
      else if (c < 6) x = row[c];
      else if (c < 9) {
        const int cc = c - 6;
        x = -(row[6] * pick(Rnew, 0 * 3 + cc) + row[7] * pick(Rnew, 1 * 3 + cc) +
              row[8] * pick(Rnew, 2 * 3 + cc));
      } else x = row[c];
      PG[t] = x;
    }
    __syncthreads();

    // --- Tm = Phi P15, and Phi Phi_acc into the other buffer (the old
    // Phi_acc on a padding tick) ---
    if (act) {
      T ph[kS];
      load_row(Phi + i * kS, ph);
      T a = T(0), an = T(0);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        a = a + ph[k] * P15[k * kN + j];
        an = an + ph[k] * Acc[cur][k * kN + j];
      }
      Tm[i * kS + j] = a;
      Acc[cur ^ 1][t] = c_ok ? an : Acc[cur][t];
    }
    cur ^= 1;
    __syncthreads();

    // --- P15 <- Tm Phi^T + Q, Q = (PG * qc) PG^T dt ---
    if (act) {
      T gi[12], gj[12];
      load_row(PG + i * 12, gi);
      load_row(PG + j * 12, gj);
      T qs = T(0);
#pragma unroll
      for (int k = 0; k < 12; ++k) qs = qs + (gi[k] * q[k]) * gj[k];
      T ti[kS], pj[kS];
      load_row(Tm + i * kS, ti);
      load_row(Phi + j * kS, pj);
      T a = T(0);
#pragma unroll
      for (int k = 0; k < kN; ++k) a = a + ti[k] * pj[k];
      Pn[t] = a + qs * dt;
    }
    __syncthreads();

    // --- the masked commit, the per-tick outputs; P15's next readers are
    // behind the next tick's barriers ---
    if (act) {
      T x = P15[t];
      if (c_ok) {
        x = T(0.5) * (Pn[t] + Pn[j * kN + i]);
        P15[t] = x;
      }
      if (i == j && (i < 3 || i >= 12)) outsig[b * 6 + (i < 3 ? i : i - 9)] = x;
    }
    if (c_ok) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rnew[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = pnew[k];
        v[k] = vnew[k];
      }
      lts = c_ts;
      pc = pc + 1;
    }
    if (t < 9) outR[b * 9 + t] = pick(R, t);
    if (t < 3) {
      outp[b * 3 + t] = pick(p, t);
      outv[b * 3 + t] = pick(v, t);
    }
    c_ts = n_ts;
    c_ok = n_ok;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c_gy[k] = n_gy[k];
      c_ac[k] = n_ac[k];
    }
  }

  if (t < 9) R_out[t] = pick(R, t);
  if (t < 3) {
    p_out[t] = pick(p, t);
    v_out[t] = pick(v, t);
  }
  if (t == 0) {
    lts_out[0] = lts;
    pc_out[0] = pc;
  }
  if (act) {  // each entry its owner's, written by no other thread
    P15_out[t] = P15[t];
    acc_out[t] = Acc[cur][t];
  }
}

template <typename T>
int launch(void* const* a, int qc_stride, int g_stride, int nt, int B, cudaStream_t stream) {
  if (nt < 1 || B < 1 || qc_stride < 0 || g_stride < 0) return (int)cudaErrorInvalidValue;
  propagate_kernel<T><<<B, kThreads, 0, stream>>>(
      static_cast<const T*>(a[0]), static_cast<const T*>(a[1]), static_cast<const T*>(a[2]),
      static_cast<const T*>(a[3]), static_cast<const T*>(a[4]), static_cast<const T*>(a[5]),
      static_cast<const long long*>(a[6]), static_cast<const T*>(a[7]),
      static_cast<const T*>(a[8]), static_cast<const T*>(a[9]),
      static_cast<const unsigned char*>(a[10]), static_cast<const T*>(a[11]),
      static_cast<const T*>(a[12]), static_cast<const T*>(a[13]),
      static_cast<T*>(a[14]), static_cast<T*>(a[15]), static_cast<T*>(a[16]),
      static_cast<T*>(a[17]), static_cast<long long*>(a[18]), static_cast<T*>(a[19]),
      static_cast<T*>(a[20]), static_cast<T*>(a[21]), static_cast<T*>(a[22]),
      static_cast<T*>(a[23]), static_cast<T*>(a[24]), qc_stride, g_stride, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences, but qc and grav, whose
// strides a sequence are given (0 where the sequences share them); ts, gyro,
// acc, valid and the per-tick outputs hold nt ticks
#define PROPAGATE_ENTRY(NAME, T)                                                           \
  MSCKF_EXPORT int NAME(void* R0, void* p0, void* v0, void* bg, void* ba, void* last_ts,  \
                        void* prop_count, void* ts, void* gyro, void* acc, void* valid,   \
                        void* qc, void* grav, void* P15, void* R, void* p, void* v,        \
                        void* lts, void* pc, void* P15o, void* acc_o, void* outR,          \
                        void* outp, void* outv, void* outsig, int qc_stride,              \
                        int g_stride, int nt, int B, void* stream) {                      \
    void* const a[25] = {R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid,   \
                         qc, grav, P15, R, p, v, lts, pc, P15o, acc_o, outR, outp, outv,  \
                         outsig};                                                          \
    return launch<T>(a, qc_stride, g_stride, nt, B, static_cast<cudaStream_t>(stream));   \
  }

PROPAGATE_ENTRY(msckf_propagate_block_f32, float)
PROPAGATE_ENTRY(msckf_propagate_block_f64, double)
