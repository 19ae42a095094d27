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
// Design: one block of 256 threads per sequence. A single call is one
// block; the batched form (the JAX custom_vmap rule's batch grid,
// pallas_kernels.py:1197-1214) runs one block per sequence, each at its own
// base offsets, so every sequence gets the bits of a single launch. Thread
// 0 does the per-tick 3-vector and 3x3 work (integration, null states, the
// fix-up); the 15x15 products (Fdt^2, Fdt^3, Phi G, Q, Phi P15 Phi^T,
// Phi Phi_acc) run one entry per thread over shared memory. What bounds it
// on the H100: at nt = 1 it moves under 3 KB and does ~40 KFLOP per tick
// and sequence; its time is the launch latency and a dozen barriers per
// tick on one SM.
#include "common.cuh"

namespace {

constexpr int kN = 15;
constexpr int kNN = kN * kN;
constexpr int kThreads = 256;

template <typename T>
struct TickScalars {
  T R[9], p[3], v[3], lts;  // carried state
  long long pc;
  T gy[3], ac[3], dt;       // bias-corrected inputs of this tick
  T Rnew[9], pnew[3], vnew[3], RskA[9];
  int valid;
};

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
                 T* __restrict__ outsig, int nt) {
  // the sequence of a batched launch: every array at its own offset
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
  qc += sq * 12;
  grav += sq * 3;
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
  __shared__ TickScalars<T> s;
  __shared__ T P15[kNN], Acc[kNN], Fd[kNN], Fd2[kNN], Phi[kNN], Tm[kNN], Pn[kNN];
  __shared__ T PG[kN * 12];
  __shared__ T q[12], g[3];

  const int t = threadIdx.x;
  const bool act = t < kNN;
  const int i = t / kN, j = t - (t / kN) * kN;

  if (t == 0) {
    for (int k = 0; k < 9; ++k) s.R[k] = R0[k];
    for (int k = 0; k < 3; ++k) {
      s.p[k] = p0[k];
      s.v[k] = v0[k];
      g[k] = grav[k];
    }
    s.lts = last_ts[0];
    s.pc = prop_count[0];
  }
  if (t < 12) q[t] = qc[t];
  if (act) {
    P15[t] = P15_in[t];
    Acc[t] = (i == j) ? T(1) : T(0);
  }
  __syncthreads();

  for (int b = 0; b < nt; ++b) {
    // --- nominal integration and the per-tick 3x3 work (one thread) ---
    if (t == 0) {
      for (int k = 0; k < 3; ++k) {
        s.gy[k] = gyro[b * 3 + k] - bg[k];
        s.ac[k] = acc[b * 3 + k] - ba[k];
      }
      s.valid = valid[b] != 0;
      const T dt = ts[b] - s.lts;
      s.dt = dt;
      const T w_norm = sqrt_t(s.gy[0] * s.gy[0] + s.gy[1] * s.gy[1] + s.gy[2] * s.gy[2]);
      const T theta = w_norm * dt;
      const T wn = (w_norm < T(1e-30)) ? T(1) : w_norm;
      const T axis[3] = {s.gy[0] / wn, s.gy[1] / wn, s.gy[2] / wn};
      T Kx[9], KK[9], dR[9];
      skew3(axis, Kx);
      mm3(Kx, Kx, KK);
      const T sn = sin_t(theta), cs = T(1) - cos_t(theta);
      for (int k = 0; k < 9; ++k) {
        const T id = (k % 4 == 0) ? T(1) : T(0);
        dR[k] = (theta > T(0)) ? id + sn * Kx[k] + cs * KK[k] : id;
      }
      mm3(s.R, dR, s.Rnew);
      T aw[3];
      for (int r = 0; r < 3; ++r)  // row form of R @ acc - g
        aw[r] = s.ac[0] * s.R[r * 3 + 0] + s.ac[1] * s.R[r * 3 + 1] +
                s.ac[2] * s.R[r * 3 + 2] - g[r];
      for (int k = 0; k < 3; ++k) {
        s.pnew[k] = s.p[k] + s.v[k] * dt + T(0.5) * aw[k] * dt * dt;
        s.vnew[k] = s.v[k] + aw[k] * dt;
      }
      T ska[9];
      skew3(s.ac, ska);
      mm3(s.Rnew, ska, s.RskA);
    }
    __syncthreads();

    // --- Fdt, Fdt^2, Phi = I + Fdt + Fdt^2/2 + Fdt^3/6 ---
    if (act) {
      T f = T(0);
      if (i < 3) {
        if (j < 3) {
          T sg[9];
          skew3(s.gy, sg);
          f = -sg[i * 3 + j];
        } else if (j < 6) {
          f = (j - 3 == i) ? T(-1) : T(0);
        }
      } else if (i >= 6 && i < 9) {
        if (j < 3) f = -s.RskA[(i - 6) * 3 + j];
        else if (j >= 9 && j < 12) f = -s.Rnew[(i - 6) * 3 + (j - 9)];
      } else if (i >= 12) {
        if (j >= 6 && j < 9) f = (j - 6 == i - 12) ? T(1) : T(0);
      }
      Fd[t] = f * s.dt;
    }
    __syncthreads();
    if (act) {
      T a = T(0);
      for (int k = 0; k < kN; ++k) a = a + Fd[i * kN + k] * Fd[k * kN + j];
      Fd2[t] = a;
    }
    __syncthreads();
    if (act) {
      T a = T(0);
      for (int k = 0; k < kN; ++k) a = a + Fd2[i * kN + k] * Fd[k * kN + j];
      const T id = (i == j) ? T(1) : T(0);
      Phi[t] = id + Fd[t] + T(0.5) * Fd2[t] + (T(1) / T(6)) * a;
    }
    __syncthreads();

    // --- observability-constrained fix-up (one thread) ---
    if (t == 0) {
      const bool first = s.pc == 0;
      T Rn[9], vn[3], pn[3];
      for (int k = 0; k < 9; ++k) Rn[k] = first ? ((k % 4 == 0) ? T(1) : T(0)) : s.R[k];
      for (int k = 0; k < 3; ++k) {
        vn[k] = first ? T(0) : s.v[k];
        pn[k] = first ? T(0) : s.p[k];
      }
      T u[3];
      mv3(Rn, g, u);
      const T uu = u[0] * u[0] + u[1] * u[1] + u[2] * u[2];
      const T sr[3] = {u[0] / uu, u[1] / uu, u[2] / uu};
      T dv[3], dp[3], sk[9], w1[3], w2[3];
      for (int k = 0; k < 3; ++k) {
        dv[k] = vn[k] - s.vnew[k];
        dp[k] = s.dt * vn[k] + pn[k] - s.pnew[k];
      }
      skew3(dv, sk);
      mv3(sk, g, w1);
      skew3(dp, sk);
      mv3(sk, g, w2);
      T Av[9], Ap[9];
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
          Av[r * 3 + c] = Phi[(6 + r) * kN + c];
          Ap[r * 3 + c] = Phi[(12 + r) * kN + c];
        }
      T Au[3], Apu[3];
      mv3(Av, u, Au);
      mv3(Ap, u, Apu);
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
          Phi[(6 + r) * kN + c] = Av[r * 3 + c] - (Au[r] - w1[r]) * sr[c];
          Phi[(12 + r) * kN + c] = Ap[r * 3 + c] - (Apu[r] - w2[r]) * sr[c];
          Phi[r * kN + c] = s.Rnew[r * 3 + 0] * Rn[c * 3 + 0] +
                            s.Rnew[r * 3 + 1] * Rn[c * 3 + 1] +
                            s.Rnew[r * 3 + 2] * Rn[c * 3 + 2];
        }
    }
    __syncthreads();

    // --- PG = Phi G blockwise, then Q = (PG * qc) PG^T dt ---
    if (t < kN * 12) {
      const int r = t / 12, c = t - (t / 12) * 12;
      T x;
      if (c < 3) x = -Phi[r * kN + c];
      else if (c < 6) x = Phi[r * kN + c];
      else if (c < 9) {
        const int cc = c - 6;
        x = -(Phi[r * kN + 6] * s.Rnew[0 * 3 + cc] + Phi[r * kN + 7] * s.Rnew[1 * 3 + cc] +
              Phi[r * kN + 8] * s.Rnew[2 * 3 + cc]);
      } else x = Phi[r * kN + c];
      PG[t] = x;
    }
    __syncthreads();

    // --- P15 <- Phi P15 Phi^T + Q, Phi_acc <- Phi Phi_acc ---
    T acc_new = T(0), Qij = T(0);
    if (act) {
      for (int k = 0; k < 12; ++k) Qij = Qij + (PG[i * 12 + k] * q[k]) * PG[j * 12 + k];
      Qij = Qij * s.dt;
      T a = T(0);
      for (int k = 0; k < kN; ++k) {
        a = a + Phi[i * kN + k] * P15[k * kN + j];
        acc_new = acc_new + Phi[i * kN + k] * Acc[k * kN + j];
      }
      Tm[t] = a;
    }
    __syncthreads();
    if (act) {
      T a = T(0);
      for (int k = 0; k < kN; ++k) a = a + Tm[i * kN + k] * Phi[j * kN + k];
      Pn[t] = a + Qij;
      if (s.valid) Acc[t] = acc_new;  // all reads of Acc are behind the barrier
    }
    __syncthreads();
    if (act && s.valid) P15[t] = T(0.5) * (Pn[t] + Pn[j * kN + i]);
    __syncthreads();

    // --- masked commit of the nominal state, per-tick outputs ---
    if (t == 0 && s.valid) {
      for (int k = 0; k < 9; ++k) s.R[k] = s.Rnew[k];
      for (int k = 0; k < 3; ++k) {
        s.p[k] = s.pnew[k];
        s.v[k] = s.vnew[k];
      }
      s.lts = ts[b];
      s.pc = s.pc + 1;
    }
    __syncthreads();
    if (t < 9) outR[b * 9 + t] = s.R[t];
    if (t < 3) {
      outp[b * 3 + t] = s.p[t];
      outv[b * 3 + t] = s.v[t];
    }
    if (t < 6) {
      const int d = (t < 3) ? t : t + 9;
      outsig[b * 6 + t] = P15[d * kN + d];
    }
    __syncthreads();
  }

  if (t < 9) R_out[t] = s.R[t];
  if (t < 3) {
    p_out[t] = s.p[t];
    v_out[t] = s.v[t];
  }
  if (t == 0) {
    lts_out[0] = s.lts;
    pc_out[0] = s.pc;
  }
  if (act) {
    P15_out[t] = P15[t];
    acc_out[t] = Acc[t];
  }
}

template <typename T>
int launch(void* const* a, int nt, int B, cudaStream_t stream) {
  if (nt < 1 || B < 1) return (int)cudaErrorInvalidValue;
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
      static_cast<T*>(a[23]), static_cast<T*>(a[24]), nt);
  return (int)cudaGetLastError();
}

}  // namespace

// every array carries a leading axis of B sequences; ts, gyro, acc, valid
// and the per-tick outputs hold nt ticks
#define PROPAGATE_ENTRY(NAME, T)                                                           \
  MSCKF_EXPORT int NAME(void* R0, void* p0, void* v0, void* bg, void* ba, void* last_ts,  \
                        void* prop_count, void* ts, void* gyro, void* acc, void* valid,   \
                        void* qc, void* grav, void* P15, void* R, void* p, void* v,        \
                        void* lts, void* pc, void* P15o, void* acc_o, void* outR,          \
                        void* outp, void* outv, void* outsig, int nt, int B,              \
                        void* stream) {                                                    \
    void* const a[25] = {R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid,   \
                         qc, grav, P15, R, p, v, lts, pc, P15o, acc_o, outR, outp, outv,  \
                         outsig};                                                          \
    return launch<T>(a, nt, B, static_cast<cudaStream_t>(stream));                        \
  }

PROPAGATE_ENTRY(msckf_propagate_block_f32, float)
PROPAGATE_ENTRY(msckf_propagate_block_f64, double)
