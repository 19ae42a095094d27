"""IMU nominal-state integration and OC-EKF error-state propagation
(port of ``msckf_tpu/filter/propagation.py``).

Error-state ordering is the reference's: [dtheta 0:3, dbg 3:6, dv 6:9,
dba 9:12, dp 12:15]. A block of B IMU ticks touches the padded covariance
once: the 15x15 IMU block runs the per-tick recurrence, and the cross block
is updated as P_ic <- Phi_acc P_ic with Phi_acc = Phi_B ... Phi_1.

``integrate_nominal`` and ``propagate`` (one ``process_imu`` tick on the
whole padded covariance) are the public one-tick surface.
``propagate_block`` keeps the JAX package's block-size dispatch:
B <= 2 -> one fused kernel (``ops/kernels.py::propagate_block_fused``);
3 <= B <= 64 -> batched Phi/Qd in PyTorch plus the P15 recurrence kernel;
B > 64 -> a plain per-tick loop.
"""

from __future__ import annotations

import numpy as np
import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import FilterState, ImuState, device_consts
from msckf_tpu_torch.ops import kernels
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.geometry import rodrigues_unit, skew
from msckf_tpu_torch.ops.precision import with_f32_matmuls
from msckf_tpu_torch.utils import tracing


def _with_imu_block(P: torch.Tensor, P15: torch.Tensor, Phi_acc: torch.Tensor):
    """P with its IMU block replaced by P15 and its cross blocks mapped by
    Phi_acc (padded camera rows are zero, so the padded product is exact)."""
    P_ic = Phi_acc @ P[:15, 15:]
    top = torch.cat([P15, P_ic], dim=1)
    bottom = torch.cat([P_ic.T, P[15:, 15:]], dim=1)
    return torch.cat([top, bottom], dim=0)


def integrate_nominal(imu: ImuState, acc: torch.Tensor, gyro: torch.Tensor,
                      dt: torch.Tensor, gravity: torch.Tensor):
    """Nominal-state integration of one tick: (R, p, v) after it. acc and
    gyro are bias-corrected body-frame measurements; the rotation is the
    closed-form Rodrigues increment about the unit gyro axis, velocity and
    position explicit Euler with the 1/2 a dt^2 term."""
    w_norm = torch.linalg.vector_norm(gyro)
    theta = w_norm * dt
    axis = gyro / torch.where(w_norm < 1e-30, torch.ones_like(w_norm), w_norm)
    I3 = torch.eye(3, dtype=gyro.dtype, device=gyro.device)
    dR = torch.where(theta > 0, rodrigues_unit(axis, theta), I3)
    R_new = imu.R_WI @ dR
    a_world = imu.R_WI @ acc - gravity
    p_new = imu.p_WI + imu.v_WI * dt + 0.5 * a_world * dt * dt
    v_new = imu.v_WI + a_world * dt
    return R_new, p_new, v_new


def _as_input(x, dev: torch.device) -> torch.Tensor:
    """A measurement on ``dev``: a tensor as it is, an array as float64 (the
    filter casts it to its dtype, as the JAX package does)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


@with_f32_matmuls
def propagate(cfg: MSCKFConfig, state: FilterState, gyro, acc, timestamp,
              device=None) -> FilterState:
    """One ``process_imu`` step on ``device`` (the GPU unless
    ``device="cpu"``), where ``state`` must already live: the nominal state
    integrated, and the padded covariance propagated as
    P_II <- Phi P_II Phi^T + Q, P_IC <- Phi P_IC, then symmetrized (invalid
    camera rows and columns of P are zero, so the padded product is exact).
    gyro and acc are (3,) raw measurements, timestamp the tick's time."""
    dev = resolve_device(device)
    check_on_device(state.P, dev, "the filter state")
    imu_new, Phi, Q = _phi_q_for_tick(cfg, state.imu, _as_input(gyro, dev),
                                      _as_input(acc, dev), _as_input(timestamp, dev))
    P = _with_imu_block(state.P, Phi @ state.P[:15, :15] @ Phi.T + Q, Phi)
    return state.replace(imu=imu_new, P=0.5 * (P + P.T))


def _phi_q_for_tick(cfg: MSCKFConfig, imu: ImuState, gyro, acc, timestamp):
    """One tick: nominal integration + OC-constrained Phi and discrete Q."""
    dt_ = cfg.jdtype
    c = device_consts(cfg, imu.R_WI.device)
    dt = (timestamp - imu.timestamp).to(dt_)
    gyro = gyro.to(dt_) - imu.bg
    acc = acc.to(dt_) - imu.ba
    gravity = c.gravity
    I3 = torch.eye(3, dtype=dt_, device=gravity.device)
    Z3 = torch.zeros_like(I3)

    first = imu.prop_count == 0
    R_null = torch.where(first, I3, imu.R_WI)
    v_null = torch.where(first, torch.zeros_like(imu.v_WI), imu.v_WI)
    p_null = torch.where(first, torch.zeros_like(imu.p_WI), imu.p_WI)

    R_new, p_new, v_new = integrate_nominal(imu, acc, gyro, dt, gravity)

    F = torch.cat([
        torch.cat([-skew(gyro), -I3, Z3, Z3, Z3], dim=1),
        torch.zeros(3, 15, dtype=dt_, device=I3.device),
        torch.cat([-R_new @ skew(acc), Z3, Z3, -R_new, Z3], dim=1),
        torch.zeros(3, 15, dtype=dt_, device=I3.device),
        torch.cat([Z3, Z3, I3, Z3, Z3], dim=1),
    ], dim=0)
    Fdt = F * dt
    Fdt2 = Fdt @ Fdt
    Phi = torch.eye(15, dtype=dt_, device=I3.device) + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)
    Phi = Phi.clone()
    Phi[0:3, 0:3] = R_new @ R_null.T
    u = R_null @ gravity
    s = u / (u @ u)
    A_vel = Phi[6:9, 0:3].clone()
    A_pos = Phi[12:15, 0:3].clone()
    w1 = skew(v_null - v_new) @ gravity
    w2 = skew(dt * v_null + p_null - p_new) @ gravity
    Phi[6:9, 0:3] = A_vel - (A_vel @ u - w1)[:, None] * s[None, :]
    Phi[12:15, 0:3] = A_pos - (A_pos @ u - w2)[:, None] * s[None, :]

    Qc = torch.diag(c.qc)
    G = torch.cat([
        torch.cat([-I3, Z3, Z3, Z3], dim=1),
        torch.cat([Z3, I3, Z3, Z3], dim=1),
        torch.cat([Z3, Z3, -R_new, Z3], dim=1),
        torch.cat([Z3, Z3, Z3, I3], dim=1),
        torch.zeros(3, 12, dtype=dt_, device=I3.device),
    ], dim=0)
    PG = Phi @ G
    Q = PG @ Qc @ PG.T * dt

    imu_new = imu.replace(
        R_WI=R_new, p_WI=p_new, v_WI=v_new,
        timestamp=timestamp.to(dt_),
        step_id=imu.step_id + 1,
        prop_count=imu.prop_count + 1,
    )
    return imu_new, Phi, Q


@tracing.span("propagate")
def propagate_block(cfg: MSCKFConfig, state: FilterState, ts_b, gyro_b, acc_b, valid_b):
    """Propagate a block of B IMU ticks; returns (state, per-tick outputs
    (R (B,3,3), p (B,3), v (B,3), sigma_rot (B,3), sigma_pos (B,3), valid))."""
    if cfg.use_pallas and cfg.use_pallas_propagation:
        B = ts_b.shape[0]
        if B <= 2:
            return _propagate_block_fused(cfg, state, ts_b, gyro_b, acc_b, valid_b)
        if B <= 64:
            return _propagate_block_hybrid(cfg, state, ts_b, gyro_b, acc_b, valid_b)
    return _propagate_block_scan(cfg, state, ts_b, gyro_b, acc_b, valid_b)


def _prefix_product(dR: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product dR_0 @ ... @ dR_j for every j, by doubling:
    ceil(log2 B) batched matmuls instead of B sequential ones."""
    Q = dR
    shift = 1
    while shift < Q.shape[0]:
        Q = torch.cat([Q[:shift], Q[:-shift] @ Q[shift:]], dim=0)
        shift *= 2
    return Q


def _phi_q_block(cfg: MSCKFConfig, imu: ImuState, ts_b, gyro_b, acc_b, valid_b):
    """Per-tick Phi/Qd for a whole block as batched tensor ops.

    Padding ticks (a block suffix) get dt = 0, identity Phi and zero Qd.
    Returns (imu_new, Phi (B,15,15), Qd (B,15,15), per-tick R/p/v)."""
    dt_ = cfg.jdtype
    dev = imu.R_WI.device
    c = device_consts(cfg, dev)
    B = ts_b.shape[0]
    gravity = c.gravity
    gyro_b = gyro_b.to(dt_) - imu.bg  # biases constant within a block
    acc_b = acc_b.to(dt_) - imu.ba
    zero = torch.zeros((), dtype=dt_, device=dev)

    ts_prev = torch.cat([imu.timestamp[None], ts_b[:-1].to(dt_)])
    dt_s = torch.where(valid_b, ts_b.to(dt_) - ts_prev, zero)

    w_norm = torch.linalg.vector_norm(gyro_b, dim=-1)
    theta = w_norm * dt_s
    axis = gyro_b / torch.where(w_norm < 1e-30, torch.ones_like(w_norm), w_norm)[:, None]
    I3b = torch.eye(3, dtype=dt_, device=dev).expand(B, 3, 3)
    dR = torch.where((theta > 0)[:, None, None], rodrigues_unit(axis, theta), I3b)
    R_s = imu.R_WI @ _prefix_product(dR)  # R after each tick
    R_prev = torch.cat([imu.R_WI[None], R_s[:-1]], dim=0)

    a_world = torch.einsum("bij,bj->bi", R_prev, acc_b) - gravity
    dv = a_world * dt_s[:, None]
    v_s = imu.v_WI + torch.cumsum(dv, dim=0)
    v_prev = torch.cat([imu.v_WI[None], v_s[:-1]], dim=0)
    dp = v_prev * dt_s[:, None] + 0.5 * a_world * (dt_s * dt_s)[:, None]
    p_s = imu.p_WI + torch.cumsum(dp, dim=0)
    p_prev = torch.cat([imu.p_WI[None], p_s[:-1]], dim=0)

    # null states: pre-tick values, constructor identity on the filter's
    # very first propagation step (padding is only ever a block suffix)
    first = (imu.prop_count + torch.arange(B, device=dev)) == 0
    Rn_s = torch.where(first[:, None, None], I3b, R_prev)
    vn_s = torch.where(first[:, None], zero, v_prev)
    pn_s = torch.where(first[:, None], zero, p_prev)

    n_valid = valid_b.sum()
    R_f, p_f, v_f = R_s[-1], p_s[-1], v_s[-1]  # frozen through padding
    # index_select, not ts_b[tensor]: a 0-dim tensor index is read on the host
    last = torch.clamp(n_valid - 1, min=0).reshape(1)
    ts_f = torch.where(n_valid > 0, ts_b.index_select(0, last)[0].to(dt_), imu.timestamp)

    Z = torch.zeros(B, 3, 3, dtype=dt_, device=dev)
    sk_g = skew(gyro_b)
    Rska = R_s @ skew(acc_b)
    Z15 = torch.zeros(B, 3, 15, dtype=dt_, device=dev)
    F = torch.cat([
        torch.cat([-sk_g, -I3b, Z, Z, Z], dim=-1),
        Z15,
        torch.cat([-Rska, Z, Z, -R_s, Z], dim=-1),
        Z15,
        torch.cat([Z, Z, I3b, Z, Z], dim=-1),
    ], dim=-2)  # (B, 15, 15)

    Fdt = F * dt_s[:, None, None]
    Fdt2 = Fdt @ Fdt
    I15 = torch.eye(15, dtype=dt_, device=dev).expand(B, 15, 15)
    Phi = (I15 + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)).clone()
    Phi[:, 0:3, 0:3] = R_s @ Rn_s.transpose(-1, -2)
    u = torch.einsum("bij,j->bi", Rn_s, gravity)
    s = u / torch.sum(u * u, dim=-1, keepdim=True)
    A_vel = Phi[:, 6:9, 0:3].clone()
    A_pos = Phi[:, 12:15, 0:3].clone()
    w1 = torch.einsum("bij,j->bi", skew(vn_s - v_s), gravity)
    w2 = torch.einsum("bij,j->bi", skew(dt_s[:, None] * vn_s + pn_s - p_s), gravity)
    Au = torch.einsum("bij,bj->bi", A_vel, u)
    Ap = torch.einsum("bij,bj->bi", A_pos, u)
    Phi[:, 6:9, 0:3] = A_vel - (Au - w1)[..., None] * s[:, None, :]
    Phi[:, 12:15, 0:3] = A_pos - (Ap - w2)[..., None] * s[:, None, :]

    # PG = Phi @ G blockwise (G's sparsity)
    PG = torch.cat(
        [-Phi[:, :, 0:3], Phi[:, :, 3:6], -(Phi[:, :, 6:9] @ R_s), Phi[:, :, 9:12]],
        dim=-1,
    )  # (B, 15, 12)
    Qd = (PG * c.qc) @ PG.transpose(-1, -2) * dt_s[:, None, None]

    vmask = valid_b[:, None, None]
    Phi = torch.where(vmask, Phi, I15)
    Qd = torch.where(vmask, Qd, zero)

    imu_new = imu.replace(
        R_WI=R_f, p_WI=p_f, v_WI=v_f, timestamp=ts_f,
        step_id=imu.step_id + n_valid, prop_count=imu.prop_count + n_valid,
    )
    R_tel = torch.where(valid_b[:, None, None], R_s, R_f)
    p_tel = torch.where(valid_b[:, None], p_s, p_f)
    v_tel = torch.where(valid_b[:, None], v_s, v_f)
    return imu_new, Phi, Qd, (R_tel, p_tel, v_tel)


def _propagate_block_hybrid(cfg, state: FilterState, ts_b, gyro_b, acc_b, valid_b):
    """Batched Phi/Qd + the P15 recurrence kernel."""
    imu_new, Phi, Qd, (R_tel, p_tel, v_tel) = _phi_q_block(
        cfg, state.imu, ts_b, gyro_b, acc_b, valid_b
    )
    P15, Phi_acc, sig = kernels.p15_recurrence_fused(
        state.P[:15, :15].contiguous(), Phi.contiguous(), Qd.contiguous()
    )
    P = _with_imu_block(state.P, P15, Phi_acc)
    outs = (R_tel, p_tel, v_tel, sig[:, 0:3], sig[:, 3:6], valid_b)
    return state.replace(imu=imu_new, P=P), outs


def _propagate_block_fused(cfg, state: FilterState, ts_b, gyro_b, acc_b, valid_b):
    """The whole block in one kernel."""
    dt_ = cfg.jdtype
    c = device_consts(cfg, state.device)
    imu = state.imu
    (R, p, v, last_ts, prop_count, P15, Phi_acc,
     outR, outp, outv, outsig) = kernels.propagate_block_fused(
        imu.R_WI.contiguous(), imu.p_WI, imu.v_WI, imu.bg, imu.ba,
        imu.timestamp, imu.prop_count,
        ts_b.to(dt_).contiguous(), gyro_b.to(dt_).contiguous(),
        acc_b.to(dt_).contiguous(), valid_b.contiguous(),
        c.qc, c.gravity, state.P[:15, :15].contiguous(),
    )
    imu_new = imu.replace(
        R_WI=R, p_WI=p, v_WI=v, timestamp=last_ts,
        step_id=imu.step_id + valid_b.sum(), prop_count=prop_count,
    )
    P = _with_imu_block(state.P, P15, Phi_acc)
    outs = (outR, outp, outv, outsig[:, 0:3], outsig[:, 3:6], valid_b)
    return state.replace(imu=imu_new, P=P), outs


def _propagate_block_scan(cfg, state: FilterState, ts_b, gyro_b, acc_b, valid_b):
    """B sequential ticks in a Python loop, touching the padded covariance
    once at the end (the per-tick symmetrization only changes P15)."""
    dt_ = cfg.jdtype
    imu = state.imu
    P15 = state.P[:15, :15]
    Phi_acc = torch.eye(15, dtype=dt_, device=state.device)
    outs = []
    for i in range(ts_b.shape[0]):
        valid = valid_b[i]
        imu_new, Phi, Q = _phi_q_for_tick(cfg, imu, gyro_b[i], acc_b[i], ts_b[i])
        P15_new = Phi @ P15 @ Phi.T + Q
        P15_new = 0.5 * (P15_new + P15_new.T)
        Phi_acc_new = Phi @ Phi_acc
        imu = ImuState(*(
            torch.where(valid, getattr(imu_new, f), getattr(imu, f))
            for f in ImuState.__dataclass_fields__
        ))
        P15 = torch.where(valid, P15_new, P15)
        Phi_acc = torch.where(valid, Phi_acc_new, Phi_acc)
        outs.append((imu.R_WI, imu.p_WI, imu.v_WI,
                     torch.diagonal(P15[0:3, 0:3]), torch.diagonal(P15[12:15, 12:15])))
    R, p, v, s_rot, s_pos = (torch.stack(x) for x in zip(*outs))
    P = _with_imu_block(state.P, P15, Phi_acc)
    return state.replace(imu=imu, P=P), (R, p, v, s_rot, s_pos, valid_b)
