"""Trajectory error metrics and the results report (port of
``msckf_tpu/utils/metrics.py``).

Relative translation and orientation errors (RTE/ROE, spike-smoothed
against a 10-sample rolling mean), absolute errors with 3-sigma bounds from
the filter covariance, relative RMSE, and the results.txt summary: numpy
over the whole per-tick trace, after the run.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _rel(R0, t0, R1, t1):
    """T_0^-1 * T_1 for stacked pose arrays."""
    Rr = np.einsum("tji,tjk->tik", R0, R1)
    tr = np.einsum("tji,tj->ti", R0, t1 - t0)
    return Rr, tr


def rotation_angle(R: np.ndarray) -> np.ndarray:
    """Geodesic angle: arccos((trace(R) - 1)/2), clipped."""
    tr = np.trace(R, axis1=-2, axis2=-1)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def euler_xyz(R: np.ndarray) -> np.ndarray:
    """Intrinsic XYZ euler angles of R = Rx(a) Ry(b) Rz(c), scipy's 'XYZ'
    (the JAX package's ``ops/geometry.py::R_to_euler_xyz_intrinsic``)."""
    R = np.asarray(R)
    b = np.arcsin(np.clip(R[..., 0, 2], -1.0, 1.0))
    a = np.arctan2(-R[..., 1, 2], R[..., 2, 2])
    c = np.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return np.stack([a, b, c], axis=-1)


@dataclasses.dataclass
class TrajectoryMetrics:
    rte: np.ndarray  # (T,) smoothed relative translation error ratio
    roe: np.ndarray  # (T,)
    ate: np.ndarray  # (T, 3) absolute translation error (gt frame)
    ate_bounds: np.ndarray  # (T, 3) 3-sigma bounds
    aoe: np.ndarray  # (T, 3) absolute orientation error euler XYZ
    aoe_bounds: np.ndarray  # (T, 3)
    rmse_position: float
    rmse_orientation: float
    mean_rte: float
    std_rte: float
    mean_roe: float
    std_roe: float

    def consistency_fraction(self) -> tuple[float, float]:
        """Fraction of ticks with |ATE|, |AOE| inside the 3-sigma envelope."""
        pos = float(np.mean(np.all(np.abs(self.ate) <= self.ate_bounds + 1e-12, axis=1)))
        rot = float(np.mean(np.all(np.abs(self.aoe) <= self.aoe_bounds + 1e-12, axis=1)))
        return pos, rot


def _smooth(raw: np.ndarray) -> np.ndarray:
    """Spike smoothing: a value above 10x the mean of the last 10 kept values
    becomes 0.001 * v + 0.999 * that mean."""
    out = np.empty_like(raw)
    window: list[float] = []
    for i, v in enumerate(raw):
        if window and v > 10 * np.mean(window):
            v = 0.001 * v + 0.999 * np.mean(window)
        out[i] = v
        window.append(v)
        if len(window) > 10:
            window.pop(0)
    return out


def compute_metrics(
    gt_R: np.ndarray,  # (T, 3, 3)
    gt_t: np.ndarray,  # (T, 3)
    est_R: np.ndarray,  # (T, 3, 3)
    est_t: np.ndarray,  # (T, 3)
    sigma_rot_diag: np.ndarray,  # (T, 3) diag of P[0:3,0:3]
    sigma_pos_diag: np.ndarray,  # (T, 3) diag of P[12:15,12:15]
) -> TrajectoryMetrics:
    eye = np.broadcast_to(np.eye(3), (1, 3, 3))
    zero = np.zeros((1, 3))
    # previous-tick poses, identity at t = 0
    gt_R0 = np.concatenate([eye, gt_R[:-1]])
    gt_t0 = np.concatenate([zero, gt_t[:-1]])
    est_R0 = np.concatenate([eye, est_R[:-1]])
    est_t0 = np.concatenate([zero, est_t[:-1]])

    dR_gt, dt_gt = _rel(gt_R0, gt_t0, gt_R, gt_t)
    dR_est, dt_est = _rel(est_R0, est_t0, est_R, est_t)

    rel_trans_gt = np.linalg.norm(dt_gt, axis=-1)
    rel_rot_gt = rotation_angle(dR_gt)

    eR, et = _rel(dR_gt, dt_gt, dR_est, dt_est)
    rel_trans_err = np.linalg.norm(et, axis=-1)
    rel_rot_err = rotation_angle(eR)

    with np.errstate(divide="ignore", invalid="ignore"):
        rte_raw = np.where(rel_trans_gt != 0, rel_trans_err / rel_trans_gt, 0.0)
        roe_raw = np.where(rel_rot_gt != 0, rel_rot_err / rel_rot_gt, 0.0)
    rte = _smooth(rte_raw)
    roe = _smooth(roe_raw)

    # absolute pose error: T_gt^-1 * T_est
    aR, at = _rel(gt_R, gt_t, est_R, est_t)
    return TrajectoryMetrics(
        rte=rte,
        roe=roe,
        ate=at,
        ate_bounds=3.0 * np.sqrt(np.maximum(sigma_pos_diag, 0.0)),
        aoe=euler_xyz(aR),
        aoe_bounds=3.0 * np.sqrt(np.maximum(sigma_rot_diag, 0.0)),
        rmse_position=float(np.round(np.sqrt(np.mean(rte_raw**2)), 8)),
        rmse_orientation=float(np.round(np.sqrt(np.mean(roe_raw**2)), 8)),
        mean_rte=float(np.round(np.mean(rte), 8)),
        std_rte=float(np.round(np.std(rte), 8)),
        mean_roe=float(np.round(np.mean(roe), 8)),
        std_roe=float(np.round(np.std(roe), 8)),
    )


def results_report(m: TrajectoryMetrics, profiling: dict | None = None) -> str:
    """The results.txt format."""
    s = "VIO:\n"
    s += " - RTE %:\n"
    s += f"   - Mean:           {m.mean_rte} - {m.mean_rte * 100} %\n"
    s += f"   - Std:            {m.std_rte} - {m.std_rte * 100} %\n"
    s += " - ROE %:\n"
    s += f"   - Mean:           {m.mean_roe} - {m.mean_roe * 100} %\n"
    s += f"   - Std:            {m.std_roe} - {m.std_roe * 100} %\n"
    s += " - RMSE %:\n"
    s += f"   - Position:       {m.rmse_position}\n"
    s += f"   - Orientation:    {m.rmse_orientation}\n"
    if profiling:
        s += " - Profiling:\n"
        for k, v in profiling.items():
            s += f"   - {k}: {v}\n"
    return s
