"""Filter-consistency statistics: NEES and 3-sigma containment (port of
``msckf_tpu/utils/consistency.py``).

The Normalized Estimation Error Squared over the 6-dof pose error against
chi-square bounds, and per-axis 3-sigma containment fractions, computed in
numpy from the run's per-tick outputs.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2

from msckf_tpu_torch.utils.metrics import euler_xyz


def nees_series(
    gt_R: np.ndarray,  # (T, 3, 3)
    gt_t: np.ndarray,  # (T, 3)
    est_R: np.ndarray,
    est_t: np.ndarray,
    sigma_rot_diag: np.ndarray,  # (T, 3) error-state rotation variance diag
    sigma_pos_diag: np.ndarray,  # (T, 3) position variance diag
) -> np.ndarray:
    """Diagonal-covariance NEES over the 6-dof pose error.

    e = [theta_err (log map of R_gt^T R_est), p_est - p_gt];
    NEES_t = e^T diag(var)^{-1} e, chi-square(6) for a consistent filter.
    """
    eR = np.einsum("tji,tjk->tik", gt_R, est_R)
    tr = np.clip((np.trace(eR, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    ang = np.arccos(tr)
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(ang > 1e-9, ang / (2 * np.sin(ang)), 0.5)
    w = np.stack(
        [
            eR[:, 2, 1] - eR[:, 1, 2],
            eR[:, 0, 2] - eR[:, 2, 0],
            eR[:, 1, 0] - eR[:, 0, 1],
        ],
        axis=-1,
    ) * scale[:, None]
    ep = est_t - gt_t
    var = np.concatenate([sigma_rot_diag, sigma_pos_diag], axis=-1)
    var = np.maximum(var, 1e-30)
    e = np.concatenate([w, ep], axis=-1)
    return np.sum(e * e / var, axis=-1)


def nees_bounds(alpha: float = 0.05, dof: int = 6) -> tuple[float, float]:
    """Two-sided chi-square acceptance interval."""
    return float(chi2.ppf(alpha / 2, dof)), float(chi2.ppf(1 - alpha / 2, dof))


def consistency_report(gt_R, gt_t, est_R, est_t, sigma_rot, sigma_pos,
                       alpha: float = 0.05) -> dict:
    # leave out the ticks before initialization, where the filter reports
    # the constructor's zero covariance and NEES means nothing
    live = (np.sum(sigma_rot, axis=-1) + np.sum(sigma_pos, axis=-1)) > 1e-20
    gt_R, gt_t = gt_R[live], gt_t[live]
    est_R, est_t = est_R[live], est_t[live]
    sigma_rot, sigma_pos = sigma_rot[live], sigma_pos[live]
    nees = nees_series(gt_R, gt_t, est_R, est_t, sigma_rot, sigma_pos)
    lo, hi = nees_bounds(alpha)
    pos_in = np.abs(est_t - gt_t) <= 3 * np.sqrt(np.maximum(sigma_pos, 0))
    eR = np.einsum("tji,tjk->tik", gt_R, est_R)
    rot_in = np.abs(euler_xyz(eR)) <= 3 * np.sqrt(np.maximum(sigma_rot, 0))
    return {
        "nees_mean": float(np.mean(nees)),
        # the mean is dominated by the first ticks after initialization,
        # where the orientation error is finite but the covariance starts
        # near 0; the median is the representative statistic
        "nees_median": float(np.median(nees)),
        "nees_within_bounds": float(np.mean((nees >= lo) & (nees <= hi))),
        "nees_lo": lo,
        "nees_hi": hi,
        "ate_within_3sigma": float(np.mean(pos_in.all(axis=1))),
        "aoe_within_3sigma": float(np.mean(rot_in.all(axis=1))),
    }
