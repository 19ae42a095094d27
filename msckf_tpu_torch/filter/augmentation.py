"""Camera-state augmentation on the padded covariance
(port of ``msckf_tpu/filter/augmentation.py``).

The new camera goes into slot ``n`` by a masked write, and the covariance
grows by the rank-6 expansion P[new, :] = J P, P[new, new] = J P J^T with
J nonzero only at columns 0:3 and 12:15. The slot index stays on the
device: the writes are masks and gathers, never a host-side index.
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import FilterState, device_consts
from msckf_tpu_torch.ops.geometry import skew
from msckf_tpu_torch.utils import tracing


@tracing.span("augment")
def state_augmentation(cfg: MSCKFConfig, state: FilterState) -> FilterState:
    dt_ = cfg.jdtype
    dev = state.device
    c = device_consts(cfg, dev)
    imu = state.imu
    D = cfg.err_dim
    R_IC, t_IC = c.R_IC, c.t_IC

    R_WC = imu.R_WI @ R_IC
    t_WC = imu.R_WI @ t_IC + imu.p_WI

    n = state.cams.n
    cams = state.cams
    slot = torch.arange(cfg.n_cam_slots, device=dev) == n  # (N,)
    cams = cams.replace(
        R=torch.where(slot[:, None, None], R_WC[None], cams.R),
        t=torch.where(slot[:, None], t_WC[None], cams.t),
        cam_id=torch.where(slot, imu.step_id, cams.cam_id),
        valid=cams.valid | slot,
        n=n + 1,
    )

    # J rows (6 x D), nonzero only at cols 0:3 and 12:15
    zeros3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    J_theta = torch.cat([R_IC.T, skew(imu.R_WI @ t_IC)], dim=0)  # (6, 3)
    J_p = torch.cat([zeros3, torch.eye(3, dtype=dt_, device=dev)], dim=0)

    P = state.P
    new_row = J_theta @ P[0:3, :] + J_p @ P[12:15, :]  # (6, D)
    new_diag = new_row[:, 0:3] @ J_theta.T + new_row[:, 12:15] @ J_p.T  # (6, 6)

    # place new_row at rows r0..r0+5 (and its transpose at those columns)
    r0 = 15 + 6 * n
    rows = torch.arange(D, device=dev)
    rowmask = (rows >= r0) & (rows < r0 + 6)
    local = torch.clamp(rows - r0, 0, 5)  # row of new_row feeding each P row
    placed = new_row[local]  # (D, D); only the rowmask rows are used
    P = torch.where(rowmask[:, None], placed, P)
    P = torch.where(rowmask[None, :], placed.T, P)
    placed_diag = new_diag[local][:, local]
    P = torch.where(rowmask[:, None] & rowmask[None, :], placed_diag, P)
    P = 0.5 * (P + P.T)
    return state.replace(cams=cams, P=P)
