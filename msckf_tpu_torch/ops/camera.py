"""Pinhole camera model as batched functions on tensors (port of
``msckf_tpu/ops/camera.py``).

Projection with behind-camera and field-of-view validity, inverse
projection to a camera-frame ray, frame transforms, and the measurement
Jacobians. The filter inlines these formulas in its fused paths
(``filter/update.py``, ``filter/verification.py``); this module is the
public surface. Every function batches over leading dims and returns
tensors on its inputs' device.
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.ops.geometry import skew
from msckf_tpu_torch.ops.smallmat import matmul_small, matvec_small, transpose_small


def project_point(K: torch.Tensor, width: int, height: int, Ci_p: torch.Tensor):
    """(valid, pixel): pinhole projection with z > 0 and field-of-view
    checks. Invalid entries still carry their projected coordinates: mask
    with ``valid``."""
    z = Ci_p[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-30, torch.full_like(z, 1e-30), z)
    uvw = matvec_small(K.expand(Ci_p.shape[:-1] + (3, 3)), Ci_p)
    uv = uvw[..., :2] / z_safe
    valid = (
        (Ci_p[..., 2] > 0)
        & (uv[..., 0] >= 0)
        & (uv[..., 0] < width)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] < height)
    )
    return valid, uv


def inverse_project_point(K_inv: torch.Tensor, Im_p: torch.Tensor) -> torch.Tensor:
    """Pixel to camera-frame ray K^-1 [u, v, 1]."""
    homog = torch.cat([Im_p, torch.ones_like(Im_p[..., :1])], dim=-1)
    return matvec_small(K_inv.expand(homog.shape[:-1] + (3, 3)), homog)


def cam_to_world(R_WC: torch.Tensor, t_WC: torch.Tensor, Ci_n: torch.Tensor,
                 is_versor: bool = False) -> torch.Tensor:
    """A camera-frame point (or, with ``is_versor``, direction) in the world."""
    out = matvec_small(R_WC, Ci_n)
    return out if is_versor else out + t_WC


def world_to_cam(R_WC: torch.Tensor, t_WC: torch.Tensor, W_n: torch.Tensor,
                 is_versor: bool = False) -> torch.Tensor:
    """A world point (or, with ``is_versor``, direction) in the camera frame."""
    return matvec_small(transpose_small(R_WC), W_n if is_versor else W_n - t_WC)


def measurement_jacobians(R_WC: torch.Tensor, Ci_f: torch.Tensor):
    """(H_x (..., 2, 6), H_f (..., 2, 3)) about a camera-frame point:
    J = d(normalized image point)/d(Ci_f), H_x = [J [Ci_f]_x, -J R_CW],
    H_f = J R_CW."""
    z = Ci_f[..., 2]
    z_safe = torch.where(z.abs() < 1e-30, torch.full_like(z, 1e-30), z)
    inv_z = 1.0 / z_safe
    zero = torch.zeros_like(inv_z)
    J = torch.stack(
        [
            torch.stack([inv_z, zero, -Ci_f[..., 0] * inv_z * inv_z], -1),
            torch.stack([zero, inv_z, -Ci_f[..., 1] * inv_z * inv_z], -1),
        ],
        dim=-2,
    )
    H_f = matmul_small(J, transpose_small(R_WC))
    H_x = torch.cat([matmul_small(J, skew(Ci_f)), -H_f], dim=-1)
    return H_x, H_f
