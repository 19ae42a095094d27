"""Masked multi-view line intersection
(port of ``msckf_tpu/ops/triangulation.py::intersect_lines``)."""

from __future__ import annotations

import torch

from msckf_tpu_torch.ops.smallmat import default_rcond, matvec_small, tikhonov_inv_sym3


def intersect_lines(
    bases: torch.Tensor,  # (..., M, 3) line base points (camera centers)
    directions: torch.Tensor,  # (..., M, 3) line directions (need not be unit)
    confidences: torch.Tensor,  # (..., M)
    mask: torch.Tensor,  # (..., M) bool — valid observations
) -> torch.Tensor:
    """Weighted least-squares intersection of a masked bundle of 3D lines:
    X = sum_i w_i (I - d_i d_i^T), y = sum_i w_i (I - d_i d_i^T) b_i,
    p = X^+ y, with invalid rows contributing zero. Batched over leading dims
    (the JAX package vmaps the single-bundle form)."""
    norm = torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    d = directions / torch.clamp(norm, min=1e-30)
    w = torch.where(mask, confidences, torch.zeros_like(confidences))
    I = torch.eye(3, dtype=bases.dtype, device=bases.device)
    P = I - d[..., :, None] * d[..., None, :]  # (..., M, 3, 3)
    Pw = P * w[..., None, None]
    X = torch.sum(Pw, dim=-3)
    y = torch.sum(matvec_small(Pw, bases), dim=-2)
    # y lies in range(X), so the Tikhonov solve equals pinv(X) y to O(rcond)
    Xi = tikhonov_inv_sym3(X, default_rcond(bases.dtype))
    return matvec_small(Xi, y)
