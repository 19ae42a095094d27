"""Small-matrix algebra written out element by element
(port of ``msckf_tpu/ops/smallmat.py``).

The closed forms keep the arithmetic of the JAX package, so the port agrees
with it to round-off: ``tikhonov_inv_sym3`` trace-normalizes before the
adjugate inverse (no f32 overflow on 1/z^2-scaled Gram matrices), and
``polar_orthonormalize`` runs three Newton-Schulz steps to the polar factor.
"""

from __future__ import annotations

import torch


def matmul_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) for small static m, k, n, unrolled."""
    m, k = A.shape[-2], A.shape[-1]
    n = B.shape[-1]
    rows = []
    for i in range(m):
        cols = []
        for j in range(n):
            acc = A[..., i, 0] * B[..., 0, j]
            for l in range(1, k):
                acc = acc + A[..., i, l] * B[..., l, j]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def matvec_small(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k), unrolled."""
    m, k = A.shape[-2], A.shape[-1]
    outs = []
    for i in range(m):
        acc = A[..., i, 0] * x[..., 0]
        for l in range(1, k):
            acc = acc + A[..., i, l] * x[..., l]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def transpose_small(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def inv3(A: torch.Tensor, det_eps: float = 0.0) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate, batched."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = torch.where(
        det.abs() < det_eps,
        torch.where(det < 0, torch.full_like(det, -det_eps), torch.full_like(det, det_eps)),
        det,
    )
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def tikhonov_inv_sym3(X: torch.Tensor, rcond: float) -> torch.Tensor:
    """(X + rcond*tr(X)*I)^-1 for symmetric PSD X, batched closed form."""
    f64 = X.dtype == torch.float64
    tr = X[..., 0, 0] + X[..., 1, 1] + X[..., 2, 2]
    floor = 1e-200 if f64 else 1e-20
    scale = torch.clamp(tr / 3.0, min=floor)[..., None, None]
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    Xn = X / scale + (3.0 * rcond) * eye
    return inv3(Xn, det_eps=1e-300 if f64 else 1e-38) / scale


def polar_orthonormalize(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Newton-Schulz iteration X <- 1.5 X - 0.5 X X^T X to the polar factor."""
    X = R
    for _ in range(iters):
        XtX = matmul_small(transpose_small(X), X)
        X = 1.5 * X - 0.5 * matmul_small(X, XtX)
    return X


def default_rcond(dtype: torch.dtype) -> float:
    return 1e-12 if dtype == torch.float64 else 1e-6
