"""Newton-Schulz inverse for the chi-square gate
(port of ``msckf_tpu/ops/solve.py::_ns_inverse``).

    X_0 = I / sqrt(||S||_inf ||S||_1),   X_{k+1} = X_k (2I - S X_k)

S's spectrum is real and positive (sigma^2 I + H P H^T), so X_0 is
contractive and the iteration converges quadratically. Newton's iteration
corrects itself: the error after a step is set by that step's arithmetic,
not by how X was reached. So every step but the last ``high_iters`` runs
on bfloat16 arrays, which converge to the bfloat16 floor (~4e-3), and the
last steps in the working type square that away (1.6e-5, then 2.6e-10).

The gain solve's Newton-Schulz forms (``gain_solve``, ``ns_solve_direct``,
``chol_gain_solve``) are not ported; ``gain_solver`` other than ``"lu"``
raises.
"""

from __future__ import annotations

import torch


def ns_inverse(S: torch.Tensor, iters: int, high_iters: int = 2) -> torch.Tensor:
    """Approximate inverse of (..., n, n) S by ``iters`` Newton-Schulz steps,
    all but the last ``high_iters`` on bfloat16 storage."""
    n = S.shape[-1]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    # rho(S) <= sqrt(||S||_1 ||S||_inf): the eigenvalues of S X_0 lie in (0, 1]
    norm_inf = torch.amax(torch.sum(torch.abs(S), dim=-1), dim=-1)
    norm_1 = torch.amax(torch.sum(torch.abs(S), dim=-2), dim=-1)
    norm = torch.sqrt(norm_inf) * torch.sqrt(norm_1)
    X = eye / norm[..., None, None]
    if iters > high_iters:
        b16 = torch.bfloat16
        Xl, Sl, eyel = X.to(b16), S.to(b16), eye.to(b16)
        for _ in range(iters - high_iters):
            Xl = Xl @ (2.0 * eyel - Sl @ Xl)
        X = Xl.to(S.dtype)
    for _ in range(min(high_iters, iters)):
        X = X @ (2.0 * eye - S @ X)
    return X
