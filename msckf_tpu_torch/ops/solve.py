"""Newton-Schulz inverse and the correction chain's gain solves
(port of ``msckf_tpu/ops/solve.py``).

    X_0 = I / sqrt(||S||_inf ||S||_1),   X_{k+1} = X_k (2I - S X_k)

S's spectrum is real and positive (sigma^2 I + H P H^T for the chi-square
gate, sigma^2 I + P A for the gain solve's B^T), so X_0 is contractive and
the iteration converges quadratically. Newton's iteration corrects itself:
the error after a step is set by that step's arithmetic, not by how X was
reached. So every step but the last ``high_iters`` runs on bfloat16 arrays,
which converge to the bfloat16 floor (~4e-3), and the last steps in the
working type square that away (1.6e-5, then 2.6e-10).

The gain solves (B^T Y = P, ``filter/update.py::_correction_terms``):

* ``gain_solve`` — the LU for one system; under ``torch.func.vmap`` the
  Newton-Schulz solve over the whole batch, kept if the worst relative
  residual of the batch is under ``rel_tol``, else the batched LU for every
  system (``batched_solver="ns"`` with a float32 chain);
* ``ns_solve_direct`` — the Newton-Schulz solve behind a per-system residual
  gate with the LU as its fallback (``gain_solver="ns"``);
* ``chol_gain_solve`` — L = P M^{-1} P with M = sigma^2 P + P A P SPD, one
  Cholesky, behind the same gate (``gain_solver="chol"``).

Where the JAX package branches on the residual with ``lax.cond``, the port
selects with ``torch.where``: both sides are computed, and no value is read
on the host. The LU of the fallback therefore runs on every call; the
results are those of the JAX package's branch.
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


def _ns_solve(Bt: torch.Tensor, P: torch.Tensor, iters: int) -> torch.Tensor:
    """Y ~= Bt^{-1} P: the Newton-Schulz inverse X, Y = X P, then one polish
    step Y + X (P - Bt Y), which multiplies the error by ||I - Bt X||."""
    X = ns_inverse(Bt, iters)
    Y = X @ P
    return Y + X @ (P - Bt @ Y)


def _lu_solve(Bt: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    # solve_ex without its error check: the check would wait for the device
    return torch.linalg.solve_ex(Bt, P, check_errors=False).result


def _relative_residual(Bt, P, Y, dims=(-2, -1)) -> torch.Tensor:
    """max |P - Bt Y| / max(max |P|, 1e-30) over ``dims``."""
    num = torch.amax(torch.abs(P - Bt @ Y), dim=dims)
    return num / torch.clamp(torch.amax(torch.abs(P), dim=dims), min=1e-30)


def _residual_gate(Bt, P, Y, rel_tol: float) -> torch.Tensor:
    """Y where its relative residual is under ``rel_tol``, else the LU
    answer; a NaN or inf residual takes the LU (NaN compares False). A
    select per system: the LU is computed either way."""
    ok = _relative_residual(Bt, P, Y) < rel_tol
    return torch.where(ok[..., None, None], Y, _lu_solve(Bt, P))


@torch.library.custom_op("msckf::gain_solve", mutates_args=())
def _gain_solve(Bt: torch.Tensor, P: torch.Tensor, iters: int, rel_tol: float) -> torch.Tensor:
    """One system: the pivoted LU."""
    return _lu_solve(Bt, P)


@_gain_solve.register_vmap
def _gain_solve_vmap(info, in_dims, Bt, P, iters, rel_tol):
    """B systems (the counterpart of the JAX package's custom_vmap rule):
    an unbatched argument broadcast to the batch, the Newton-Schulz solve
    over the batch, and ONE residual, the worst of the batch; under
    ``rel_tol`` the Newton-Schulz answers, else the batched LU for every
    system."""
    Bt, P = (x.expand(info.batch_size, *x.shape) if d is None else x.movedim(d, 0)
             for x, d in zip((Bt, P), in_dims[:2]))
    Y = _ns_solve(Bt, P, iters)
    res = _relative_residual(Bt, P, Y, dims=(0, 1, 2))
    return torch.where(res < rel_tol, Y, _lu_solve(Bt, P)), 0


def gain_solve(Bt: torch.Tensor, P: torch.Tensor, iters: int = 12,
               rel_tol: float = 1e-4) -> torch.Tensor:
    """Solve Bt Y = P: the LU for one system, the residual-gated
    Newton-Schulz solve for a batch under ``torch.func.vmap``."""
    return _gain_solve(Bt, P, int(iters), float(rel_tol))


def ns_solve_direct(Bt: torch.Tensor, P: torch.Tensor, iters: int = 12,
                    rel_tol: float = 1e-4) -> torch.Tensor:
    """The Newton-Schulz solve of Bt Y = P even for one system, with the
    residual-gated LU fallback (``gain_solver="ns"``)."""
    return _residual_gate(Bt, P, _ns_solve(Bt, P, iters), rel_tol)


def chol_gain_solve(P: torch.Tensor, A: torch.Tensor, sigma2: float,
                    rel_tol: float = 1e-4) -> torch.Tensor:
    """Kalman gain L = P (sigma^2 I + A P)^{-1} by one Cholesky
    (``gain_solver="chol"``).

    M = sigma^2 P + P A P = P B, so L = P B^{-1} = P M^{-1} P, and M is SPD.
    The factor is taken of 0.5 (M + M^T), as the JAX package's Cholesky
    symmetrizes its input. Where M is not positive definite in the working
    type the candidate is NaN, as the JAX package's NaN factor makes it, and
    the residual gate on B^T L^T = P takes the LU."""
    D = P.shape[-1]
    eye = torch.eye(D, dtype=P.dtype, device=P.device)
    PA = P @ A
    Bt = sigma2 * eye + PA  # B^T (P, A symmetric)
    M = sigma2 * P + PA @ P
    Lc, info = torch.linalg.cholesky_ex(0.5 * (M + M.transpose(-1, -2)))
    L = P @ torch.cholesky_solve(P, Lc)  # P M^{-1} P
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    return _residual_gate(Bt, P, L.transpose(-1, -2), rel_tol).transpose(-1, -2)
