"""Masked multi-view triangulation
(port of ``msckf_tpu/ops/triangulation.py``).

  * ``intersect_lines`` — the confidence-weighted least-squares intersection
    of a masked bundle of lines;
  * ``refine_inverse_depth_gn`` — a fixed number of Gauss-Newton steps on an
    anchored inverse-depth point (theta, phi, rho), for
    ``triangulation="gn"``.

Both take leading batch axes (tracks, and sequences under vmap), where the
JAX package vmaps the single-bundle form.
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.ops.device import one_cpu_thread
from msckf_tpu_torch.ops.geometry import idp_angles_m
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


def refine_inverse_depth_gn(
    anchor_base: torch.Tensor,  # (..., 3) anchor position (creation-time camera center)
    m0: torch.Tensor,  # (..., 3) initial unit bearing
    rho0: torch.Tensor,  # (...) initial inverse depth
    cam_R: torch.Tensor,  # (..., M, 3, 3) observing camera rotations R_W_Ci
    cam_t: torch.Tensor,  # (..., M, 3) observing camera centers
    z: torch.Tensor,  # (..., M, 2) normalized-image observations (K^-1 pix)
    mask: torch.Tensor,  # (..., M) bool
    iters: int = 5,
    damping: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton refinement of (theta, phi, rho) for an anchored
    inverse-depth point, under the filter's measurement model
    Ci_f = R_Ci_W (rho (base - t_WCi) + m(theta, phi)),
    zhat = Ci_f[:2] / Ci_f[2]. Each step solves
    (J^T J + damping I) dp = -J^T r over the valid observations. Returns the
    refined (m (..., 3), rho (...)), rho floored at 1e-8."""
    x0, y0, z0 = m0[..., 0], m0[..., 1], m0[..., 2]
    theta = torch.atan2(x0, z0)
    phi = torch.atan2(-y0, torch.sqrt(x0 * x0 + z0 * z0))
    params = torch.stack([theta, phi, rho0], dim=-1)  # (..., 3)

    Rt = cam_R.transpose(-1, -2)  # R_Ci_W
    base_minus_t = anchor_base[..., None, :] - cam_t  # (..., M, 3)
    wvalid = mask.to(anchor_base.dtype)
    eye = damping * torch.eye(3, dtype=anchor_base.dtype, device=anchor_base.device)

    for _ in range(iters):
        th, ph, rho = params[..., 0], params[..., 1], params[..., 2]
        cth, sth, cph, sph = torch.cos(th), torch.sin(th), torch.cos(ph), torch.sin(ph)
        m = torch.stack([cph * sth, -sph, cph * cth], dim=-1)
        dm_dth = torch.stack([cph * cth, torch.zeros_like(cph), -cph * sth], dim=-1)
        dm_dph = torch.stack([-sph * sth, -cph, -sph * cth], dim=-1)
        pw = rho[..., None, None] * base_minus_t + m[..., None, :]  # (..., M, 3)
        pc = (Rt @ pw[..., None])[..., 0]  # (..., M, 3) camera frame
        zc = pc[..., 2:3]
        zc_safe = torch.where(torch.abs(zc) < 1e-12, torch.full_like(zc, 1e-12), zc)
        zhat = pc[..., :2] / zc_safe
        r = (z - zhat) * wvalid[..., None]  # (..., M, 2)
        # d zhat / d pc (2 x 3 per observation)
        inv_z = 1.0 / zc_safe[..., 0]
        zero = torch.zeros_like(inv_z)
        Jproj = torch.stack([
            torch.stack([inv_z, zero, -pc[..., 0] * inv_z * inv_z], dim=-1),
            torch.stack([zero, inv_z, -pc[..., 1] * inv_z * inv_z], dim=-1),
        ], dim=-2)  # (..., M, 2, 3)
        dpw = torch.stack([
            dm_dth[..., None, :].expand(base_minus_t.shape),
            dm_dph[..., None, :].expand(base_minus_t.shape),
            base_minus_t,
        ], dim=-1)  # (..., M, 3, 3) columns: d/dtheta, d/dphi, d/drho
        J = -(Jproj @ Rt @ dpw) * wvalid[..., None, None]  # (..., M, 2, 3)
        Jf = J.reshape(J.shape[:-3] + (-1, 3))  # (..., 2M, 3)
        rf = r.reshape(r.shape[:-2] + (-1,))  # (..., 2M)
        H = Jf.transpose(-1, -2) @ Jf + eye
        g = (Jf.transpose(-1, -2) @ rf[..., None])[..., 0]
        # solve_ex without its error check: the check would wait for the device
        with one_cpu_thread(H):
            dp = torch.linalg.solve_ex(H, -g[..., None], check_errors=False).result[..., 0]
        params = params + dp

    th, ph, rho = params[..., 0], params[..., 1], params[..., 2]
    m = idp_angles_m(torch.stack(
        [torch.cos(ph) * torch.sin(th), -torch.sin(ph), torch.cos(ph) * torch.cos(th)], dim=-1))
    return m, torch.clamp(rho, min=1e-8)
