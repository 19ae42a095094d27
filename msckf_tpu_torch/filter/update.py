"""Feature triage, measurement Jacobians, gating, and the EKF update
(port of ``msckf_tpu/filter/update.py``).

The same two re-expressions of the reference as the JAX package (proofs in
its module docstring): the nullspace projection as the projector
Pi = I - H_f (H_f^T H_f)^+ H_f^T, and the Kalman update in information form
from A = sum H~^T H~ and c = sum H~^T r~ over gated features plus one
(D, D) solve.

What the port takes: every setting of the JAX package. The
triage kernel (``use_pallas_triage=True``, the default) or the plain
line-intersection triage, with ``triangulation="gn"`` the Gauss-Newton
refinement of each valid track's inverse-depth point; the hybrid update
terms with the gating kernel (``update_kernel="hybrid"``,
``gating_solver="auto"``, the default), the fused update-terms kernel
(``update_kernel="fused"``, which ignores ``gating_solver`` as in the JAX
package), or the hybrid terms with the batched-Cholesky gate
(``update_kernel="xla"``, ``gating_solver="xla"`` or ``use_pallas=False``)
or, in a float64 filter, with the Jacobi-scaled Newton-Schulz gate
(``gating_solver="ns"``; a float32 filter takes the exact gate there,
below); and the LU, Newton-Schulz
(``gain_solver="ns"``) or Cholesky (``gain_solver="chol"``) gain solve with
a float64 or plain correction chain, the batched float32 chain through
``ops/solve.py::gain_solve``, or the double-word correction island of a
float32 filter (``correction_dtype="compensated"``,
``_correction_terms_compensated`` over ``ops/compensated.py``).
``use_pallas=False`` turns every kernel off,
as the JAX package's master switch does.

One repair against the JAX package: it masks the per-track factor W but not
Kc in T_wk = sum W^T Kc, so a rejected track with an inf Jacobian gives
0 * inf = NaN and poisons A. Here Kc is masked with the same ``passed`` mask
wherever it enters A or c. Where the JAX result is finite the two agree
exactly: a rejected track then contributes exact zeros either way.

Two departures in a float32 filter's hybrid terms (ROADMAP §1): A and c are
summed from the projected rows in the correction's type, and the gate is
the exact one (the gating kernel, or the batched Cholesky) where
``gating_solver="ns"`` asks for the Newton-Schulz gate. A track seen at a
depth near zero broke both in float32 and lost rows of the batched path.
Float64 keeps the JAX package's arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import (
    OBS_CAM_ID, OBS_KP, FilterState, TrackStore, device_consts,
)
from msckf_tpu_torch.filter.tracks import (
    _rows_where, gather_cam_poses, resolve_cam_slots, select_rows,
)
from msckf_tpu_torch.ops import compensated as dw
from msckf_tpu_torch.ops import kernels
from msckf_tpu_torch.ops.device import one_cpu_thread
from msckf_tpu_torch.ops.geometry import idp_angles_m, skew, so3_exp
from msckf_tpu_torch.ops.smallmat import (
    default_rcond, matmul_small, matvec_small, polar_orthonormalize,
    tikhonov_inv_sym3, transpose_small,
)
from msckf_tpu_torch.ops.solve import chol_gain_solve, gain_solve, ns_inverse, ns_solve_direct
from msckf_tpu_torch.ops.triangulation import intersect_lines, refine_inverse_depth_gn
from msckf_tpu_torch.utils import tracing


class TriageResult(NamedTuple):
    tracks: TrackStore  # with refreshed inverse-depth points
    valid: torch.Tensor  # (F,) bool — features entering the update
    lost: torch.Tensor  # (F,) bool — features to delete after the update


@tracing.span("triage")
def triage_features(cfg: MSCKFConfig, state: FilterState, subset: torch.Tensor) -> TriageResult:
    """Valid = (lost with a long-enough history) or (parallax between first
    and last bearing above threshold); valid tracks are triangulated by
    weighted line intersection and their inverse-depth point refreshed when
    the point re-projects into the anchor camera's image (the triage kernel,
    or its plain line-intersection form with ``use_pallas_triage=False``).
    With ``triangulation="gn"`` the plain form seeds a Gauss-Newton
    refinement of every valid track's point."""
    c = device_consts(cfg, state.device)
    tr = state.tracks
    sub = subset & tr.valid
    M = cfg.m_max

    lost_f = tr.lost >= cfg.min_frames_to_be_lost
    short = tr.tracked < cfg.min_frames_to_be_tracked
    discarded = lost_f & short

    # parallax between first and last surviving bearings
    last_idx = torch.clamp(tr.n_obs - 1, 0, M - 1)
    d0 = tr.line_dir[:, 0, :]
    d1 = torch.gather(tr.line_dir, 1, last_idx[:, None, None].expand(-1, 1, 3))[:, 0]
    d0n = d0 / torch.clamp(torch.linalg.vector_norm(d0, dim=-1, keepdim=True), min=1e-30)
    d1n = d1 / torch.clamp(torch.linalg.vector_norm(d1, dim=-1, keepdim=True), min=1e-30)
    cosang = torch.clamp(torch.sum(d0n * d1n, dim=-1), -1.0, 1.0)
    parallax_deg = torch.rad2deg(torch.arccos(cosang))
    enough_parallax = (
        bool(cfg.use_parallax) & (tr.n_obs > 1) & (parallax_deg > cfg.min_parallax_deg)
    )
    valid = sub & ~discarded & (lost_f | enough_parallax)
    lost_out = sub & lost_f

    # triangulate + refresh the inverse-depth point of valid tracks
    R_a, t_a, _ = gather_cam_poses(tr.obs_cam_id[:, 0], state.cams)
    gn = cfg.triangulation == "gn"
    if cfg.use_pallas and cfg.use_pallas_triage and not gn:
        # the line fields are views of the packed observation store
        new_m, new_rho_raw, proj_ok = kernels.triage_refresh_fused(
            tr.line_base.contiguous(), tr.line_dir.contiguous(),
            torch.where(tr.obs_valid, tr.score, 0.0), R_a, t_a,
            c.K, c.Kinv, default_rcond(cfg.jdtype), cfg.width, cfg.height,
        )
        refresh = valid & proj_ok
        new_rho = torch.where(refresh, new_rho_raw, torch.ones_like(new_rho_raw))
    else:
        W_p = intersect_lines(tr.line_base, tr.line_dir, tr.score, tr.obs_valid)
        Ci_p = matvec_small(transpose_small(R_a), W_p - t_a)  # R_a^T (W_p - t_a)
        z = Ci_p[:, 2:3]
        z_safe = torch.where(z.abs() < 1e-30, torch.full_like(z, 1e-30), z)
        Im_p = (Ci_p @ c.K.T)[:, :2] / z_safe
        in_front = Ci_p[:, 2] > 0
        in_fov = (
            (Im_p[:, 0] >= 0) & (Im_p[:, 0] < cfg.width)
            & (Im_p[:, 1] >= 0) & (Im_p[:, 1] < cfg.height)
        )
        refresh = valid & in_front & in_fov

        ones = torch.ones((Im_p.shape[0], 1), dtype=Im_p.dtype, device=Im_p.device)
        W_v = matvec_small(R_a, torch.cat([Im_p, ones], dim=-1) @ c.Kinv.T)
        new_m = idp_angles_m(W_v)
        new_rho = 1.0 / torch.where(refresh, Ci_p[:, 2], torch.ones_like(Ci_p[:, 2]))
    if gn:
        # Gauss-Newton refinement of (theta, phi, rho) about the anchor,
        # seeded by the line intersection where it refreshed the point, and
        # written wherever the track is valid
        obs_slots, _ = resolve_cam_slots(tr.obs_cam_id, state.cams.cam_id)  # (F, M)
        ones_m = torch.ones(tr.kp.shape[:-1] + (1,), dtype=tr.kp.dtype, device=tr.kp.device)
        z_obs = (torch.cat([tr.kp, ones_m], dim=-1) @ c.Kinv.T)[..., :2]
        new_m, new_rho = refine_inverse_depth_gn(
            tr.idp_base, torch.where(refresh[:, None], new_m, tr.idp_m),
            torch.where(refresh, new_rho, tr.idp_rho),
            state.cams.R[obs_slots], state.cams.t[obs_slots], z_obs, tr.obs_valid,
            iters=cfg.gn_iters,
        )
        refresh = valid
    tracks = tr.replace(
        idp_m=torch.where(refresh[:, None], new_m, tr.idp_m),
        idp_rho=torch.where(refresh, new_rho, tr.idp_rho),
    )
    return TriageResult(tracks=tracks, valid=valid, lost=lost_out)


class UpdateTerms(NamedTuple):
    # A and c of a float32 filter come in the correction's type
    A: torch.Tensor  # (D, D) accumulated H^T H of gated features
    c: torch.Tensor  # (D,) accumulated H^T r
    any_pass: torch.Tensor  # () bool
    n_gate_rejected: torch.Tensor  # () int
    n_overflow: torch.Tensor  # () int — valid features beyond u_max


@tracing.span("update_terms")
def build_update_terms(cfg: MSCKFConfig, state: FilterState, valid: torch.Tensor) -> UpdateTerms:
    """Residuals, OC-projected Jacobians, nullspace projection, chi-square
    gate and the information-form accumulation: the fused update-terms
    kernel, or the hybrid terms gated by the gating kernel, by the
    Newton-Schulz gate or by a batched Cholesky."""
    dt_ = cfg.jdtype
    dev = state.device
    cst = device_consts(cfg, dev)
    U, M, N = cfg.u_max, cfg.m_max, cfg.n_cam_slots
    F = cfg.f_max
    tr = state.tracks
    zero = torch.zeros((), dtype=dt_, device=dev)

    # up to U valid tracks in slot order: row u <- the valid track of rank u
    vrank = torch.cumsum(valid, dim=0) - 1  # (F,)
    n_valid = torch.sum(valid)
    ar_U = torch.arange(U, device=dev)
    sel_oh = (vrank[None, :] == ar_U[:, None]) & valid[None, :]  # (U, F)
    sel_ok = ar_U < n_valid
    n_overflow = n_valid - torch.sum(sel_ok)
    sel_c = torch.sum(torch.where(sel_oh, torch.arange(F, device=dev), 0), dim=1)

    obs_sel = _rows_where(sel_ok, tr.obs[sel_c])  # (U, M, C)
    kp = obs_sel[..., OBS_KP]
    obs_cam_id = obs_sel[..., OBS_CAM_ID].to(torch.int64)
    n_obs = select_rows(sel_c, sel_ok, tr.n_obs)
    obs_valid = torch.arange(M, device=dev)[None, :] < n_obs[:, None]
    base = select_rows(sel_c, sel_ok, tr.idp_base)  # (U, 3)
    m_vec = select_rows(sel_c, sel_ok, tr.idp_m)
    rho = select_rows(sel_c, sel_ok, tr.idp_rho)

    R_c, t_c, onehot_w = gather_cam_poses(obs_cam_id, state.cams)
    R_CW = R_c.transpose(-1, -2)

    # Ci_f = R_C_W (rho (base - t_WC) + m)
    pw = rho[:, None, None] * (base[:, None, :] - t_c) + m_vec[:, None, :]
    Ci_f = matvec_small(R_CW, pw)  # (U, M, 3)
    W_f = matvec_small(R_c, Ci_f) + t_c

    zc = Ci_f[..., 2:3]
    z_safe = torch.where(zc.abs() < 1e-30, torch.full_like(zc, 1e-30), zc)
    zhat = Ci_f[..., :2] / z_safe
    ones = torch.ones(kp.shape[:-1] + (1,), dtype=dt_, device=dev)
    z = (torch.cat([kp, ones], dim=-1) @ cst.Kinv.T)[..., :2]
    r = torch.where(obs_valid[..., None], z - zhat, zero)  # (U, M, 2)

    # projection Jacobian
    inv_z = 1.0 / z_safe[..., 0]
    zz = torch.zeros_like(inv_z)
    Jp = torch.stack([
        torch.stack([inv_z, zz, -Ci_f[..., 0] * inv_z * inv_z], dim=-1),
        torch.stack([zz, inv_z, -Ci_f[..., 1] * inv_z * inv_z], dim=-1),
    ], dim=-2)  # (U, M, 2, 3)
    Hx_rot = matmul_small(Jp, skew(Ci_f))
    Hf = matmul_small(Jp, R_CW)
    Hx6 = torch.cat([Hx_rot, -Hf], dim=-1)  # (U, M, 2, 6)

    # per-observation OC projection of Hx6
    g = cst.gravity.expand(Ci_f.shape)
    u_vec = torch.cat([matvec_small(R_CW, g), matvec_small(skew(W_f - t_c), g)], dim=-1)
    den = torch.sum(u_vec * u_vec, dim=-1)  # (U, M)
    Au = matvec_small(Hx6, u_vec)
    big = den > 1e-6
    corr = Au[..., None] * (u_vec[..., None, :] / torch.where(big, den, torch.ones_like(den))[..., None, None])
    Hx6 = torch.where(big[..., None, None], Hx6 - corr, Hx6)
    Hx6 = torch.where(obs_valid[..., None, None], Hx6, zero)
    Hf = torch.where(obs_valid[..., None, None], Hf, zero)

    onehot = onehot_w * obs_valid[..., None]  # (U, M, N)
    Hf_stack = Hf.reshape(U, 2 * M, 3)
    r_stack = r.reshape(U, 2 * M)
    dof = torch.clamp(2 * n_obs - 3, 0, 2 * M)
    crit = cst.chi2[dof]
    sigma2 = cfg.sigma_image**2

    # camera-span Jacobian: each row lives in one 6-col camera block,
    # Hcam[u, r, 6n+j] = Hx6[u, r, j] * onehot[u, r, n]
    oh_rows = torch.repeat_interleave(onehot, 2, dim=1)  # (U, 2M, N), rows (m, c)
    Hcam = (oh_rows[..., :, None] * Hx6.reshape(U, 2 * M, 1, 6)).reshape(U, 2 * M, 6 * N)

    if cfg.use_pallas and cfg.update_kernel == "fused":
        # projector, gate and masked accumulation in one kernel call over the
        # camera span: the 15 IMU columns of the Jacobian are zero, so they
        # add nothing to S, A or c, and A and c are padded as below
        A_cam, c_cam, passed = kernels.update_terms_fused(
            Hcam, Hf_stack, r_stack, state.P[15:, 15:].contiguous(),
            crit, sel_ok, sigma2, default_rcond(dt_),
        )
        return UpdateTerms(
            A=torch.nn.functional.pad(A_cam, (15, 0, 15, 0)),
            c=torch.nn.functional.pad(c_cam, (15, 0)),
            any_pass=torch.any(passed), n_gate_rejected=torch.sum(sel_ok & ~passed),
            n_overflow=torch.clamp(n_overflow, min=0),
        )
    # nullspace projector: r~ = r - Hf pinv (Hf^T r), H~ = H - Hf pinv (Hf^T H)
    HtH = torch.einsum("uri,urj->uij", Hf_stack, Hf_stack)
    Hpinv = tikhonov_inv_sym3(HtH, default_rcond(dt_))
    Hf_r = torch.einsum("uri,ur->ui", Hf_stack, r_stack)
    r_t = r_stack - torch.einsum("uri,uij,uj->ur", Hf_stack, Hpinv, Hf_r)
    Wc = torch.einsum("uri,urd->uid", Hf_stack, Hcam)  # (U, 3, 6N)
    Kc = torch.einsum("uik,ukd->uid", Hpinv, Wc)
    H_t = Hcam - torch.einsum("uri,uid->urd", Hf_stack, Kc)  # (U, 2M, 6N)

    # chi-square gate: gamma = r~^T S^-1 r~ with S = H~ P H~^T + sigma^2 I
    HP = torch.einsum("urd,de->ure", H_t, state.P[15:, 15:])
    S = torch.einsum("ure,use->urs", HP, H_t) + sigma2 * torch.eye(2 * M, dtype=dt_, device=dev)
    f32 = dt_ == torch.float32
    with tracing.span("gate"):
        # a float32 filter takes the exact gate for "ns": twelve Newton-Schulz
        # steps do not converge where Sh's condition passes about 1e3, and a
        # track seen at a depth near zero makes it 1e6 or more, or S
        # indefinite in float32, whose gamma then passed the gate
        if cfg.gating_solver == "ns" and not f32:
            gamma = _ns_gamma(S, r_t, cfg.gating_ns_iters, sigma2)
        elif cfg.use_pallas and cfg.update_kernel == "hybrid" and cfg.gating_solver != "xla":
            gamma = kernels.batched_gating_gamma(S.contiguous(), r_t.contiguous())
        else:
            gamma = _cholesky_gamma(S, r_t)
    passed = sel_ok & (gamma <= crit)  # NaN crit (dof 0) and NaN gamma fail
    n_rej = torch.sum(sel_ok & ~passed)

    pm = passed[:, None, None]
    r_m = torch.where(passed[:, None], r_t, zero)
    if f32:
        # a float32 filter sums A = sum H~^T H~ and c = sum H~^T r~ from the
        # projected rows, as the fused kernel does, in the correction's type:
        # the difference form below cancels terms up to 10x A's size, and a
        # track seen at a depth near zero (Jacobian entries 1e3 to 1e8) left
        # float32 rounding of 1e-1 to 1e5 in A's small eigenvalues, which the
        # correction needs to about sigma^2 / P. Products of (U 2M, 6N)
        # views: an einsum copies both operands.
        ct = correction_type(cfg)
        H_m = torch.where(pm, H_t, zero).to(ct).reshape(U * 2 * M, 6 * N)
        A_cam = H_m.mT @ H_m
        c_cam = H_m.mT @ r_m.to(ct).reshape(U * 2 * M)
    else:
        # masked information accumulation without masked (U, 2M, D) tensors
        Hcam_m = torch.where(pm, Hcam, zero)
        A_bd = torch.einsum("urd,ure->de", Hcam_m, Hcam_m)  # (6N, 6N)
        Wm = torch.where(pm, Wc, zero)
        Gm = torch.where(pm, HtH, zero)
        Kcm = torch.where(pm, Kc, zero)  # the repair: Kc masked like W
        T_wk = torch.einsum("uid,uie->de", Wm, Kcm)
        GK = torch.einsum("uij,ujd->uid", Gm, Kcm)
        T_kgk = torch.einsum("uid,uie->de", Kcm, GK)
        A_cam = A_bd - T_wk - T_wk.T + T_kgk

        Fr = torch.einsum("uri,ur->ui", Hf_stack, r_t)
        Frm = torch.where(passed[:, None], Fr, zero)
        c_cam = torch.einsum("urd,ur->d", Hcam_m, r_m) - torch.einsum("uid,ui->d", Kcm, Frm)

    A = torch.nn.functional.pad(A_cam, (15, 0, 15, 0))
    c = torch.nn.functional.pad(c_cam, (15, 0))
    return UpdateTerms(
        A=A, c=c, any_pass=torch.any(passed), n_gate_rejected=n_rej,
        n_overflow=torch.clamp(n_overflow, min=0),
    )


def _ns_gamma(S: torch.Tensor, r: torch.Tensor, iters: int, sigma2: float) -> torch.Tensor:
    """gamma = r^T S^-1 r by the Jacobi-scaled Newton-Schulz inverse and two
    polish steps (``gating_solver="ns"``): Sh = D S D, rh = D r with
    D = diag(S)^-1/2 removes S's per-row scale, ``ns_inverse`` inverts Sh,
    and each polish step x <- x + X (rh - Sh x) multiplies the error by
    ||I - X Sh||. diag(S) >= sigma^2 in exact arithmetic; it is clamped
    there before the rsqrt, where the JAX package is not (ROADMAP §3): a
    round-off-negative diagonal would give a NaN gamma that fails the gate
    unseen."""
    d_inv = torch.rsqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1), min=sigma2))
    Sh = S * (d_inv[..., :, None] * d_inv[..., None, :])
    rh = r * d_inv
    X = ns_inverse(Sh, iters)
    x = torch.einsum("urs,us->ur", X, rh)
    for _ in range(2):
        x = x + torch.einsum("urs,us->ur", X, rh - torch.einsum("urs,us->ur", Sh, x))
    return torch.sum(rh * x, dim=-1)


def _cholesky_gamma(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """gamma = r^T S^-1 r by a batched Cholesky solve of the symmetrized S
    (the JAX package's ``jnp.linalg.cholesky`` symmetrizes its input). A
    system that is not positive definite gets gamma = NaN, which fails the
    gate, as the JAX Cholesky's NaN factor does; ``cholesky_ex`` runs
    without its error check, which would wait for the device."""
    with one_cpu_thread(S):
        L, info = torch.linalg.cholesky_ex(0.5 * (S + S.transpose(-1, -2)))
        sol = torch.cholesky_solve(r[..., None], L)[..., 0]
    gamma = torch.sum(r * sol, dim=-1)
    return torch.where(info == 0, gamma, torch.full_like(gamma, float("nan")))


def correction_type(cfg: MSCKFConfig) -> torch.dtype:
    """The type of the correction chain, and of a float32 filter's A and c:
    float64 for ``correction_dtype="float64"``, else the filter's type."""
    return torch.float64 if cfg.correction_dtype == "float64" else cfg.jdtype


def _correction_terms(cfg: MSCKFConfig, P, A, c):
    """delta = L c and the Joseph-form P update, L = P B^{-1},
    B = sigma^2 I + A P: in float64 when ``correction_dtype="float64"``,
    else in the filter's type. ``gain_solver`` picks the solve of
    B^T Y = P; a float32 chain with ``batched_solver="ns"`` takes
    ``gain_solve``, the LU for one sequence and the Newton-Schulz solve
    under vmap."""
    dt_ = cfg.jdtype
    D = cfg.err_dim
    ct = correction_type(cfg)
    P = P.to(ct)
    A_ = A.to(ct)
    c_ = c.to(ct)
    sigma2 = cfg.sigma_image**2
    eye = torch.eye(D, dtype=ct, device=P.device)

    # L = P B^{-1}: solve B^T Y = P, L = Y^T, with B^T = sigma^2 I + P A
    Bt = sigma2 * eye + P @ A_
    if cfg.gain_solver == "ns":
        Y = ns_solve_direct(Bt, P, iters=cfg.solver_ns_iters)
    elif cfg.gain_solver == "chol":
        Y = chol_gain_solve(P, A_, sigma2).T
    elif ct == torch.float32 and cfg.batched_solver == "ns":
        Y = gain_solve(Bt, P, iters=cfg.solver_ns_iters)
    else:
        # solve_ex without its error check: the check would wait for the device
        with one_cpu_thread(Bt):
            Y = torch.linalg.solve_ex(Bt, P, check_errors=False).result
    L = Y.T
    delta = (L @ c_).to(dt_)

    ImLA = eye - L @ A_
    LA_L = L @ A_ @ L.T
    P_new = ImLA @ P @ ImLA.T + sigma2 * LA_L
    P_new = (0.5 * (P_new + P_new.T)).to(dt_)
    return delta, P_new


def _compensated_chain(cfg: MSCKFConfig, P, A, c):
    """The chain of :func:`_correction_terms` in double-word float32
    (``ops/compensated.py``): B = sigma^2 I + A P by an Ozaki product, the
    solve of B^T Y = P by ``refined_solve`` (``cfg.island_solver``), delta
    by ``df_matvec``, the Joseph terms by Ozaki products. Returns delta and
    the new P as DF pairs, before their rounding to float32; they match the
    float64 chain to about 2^-40."""
    D = cfg.err_dim
    P32 = P.to(torch.float32)
    A32 = A.to(torch.float32)
    eye = torch.eye(D, dtype=torch.float32, device=P.device)
    # a float32 tensor: df_scale must not split a Python float in double
    sigma2 = torch.full((), cfg.sigma_image**2, dtype=torch.float32, device=P.device)

    B = dw.df_add(dw.df_from(sigma2 * eye), dw.ozaki_matmul(A32, P32))
    # L = P B^{-1}: solve B^T Y = P (P symmetric), L = Y^T
    Bt = dw.DF(B.hi.mT, B.lo.mT)
    # five refinement steps reach the double-word floor on realistically
    # conditioned (cond ~1e7) filter systems
    Y = dw.refined_solve(Bt, P32, iters=5, solver=cfg.island_solver)
    L = dw.DF(Y.hi.mT, Y.lo.mT)
    delta = dw.df_matvec(L.hi, c.to(torch.float32), A_lo=L.lo)

    LA = dw.ozaki_matmul(L.hi, A32, A_lo=L.lo)
    ImLA = dw.df_sub(dw.df_from(eye), LA)
    ImLA_P = dw.ozaki_matmul(ImLA.hi, P32, A_lo=ImLA.lo)
    joseph = dw.ozaki_matmul(ImLA_P.hi, ImLA.hi.mT, A_lo=ImLA_P.lo, B_lo=ImLA.lo.mT)
    LALt = dw.ozaki_matmul(LA.hi, L.hi.mT, A_lo=LA.lo, B_lo=L.lo.mT)
    return delta, dw.df_add(joseph, dw.df_scale(LALt, sigma2))


def _correction_terms_compensated(cfg: MSCKFConfig, P, A, c):
    """delta and the Joseph-form P update of the double-word island
    (:func:`_compensated_chain`), rounded to float32, P symmetrized."""
    delta, P_new = _compensated_chain(cfg, P, A, c)
    P_new = dw.df_round(P_new)
    P_new = (0.5 * (P_new + P_new.mT)).to(cfg.jdtype)
    return dw.df_round(delta).to(cfg.jdtype), P_new


@tracing.span("correct")
def apply_correction(cfg: MSCKFConfig, state: FilterState, A, c) -> FilterState:
    """Information-form Kalman gain, Joseph covariance update, exp-map state
    correction with polar re-orthonormalization. The double-word island
    runs for ``correction_dtype="compensated"`` with a float32 filter; a
    float64 filter runs the plain chain, as in the JAX package. Float64 is
    real on the CPU and on the card, so ``"float64"`` never falls back to
    the island here."""
    N = cfg.n_cam_slots
    if cfg.correction_dtype == "compensated" and cfg.jdtype == torch.float32:
        delta, P_new = _correction_terms_compensated(cfg, state.P, A, c)
    else:
        delta, P_new = _correction_terms(cfg, state.P, A, c)

    imu = state.imu
    dR = so3_exp(delta[0:3])
    imu = imu.replace(
        R_WI=polar_orthonormalize(imu.R_WI @ dR.T),
        bg=imu.bg + delta[3:6],
        v_WI=imu.v_WI + delta[6:9],
        ba=imu.ba + delta[9:12],
        p_WI=imu.p_WI + delta[12:15],
    )
    dcam = delta[15:].reshape(N, 6)
    dRc = so3_exp(dcam[:, 0:3])
    Rc_new = polar_orthonormalize(matmul_small(state.cams.R, transpose_small(dRc)))
    cams = state.cams.replace(R=Rc_new, t=state.cams.t + dcam[:, 3:6])
    return state.replace(imu=imu, cams=cams, P=P_new)


def ekf_update(cfg: MSCKFConfig, state: FilterState, valid: torch.Tensor) -> FilterState:
    """Gate, accumulate, correct. With every feature rejected, A = 0 and
    c = 0 make the correction the identity, so no branch is needed."""
    terms = build_update_terms(cfg, state, valid)
    state = state.replace(
        diag=state.diag.replace(
            n_gating_rejected=state.diag.n_gating_rejected + terms.n_gate_rejected,
            n_update_overflow=state.diag.n_update_overflow + terms.n_overflow,
        )
    )
    return apply_correction(cfg, state, terms.A, terms.c)
