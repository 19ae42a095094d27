"""The benchmark's plain reference of the filter: the monocular MSCKF of the
reference implementation (ValerioSpagnoli/Monocular-Visual-Inertial-MSCKF),
written in plain PyTorch on growing lists, one sequence at a time.

It follows the reference's own formulations, not the program's: an
explicit left null-space basis by SVD and the chi-square gate per feature,
stacked rows compressed by a thin QR, the Joseph-form covariance update,
and a covariance that grows and shrinks by deleting rows and columns. Its
nominal-state arithmetic (OC-EKF propagation with the aliased null state,
the exponential map, re-orthonormalisation) is the one the program states.

Precision is a parameter: float64 on the CPU is the reference; float32
(and TF32 matrix products on a card) make the controls that must fail.

Where the program computes in a lower precision (``program_dtype``),
every threshold decision is also worked out in that precision from the
same inputs, and its margin recorded as how far the quantity lay from the
threshold in units of the gap between the two precisions: a decision with
a small ratio is one that the program's rounding could flip
(``Reference.margins``), and a comparison may set such a step aside.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from scipy.stats import chi2

OBS_FIELDS = ("kps", "descs", "scores", "cam_ids", "bases", "dirs")


def skew(w):
    o = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([o, -w[2], w[1]]), torch.stack([w[2], o, -w[0]]),
                        torch.stack([-w[1], w[0], o])])


def so3_exp(rv):
    """exp of a rotation vector, by its series below 1e-8 rad."""
    th = torch.linalg.vector_norm(rv)
    K = skew(rv)
    I3 = torch.eye(3, dtype=rv.dtype, device=rv.device)
    if float(th) < 1e-8:
        t2 = th * th
        return I3 + (1.0 - t2 / 6.0) * K + (0.5 - t2 / 24.0) * (K @ K)
    return I3 + torch.sin(th) / th * K + (1.0 - torch.cos(th)) / (th * th) * (K @ K)


def idp_m(d):
    """The reference's unit bearing of a direction, through its two angles."""
    x, y, z = d
    th = torch.atan2(x, z)
    ph = torch.atan2(-y, torch.sqrt(x * x + z * z))
    return torch.stack([torch.cos(ph) * torch.sin(th), -torch.sin(ph), torch.cos(ph) * torch.cos(th)])


def _baseline(R1, t1, R2, t2, kp1, kp2, K, Kinv):
    return torch.linalg.vector_norm(R1.T @ (t2 - t1))


def _homography_score(R1, t1, R2, t2, kp1, kp2, K, Kinv):
    H = K @ (R1.T @ R2) @ Kinv
    x1p = torch.linalg.solve(H, torch.cat([kp2, kp2.new_ones(1)]))
    x2p = H @ torch.cat([kp1, kp1.new_ones(1)])
    return 0.5 * (torch.linalg.vector_norm(kp2 - x1p[:2] / x1p[2])
                  + torch.linalg.vector_norm(kp1 - x2p[:2] / x2p[2]))


def _epipolar_score(R1, t1, R2, t2, kp1, kp2, K, Kinv):
    """The reference's signed x2^T F x1 in pixels."""
    Fm = Kinv.T @ skew(R1.T @ (t2 - t1)) @ (R1.T @ R2) @ Kinv
    return torch.cat([kp2, kp2.new_ones(1)]) @ Fm @ torch.cat([kp1, kp1.new_ones(1)])


def _cos_between(d0, d1):
    return torch.clamp((d0 / torch.linalg.vector_norm(d0)) @ (d1 / torch.linalg.vector_norm(d1)),
                       -1.0, 1.0)


def _anchor_point(dirs, w, bases, R0, t0):
    """The weighted line intersection of a track's rays (the reference's
    pseudo-inverse), in its anchor camera's frame."""
    dn = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    Pm = torch.eye(3, dtype=dirs.dtype, device=dirs.device) - dn[:, :, None] * dn[:, None, :]
    X = (w[:, None, None] * Pm).sum(0)
    y = (w[:, None] * (Pm @ bases[:, :, None])[:, :, 0]).sum(0)
    return R0.T @ (torch.linalg.pinv(X) @ y - t0)


# the relative Tikhonov term that a filter computing in this precision adds
# to the 3 x 3 normal matrix Hf^T Hf of a track's point Jacobian before it
# projects the residual off Hf (the program's choice); the gate's margin in
# that precision is judged with it, since near-parallel rays make the term
# move gamma far more than rounding does
RCOND = {torch.float32: 1e-6, torch.float64: 1e-12}


def _projected_gamma(r, Hx, Hf, P, sigma2, rcond):
    """r~^T S^-1 r~ with r~ and H~ projected off Hf through
    (Hf^T Hf + rcond tr(Hf^T Hf) I)^-1, S = H~ P H~^T + sigma^2 I."""
    G = Hf.T @ Hf
    scale = torch.trace(G) / 3.0
    Gi = torch.linalg.inv(G / scale + 3.0 * rcond * torch.eye(3, dtype=G.dtype, device=G.device)) / scale
    Ht = Hx - Hf @ (Gi @ (Hf.T @ Hx))
    rt = r - Hf @ (Gi @ (Hf.T @ r))
    S = Ht @ P @ Ht.T + sigma2 * torch.eye(len(r), dtype=r.dtype, device=r.device)
    return rt @ torch.linalg.solve(S, rt)


def orthonormalize(R):
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh


@dataclass
class Feature:
    kps: list
    descs: list
    scores: list
    cam_ids: list
    bases: list
    dirs: list
    idp_base: torch.Tensor
    idp_m: torch.Tensor
    idp_rho: torch.Tensor
    tracked: int
    lost: int


@dataclass
class State:
    """One sequence's filter state. ``cams``: [{id, R, t}] in augmentation
    order; ``feats``: track id -> Feature, in creation order; ``P`` is
    (15 + 6 len(cams)) square."""

    R: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    ts: torch.Tensor
    step_id: int
    prop_count: int
    P: torch.Tensor
    cams: list = field(default_factory=list)
    feats: dict = field(default_factory=dict)
    next_fid: int = 0
    n_epi: int = 0
    n_homo: int = 0
    n_gate: int = 0


class Reference:
    """The filter's step on a :class:`State`, in ``dtype`` on ``device``.
    ``settings`` is the configuration file's ``filter`` group."""

    KINDS = ("match", "verify", "triage", "gate")

    def __init__(self, settings: dict, dtype=torch.float64, device="cpu", program_dtype=None):
        s = settings
        self.s = s
        self.dt = dtype
        self.dev = torch.device(device)
        self.low = program_dtype if program_dtype not in (None, dtype) else None

        def t(x):
            return torch.as_tensor(x, dtype=torch.float64).to(dtype=dtype, device=self.dev)

        self.K = t(s["K"])
        self.Kinv = t(torch.linalg.inv(torch.as_tensor(s["K"], dtype=torch.float64)))
        self.R_IC = t(s["R_WC"])
        self.t_IC = t(s["t_WC"])
        self.g = t(s["gravity"])
        qc = torch.tensor([s["gyroscope_noise_density"] ** 2, s["gyroscope_random_walk"] ** 2,
                           s["accelerometer_noise_density"] ** 2,
                           s["accelerometer_random_walk"] ** 2], dtype=torch.float64)
        self.Qc = torch.diag(t(qc.repeat_interleave(3)))
        self.sigma2 = s["sigma_image"] ** 2
        self.min_lost = max(s["min_frames_to_be_lost"], 1)
        self.min_tracked = max(s["min_frames_to_be_tracked"], 2)
        self.cos_parallax = math.cos(math.radians(s["min_parallax_deg"]))
        self.reset_margins()

    # ------------------------------------------------------------ margins
    def _decide(self, kind: str, fn, args, thr=0.0):
        """``fn(*args)``; with a lower program precision, the ratio of each
        entry's distance from ``thr`` to its gap from the same function in
        that precision is recorded (the smallest of each kind)."""
        q = fn(*args)
        if self.low is not None:
            q_low = fn(*(a.to(self.low) for a in args)).to(self.dt)
            self._ratio(kind, q - thr, q_low - q)
        return q

    def _ratio(self, kind: str, gap, err) -> None:
        gap, err = torch.as_tensor(gap).abs(), torch.as_tensor(err).abs()
        if gap.numel() == 0:
            return
        r = float(torch.where(err > 0, gap / torch.clamp(err, min=1e-300),
                              torch.where(gap > 0, math.inf, 0.0)).min())
        if r < self.margins[kind]:
            self.margins[kind] = r

    def reset_margins(self) -> None:
        self.margins = {k: math.inf for k in self.KINDS}

    # ------------------------------------------------------------ start
    def initial_state(self, prefix_acc, pre_init) -> State:
        """The state the stream's prefix starts from: the orientation that
        turns the mean accelerometer of the initialisation ticks onto
        gravity, everything else zero."""
        acc = prefix_acc.to(self.dev, self.dt)[pre_init.to(self.dev)]
        a = acc.mean(0)
        a = a / torch.linalg.vector_norm(a)
        gdir = self.g / torch.linalg.vector_norm(self.g)
        axis = torch.linalg.cross(a, gdir)
        theta = torch.arccos(torch.clamp(a @ gdir, -1.0, 1.0))
        I3 = torch.eye(3, dtype=self.dt, device=self.dev)
        if abs(float(theta)) <= 1e-8:
            R = I3
        elif abs(float(theta) - math.pi) <= 1e-8 + 1e-5 * math.pi:
            R = -I3
        else:
            Kx = skew(axis / torch.linalg.vector_norm(axis))
            R = I3 + torch.sin(theta) * Kx + (1 - torch.cos(theta)) * (Kx @ Kx)
        z = torch.zeros(3, dtype=self.dt, device=self.dev)
        return State(R=R, p=z, v=z.clone(), bg=z.clone(), ba=z.clone(),
                     ts=torch.zeros((), dtype=self.dt, device=self.dev), step_id=0,
                     prop_count=0, P=torch.zeros(15, 15, dtype=self.dt, device=self.dev))

    # ------------------------------------------------------------ propagation
    def process_imu(self, st: State, ts, gyro, acc) -> None:
        dt = ts - st.ts
        w = gyro - st.bg
        a = acc - st.ba
        I3 = torch.eye(3, dtype=self.dt, device=self.dev)
        if st.prop_count == 0:
            R_null, p_null, v_null = I3, torch.zeros_like(st.p), torch.zeros_like(st.v)
        else:
            R_null, p_null, v_null = st.R, st.p, st.v
        wn = torch.linalg.vector_norm(w)
        th = wn * dt
        if float(th) > 0:
            ax = w / wn
            Kx = skew(ax)
            dR = I3 + torch.sin(th) * Kx + (1 - torch.cos(th)) * (Kx @ Kx)
        else:
            dR = I3
        R_new = st.R @ dR
        a_w = st.R @ a - self.g
        p_new = st.p + st.v * dt + 0.5 * a_w * dt * dt
        v_new = st.v + a_w * dt

        F = torch.zeros(15, 15, dtype=self.dt, device=self.dev)
        F[0:3, 0:3] = -skew(w)
        F[0:3, 3:6] = -I3
        F[6:9, 0:3] = -R_new @ skew(a)
        F[6:9, 9:12] = -R_new
        F[12:15, 6:9] = I3
        G = torch.zeros(15, 12, dtype=self.dt, device=self.dev)
        G[0:3, 0:3] = -I3
        G[3:6, 3:6] = I3
        G[6:9, 6:9] = -R_new
        G[9:12, 9:12] = I3
        Fdt = F * dt
        Fdt2 = Fdt @ Fdt
        Phi = torch.eye(15, dtype=self.dt, device=self.dev) + Fdt + 0.5 * Fdt2 + (Fdt2 @ Fdt) / 6.0
        Phi[0:3, 0:3] = R_new @ R_null.T
        u = R_null @ self.g
        s = u / (u @ u)
        A_vel = Phi[6:9, 0:3].clone()
        A_pos = Phi[12:15, 0:3].clone()
        w1 = skew(v_null - v_new) @ self.g
        w2 = skew(dt * v_null + p_null - p_new) @ self.g
        Phi[6:9, 0:3] = A_vel - torch.outer(A_vel @ u - w1, s)
        Phi[12:15, 0:3] = A_pos - torch.outer(A_pos @ u - w2, s)
        Q = Phi @ G @ self.Qc @ G.T @ Phi.T * dt
        P = st.P.clone()
        P[:15, :15] = Phi @ st.P[:15, :15] @ Phi.T + Q
        P[:15, 15:] = Phi @ st.P[:15, 15:]
        P[15:, :15] = P[:15, 15:].T
        st.P = 0.5 * (P + P.T)
        st.R, st.p, st.v, st.ts = R_new, p_new, v_new, ts
        st.step_id += 1
        st.prop_count += 1

    # ------------------------------------------------------------ augmentation
    def augment(self, st: State) -> None:
        R_c = st.R @ self.R_IC
        t_c = st.R @ self.t_IC + st.p
        st.cams.append({"id": st.step_id, "R": R_c, "t": t_c})
        D = st.P.shape[0]
        J = torch.zeros(6, D, dtype=self.dt, device=self.dev)
        J[0:3, 0:3] = self.R_IC.T
        J[3:6, 0:3] = skew(st.R @ self.t_IC)
        J[3:6, 12:15] = torch.eye(3, dtype=self.dt, device=self.dev)
        M = torch.cat([torch.eye(D, dtype=self.dt, device=self.dev), J])
        P = M @ st.P @ M.T
        st.P = 0.5 * (P + P.T)

    # ------------------------------------------------------------ matching
    def _mutual_match(self, d1, d2):
        thr = self.s["min_cosine_similarity"]
        sim = d1 @ d2.T
        m12 = sim.argmax(1)
        m21 = sim.argmax(0)
        best = sim.max(1).values
        mutual = m21[m12] == torch.arange(len(d1), device=self.dev)
        good = best > thr
        if self.low is not None:
            # the threshold of each row, and the order of the best two of
            # each row and of each column that a row's best could pass
            err = (d1.to(self.low) @ d2.to(self.low).T).to(self.dt) - sim
            rows = torch.arange(len(d1), device=self.dev)
            self._ratio("match", best - thr, err[rows, m12])
            near = rows[best > thr - 1e-3]
            if sim.shape[1] > 1 and len(near):
                i2 = sim.topk(2, dim=1).indices[near]
                self._ratio("match", sim[near, i2[:, 0]] - sim[near, i2[:, 1]],
                            err[near, i2[:, 0]] - err[near, i2[:, 1]])
            if sim.shape[0] > 1 and len(near):
                cols = m12[near]
                j2 = sim.topk(2, dim=0).indices[:, cols]
                self._ratio("match", sim[j2[0], cols] - sim[j2[1], cols],
                            err[j2[0], cols] - err[j2[1], cols])
        keep = mutual & good
        return torch.nonzero(keep)[:, 0].tolist(), m12[keep].tolist()

    def _spawn(self, st, kp, desc, score, cam):
        W_v = cam["R"] @ (self.Kinv @ torch.cat([kp, kp.new_ones(1)]))
        st.next_fid += 1
        st.feats[st.next_fid] = Feature(
            kps=[kp], descs=[desc], scores=[score], cam_ids=[cam["id"]], bases=[cam["t"]],
            dirs=[W_v], idp_base=cam["t"], idp_m=idp_m(W_v),
            idp_rho=torch.tensor(0.1, dtype=self.dt, device=self.dev), tracked=1, lost=0)

    def _verify(self, st, f: Feature, kp2, cam) -> bool:
        """The two-tier check over the track's history; True accepts."""
        K, Kinv = self.K, self.Kinv
        cam_of = {c["id"]: c for c in st.cams}
        for j in range(len(f.kps)):
            c1 = cam_of[f.cam_ids[j]]
            kp1 = f.kps[j]
            args = (c1["R"], c1["t"], cam["R"], cam["t"], kp1, kp2, K, Kinv)
            base = self._decide("verify", _baseline, args, 0.01)
            if float(base) < 0.01:
                thr = self.s["homography_rejection_threshold"]
                if float(self._decide("verify", _homography_score, args, thr)) > thr:
                    st.n_homo += 1
                    return False
            else:
                thr = self.s["epipolar_rejection_threshold"]
                if float(self._decide("verify", _epipolar_score, args, thr)) > thr:
                    st.n_epi += 1
                    return False
        return True

    def add_measurements(self, st: State, kps, descs, scores) -> None:
        mean = scores.mean()
        keep = scores >= 0.5 * mean
        kps, descs, scores = kps[keep], descs[keep], scores[keep]
        if len(kps) == 0:
            return
        cam = st.cams[-1]
        if not st.feats:
            for i in range(len(kps)):
                self._spawn(st, kps[i], descs[i], scores[i], cam)
            return
        fids = list(st.feats)
        fused = torch.stack([
            (torch.stack(f.scores)[:, None] * torch.stack(f.descs)).sum(0) / torch.stack(f.scores).sum()
            for f in st.feats.values()])
        i1, i2 = self._mutual_match(fused, descs)
        if not i1:
            return
        for a, b in zip(i1, i2):
            f = st.feats[fids[a]]
            if not self._verify(st, f, kps[b], cam):
                f.lost += 1
                continue
            W_v = cam["R"] @ (self.Kinv @ torch.cat([kps[b], kps.new_ones(1)]))
            for name, x in zip(OBS_FIELDS, (kps[b], descs[b], scores[b], cam["id"], cam["t"], W_v)):
                getattr(f, name).append(x)
            f.tracked += 1
            f.lost = 0
        matched2 = set(i2)
        for b in range(len(kps)):
            if b not in matched2:
                self._spawn(st, kps[b], descs[b], scores[b], cam)
        matched1 = set(i1)
        for k, fid in enumerate(fids):
            if k not in matched1:
                st.feats[fid].lost += 1

    # ------------------------------------------------------------ triage

    def valid_features(self, st: State, fids):
        valid, lost = [], []
        W, H = self.s["width"], self.s["height"]
        cam_of = {c["id"]: c for c in st.cams}
        for fid in fids:
            f = st.feats[fid]
            is_lost = f.lost >= self.min_lost
            if is_lost and f.tracked < self.min_tracked:
                lost.append(fid)
                continue
            enough_par = False
            if self.s["use_parallax"] and len(f.dirs) > 1:
                d0 = f.dirs[0] / torch.linalg.vector_norm(f.dirs[0])
                d1 = f.dirs[-1] / torch.linalg.vector_norm(f.dirs[-1])
                cos = self._decide("triage", _cos_between, (f.dirs[0], f.dirs[-1]),
                                   self.cos_parallax)
                enough_par = math.degrees(math.acos(float(cos))) > self.s["min_parallax_deg"]
            if not (is_lost or enough_par):
                continue
            c0 = cam_of[f.cam_ids[0]]
            args = (torch.stack(f.dirs), torch.stack(f.scores), torch.stack(f.bases),
                    c0["R"], c0["t"])
            Cp = _anchor_point(*args)
            if self.low is not None:
                Cp_low = _anchor_point(*(a.to(self.low) for a in args)).to(self.dt)
                self._ratio("triage", Cp[2], Cp_low[2] - Cp[2])
            if float(Cp[2]) > 0:
                uv = (self.K @ Cp)[:2] / Cp[2]
                if self.low is not None:
                    uv_low = (self.K @ Cp_low)[:2] / Cp_low[2]
                    for col, lim in ((0, W), (1, H)):
                        for thr in (0.0, lim):
                            self._ratio("triage", uv[col] - thr, uv_low[col] - uv[col])
                if 0 <= float(uv[0]) < W and 0 <= float(uv[1]) < H:
                    W_v = c0["R"] @ (self.Kinv @ torch.cat([uv, uv.new_ones(1)]))
                    f.idp_m, f.idp_rho = idp_m(W_v), 1.0 / Cp[2]
            valid.append(fid)
            if is_lost:
                lost.append(fid)
        return valid, lost

    # ------------------------------------------------------------ update
    def _residual_jacobian(self, st: State, f: Feature):
        D = st.P.shape[0]
        index_of = {c["id"]: i for i, c in enumerate(st.cams)}
        k = torch.tensor([index_of[cid] for cid in f.cam_ids], device=self.dev)
        Rc = torch.stack([st.cams[i]["R"] for i in k.tolist()])  # (m, 3, 3)
        tc = torch.stack([st.cams[i]["t"] for i in k.tolist()])
        R_CW = Rc.transpose(1, 2)
        Cf = (R_CW @ (f.idp_rho * (f.idp_base - tc) + f.idp_m)[:, :, None])[:, :, 0]
        Wf = (Rc @ Cf[:, :, None])[:, :, 0] + tc
        kp = torch.stack(f.kps)
        z = torch.cat([kp, kp.new_ones(len(kp), 1)], 1) @ self.Kinv.T
        z = z[:, :2] / z[:, 2:3]
        zh = Cf[:, :2] / Cf[:, 2:3]
        r = (z - zh).reshape(-1)
        zero = torch.zeros_like(Cf[:, 0])
        iz = 1 / Cf[:, 2]
        Jp = torch.stack([torch.stack([iz, zero, -Cf[:, 0] * iz * iz], 1),
                          torch.stack([zero, iz, -Cf[:, 1] * iz * iz], 1)], 1)  # (m, 2, 3)
        sk = torch.stack([skew(c) for c in Cf])
        Hx6 = torch.cat([Jp @ sk, -Jp @ R_CW], 2)  # (m, 2, 6)
        u = torch.cat([(R_CW @ self.g), torch.stack([skew(w) @ self.g for w in (Wf - tc)])], 1)
        den = (u * u).sum(1)
        A = Hx6 - (Hx6 @ u[:, :, None]) * u[:, None, :] / den[:, None, None]
        A = torch.where((den > 1e-6)[:, None, None], A, Hx6)
        Hf = -Hx6[:, :, 3:].reshape(-1, 3)
        Hx = torch.zeros(2 * len(k), D, dtype=self.dt, device=self.dev)
        for row, i in enumerate(k.tolist()):
            Hx[2 * row:2 * row + 2, 15 + 6 * i:21 + 6 * i] = A[row]
        return r, Hx, Hf

    def _nullspace(self, r, Hx, Hf):
        """The residual and Jacobian on an explicit left null-space basis of
        Hf, by SVD."""
        U, S, _ = torch.linalg.svd(Hf, full_matrices=True)
        tol = max(Hf.shape) * torch.finfo(self.dt).eps * (S[0] if len(S) else 0.0)
        rank = int((S > tol).sum())
        Ab = U[:, rank:]
        return Ab.T @ r, Ab.T @ Hx

    def update(self, st: State, fids) -> None:
        HX, RO = [], []
        for fid in fids:
            r, Hx, Hf = self._residual_jacobian(st, st.feats[fid])
            r_o, H_o = self._nullspace(r, Hx, Hf)
            n = H_o.shape[0]
            S = H_o @ st.P @ H_o.T + self.sigma2 * torch.eye(n, dtype=self.dt, device=self.dev)
            gamma = float(r_o @ torch.linalg.solve(S, r_o)) if n else 0.0
            crit = float(chi2.ppf(0.95, n)) if n else math.nan
            if n and self.low is not None:
                g_low = _projected_gamma(*(x.to(self.low) for x in (r, Hx, Hf, st.P)),
                                         self.sigma2, RCOND[self.low])
                self._ratio("gate", gamma - crit, float(g_low) - gamma)
            if not (gamma <= crit):
                st.n_gate += 1
                continue
            HX.append(H_o)
            RO.append(r_o)
        if not HX:
            return
        H = torch.cat(HX)
        r = torch.cat(RO)
        if H.shape[0] > H.shape[1]:
            Qm, TH = torch.linalg.qr(H, mode="reduced")
            rn = Qm.T @ r
            Rn = self.sigma2 * torch.eye(TH.shape[0], dtype=self.dt, device=self.dev)
        else:
            TH, rn = H, r
            Rn = self.sigma2 * torch.eye(len(r), dtype=self.dt, device=self.dev)
        P = st.P
        S = TH @ P @ TH.T + Rn
        Kk = torch.linalg.solve(S, TH @ P).T
        dx = Kk @ rn
        IKH = torch.eye(P.shape[0], dtype=self.dt, device=self.dev) - Kk @ TH
        P = IKH @ P @ IKH.T + Kk @ Rn @ Kk.T
        st.P = 0.5 * (P + P.T)
        st.R = orthonormalize(st.R @ so3_exp(dx[0:3]).T)
        st.bg = st.bg + dx[3:6]
        st.v = st.v + dx[6:9]
        st.ba = st.ba + dx[9:12]
        st.p = st.p + dx[12:15]
        for i, c in enumerate(st.cams):
            d = dx[15 + 6 * i:21 + 6 * i]
            c["R"] = orthonormalize(c["R"] @ so3_exp(d[0:3]).T)
            c["t"] = c["t"] + d[3:6]

    # ------------------------------------------------------------ house-keeping
    def remove_cameras(self, st: State, cam_ids) -> None:
        for cid in cam_ids:
            idx = [c["id"] for c in st.cams].index(cid)
            keep = [i for i in range(st.P.shape[0]) if not 15 + 6 * idx <= i < 21 + 6 * idx]
            keep = torch.tensor(keep, device=self.dev)
            st.P = st.P[keep][:, keep]
            del st.cams[idx]
        dead = []
        for fid, f in st.feats.items():
            for cid in cam_ids:
                if cid in f.cam_ids:
                    j = f.cam_ids.index(cid)
                    for name in OBS_FIELDS:
                        del getattr(f, name)[j]
            if not f.cam_ids:
                dead.append(fid)
        for fid in dead:
            del st.feats[fid]

    def remove_features(self, st: State, fids) -> None:
        for fid in fids:
            st.feats.pop(fid, None)
        live = set()
        for f in st.feats.values():
            live.update(f.cam_ids)
        self.remove_cameras(st, [c["id"] for c in st.cams if c["id"] not in live])

    def prune_poorest(self, st: State) -> None:
        counts: dict = {}
        for f in st.feats.values():
            for cid in f.cam_ids:
                counts[cid] = counts.get(cid, 0) + 1
        victims = [cid for cid, _ in sorted(counts.items(), key=lambda kv: kv[1])[:2]]
        subset = [fid for fid, f in st.feats.items() if any(c in f.cam_ids for c in victims)]
        valid, _ = self.valid_features(st, subset)
        if valid:
            self.update(st, valid)
        self.remove_cameras(st, victims)

    # ------------------------------------------------------------ the steps
    def camera_step(self, st: State, kps, descs, scores) -> None:
        self.augment(st)
        self.add_measurements(st, kps, descs, scores)
        valid, lost = self.valid_features(st, list(st.feats))
        if valid:
            self.update(st, valid)
            self.remove_features(st, lost)
        if len(st.cams) > self.s["max_camera_states"]:
            self.prune_poorest(st)

    def _ticks(self, st, ts, gyro, acc, valid) -> None:
        for i in torch.nonzero(valid)[:, 0].tolist():
            self.process_imu(st, ts[i], gyro[i], acc[i])

    def propagate_prefix(self, st: State, prefix: dict) -> None:
        c = self._cast(prefix)
        self._ticks(st, c["imu_ts"], c["imu_gyro"], c["imu_acc"], c["imu_valid"])

    def frame_step(self, st: State, frame: dict) -> None:
        """One camera-frame block: tick 0, the camera, the other ticks."""
        c = self._cast(frame)
        v = c["imu_valid"]
        self._ticks(st, c["imu_ts"][:1], c["imu_gyro"][:1], c["imu_acc"][:1], v[:1])
        if bool(c["has_camera"]) and bool(v[0]):
            m = c["kp_valid"]
            self.camera_step(st, c["kp"][m], c["desc"][m], c["score"][m])
        self._ticks(st, c["imu_ts"][1:], c["imu_gyro"][1:], c["imu_acc"][1:], v[1:])

    def _cast(self, d: dict) -> dict:
        return {k: (x.to(self.dev, self.dt) if x.is_floating_point() else x.to(self.dev))
                for k, x in d.items()}
