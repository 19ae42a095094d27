"""Reading the program's filter states into the reference's form, and the
numbers that decide ``correct``.

The program's state is read as a flat dict of one row's tensors keyed by
field path (``"imu.R_WI"``, ``"tracks.obs"``, ...), the names of the
program's output; the packed observation channels are laid out as the
program documents them. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vio_bench.reference.filter import Feature, State

# the program's packed observation channels:
# [kp(2) | score(1) | line_base(3) | line_dir(3) | cam_id(1) | descriptor]
OBS_KP, OBS_SCORE, OBS_BASE, OBS_DIR, OBS_CAM_ID, OBS_DESC = (
    slice(0, 2), 2, slice(3, 6), slice(6, 9), 9, 10)


def flatten(obj, prefix: str = "", out: dict | None = None) -> dict:
    """Leaves of a nest of dataclasses, keyed by field path."""
    out = {} if out is None else out
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            flatten(v, f"{prefix}{f.name}.", out)
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def rows_of(flat: dict, rows: list[int]) -> list[dict]:
    """Each of ``rows`` of a batched flat state, as float64 (floats) on the
    CPU: one copy to the host for all of them."""
    idx = torch.tensor(rows, device=next(iter(flat.values())).device)
    taken = {k: v.index_select(0, idx).cpu() for k, v in flat.items()}
    return [{k: (v[i].double() if v.is_floating_point() else v[i]) for k, v in taken.items()}
            for i in range(len(rows))]


def from_program(d: dict) -> State:
    """A reference :class:`State` from one row of the program's state."""
    n = int(d["cams.n"])
    if not bool(d["cams.valid"][:n].all()):
        raise ValueError("the program's active camera slots are not all valid")
    D = 15 + 6 * n
    st = State(
        R=d["imu.R_WI"], p=d["imu.p_WI"], v=d["imu.v_WI"], bg=d["imu.bg"], ba=d["imu.ba"],
        ts=d["imu.timestamp"], step_id=int(d["imu.step_id"]),
        prop_count=int(d["imu.prop_count"]), P=d["P"][:D, :D].clone(),
        cams=[{"id": int(d["cams.cam_id"][k]), "R": d["cams.R"][k], "t": d["cams.t"][k]}
              for k in range(n)],
        next_fid=int(d["next_track_id"]), n_epi=int(d["diag.n_epipolar_rejected"]),
        n_homo=int(d["diag.n_homography_rejected"]), n_gate=int(d["diag.n_gating_rejected"]),
    )
    valid = torch.nonzero(d["tracks.valid"])[:, 0].tolist()
    for f in sorted(valid, key=lambda i: int(d["tracks.track_id"][i])):
        m = int(d["tracks.n_obs"][f])
        o = d["tracks.obs"][f, :m]
        st.feats[int(d["tracks.track_id"][f])] = Feature(
            kps=list(o[:, OBS_KP]), descs=list(o[:, OBS_DESC:]), scores=list(o[:, OBS_SCORE]),
            cam_ids=[int(x) for x in o[:, OBS_CAM_ID]], bases=list(o[:, OBS_BASE]),
            dirs=list(o[:, OBS_DIR]), idp_base=d["tracks.idp_base"][f],
            idp_m=d["tracks.idp_m"][f], idp_rho=d["tracks.idp_rho"][f],
            tracked=int(d["tracks.tracked"][f]), lost=int(d["tracks.lost"][f]),
        )
    return st


def _maxabs(pairs) -> float:
    m = 0.0
    for a, b in pairs:
        a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
        if a.shape != b.shape:
            return math.inf
        if a.numel():
            d = (a - b).abs().max()
            m = max(m, float(d) if torch.isfinite(d) else math.inf)
    return m


def _cov_gap(ref_P, got_P) -> float:
    """max |ref - got| over sqrt(ref_ii ref_jj), entry by entry."""
    a, b = torch.as_tensor(ref_P).double(), torch.as_tensor(got_P).double()
    if a.shape != b.shape:
        return math.inf
    if not a.numel():
        return 0.0
    sd = a.diagonal().clamp_min(0).sqrt()
    gap = ((a - b).abs() / torch.outer(sd, sd).clamp_min(1e-300)).max()
    return float(gap) if torch.isfinite(gap) else math.inf


def compare(ref: State, got: State) -> dict:
    """The gaps between the reference's state and the program's (or a
    control's): ``mismatches`` counts differing discrete facts (tick and
    camera ids, the tracks and their observations' cameras, track ages,
    the rejection counters); ``state_gap`` is the largest absolute gap of
    the nominal IMU state and the camera poses (m, m/s, rad-scale matrix
    entries), ``cov_gap`` the largest covariance gap of an entry over the
    geometric mean of its two variances (so a gap in the small bias blocks
    weighs as much as one in the position block), ``feat_gap`` the largest gap of a track's
    inverse-depth point (its depth relative) and of its observations.
    Where the discrete facts differ the continuous gaps are infinite."""
    facts = [
        ("step_id", ref.step_id, got.step_id), ("prop_count", ref.prop_count, got.prop_count),
        ("cameras", [c["id"] for c in ref.cams], [c["id"] for c in got.cams]),
        ("tracks", list(ref.feats), list(got.feats)), ("next_id", ref.next_fid, got.next_fid),
        ("epipolar_rejected", ref.n_epi, got.n_epi),
        ("homography_rejected", ref.n_homo, got.n_homo),
        ("gate_rejected", ref.n_gate, got.n_gate),
    ]
    for fid, f in ref.feats.items():
        g = got.feats.get(fid)
        facts.append((f"track {fid} cameras", f.cam_ids, g.cam_ids if g else None))
        facts.append((f"track {fid} ages", (f.tracked, f.lost), (g.tracked, g.lost) if g else None))
    differ = [name for name, a, b in facts if a != b]
    if differ:
        return dict(mismatches=len(differ), state_gap=math.inf, cov_gap=math.inf,
                    feat_gap=math.inf, differ=differ)
    state_gap = _maxabs(
        [(ref.R, got.R), (ref.p, got.p), (ref.v, got.v), (ref.bg, got.bg), (ref.ba, got.ba),
         (ref.ts, got.ts)]
        + [(a["R"], b["R"]) for a, b in zip(ref.cams, got.cams)]
        + [(a["t"], b["t"]) for a, b in zip(ref.cams, got.cams)])
    cov_gap = _cov_gap(ref.P, got.P)
    feat = []
    for fid, f in ref.feats.items():
        g = got.feats[fid]
        feat += [(f.idp_m, g.idp_m), (f.idp_base, g.idp_base),
                 (torch.ones(()), torch.as_tensor(g.idp_rho).double() / torch.as_tensor(f.idp_rho).double())]
        for name in ("kps", "descs", "scores", "bases", "dirs"):
            feat.append((torch.stack(getattr(f, name)), torch.stack(getattr(g, name))))
    return dict(mismatches=0, state_gap=state_gap, cov_gap=cov_gap, feat_gap=_maxabs(feat),
                differ=[])
