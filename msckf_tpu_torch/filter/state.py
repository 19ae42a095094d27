"""Fixed-size padded filter state (port of ``msckf_tpu/filter/state.py``).

The same padded shapes and the same packed observation channels as the JAX
package: camera slots compacted at the front, a (D, D) covariance with
D = 15 + 6 * n_cam_slots whose rows/cols beyond the active window are zero,
and track slots whose observations are front-packed (valid == col < n_obs).
Each state piece is a dataclass of tensors; functions return new objects
through ``replace`` rather than mutating, like the JAX pytrees they mirror.

Integer fields are int64 (torch's index type) where the JAX package uses
int32; the values are the same.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.ops.device import resolve_device
from msckf_tpu_torch.utils import tracing

I64 = torch.int64


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class ImuState(_Replace):
    R_WI: torch.Tensor  # (3, 3) current orientation
    p_WI: torch.Tensor  # (3,)
    v_WI: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,) gyro bias
    ba: torch.Tensor  # (3,) accel bias
    timestamp: torch.Tensor  # () float
    step_id: torch.Tensor  # () int — IMU step counter
    prop_count: torch.Tensor  # () int — propagation steps done (first-step null quirk)


@dataclasses.dataclass
class CameraStates(_Replace):
    R: torch.Tensor  # (N, 3, 3) R_W_Ci
    t: torch.Tensor  # (N, 3)
    cam_id: torch.Tensor  # (N,) int — IMU step id at augmentation, -1 when free
    valid: torch.Tensor  # (N,) bool
    n: torch.Tensor  # () int active count (active slots are 0..n-1)


# packed per-observation channel layout:
#   [kp(2) | score(1) | line_base(3) | line_dir(3) | cam_id(1) | descriptor]
# cam_id rides as a float channel (exact up to 2^24); -1 marks a dead slot
OBS_KP = slice(0, 2)
OBS_SCORE = 2
OBS_BASE = slice(3, 6)
OBS_DIR = slice(6, 9)
OBS_CAM_ID = 9
OBS_DESC = 10  # start of descriptor channels


def obs_channels(desc_dim: int) -> int:
    return OBS_DESC + desc_dim


def pack_obs(kp, score, line_base, line_dir, desc, cam_id=None):
    """Stack per-observation fields into the packed channel layout."""
    shape = kp.shape[:-1]
    if cam_id is None:
        cam = torch.full(shape, -1.0, dtype=kp.dtype, device=kp.device)
    else:
        cam = torch.as_tensor(cam_id).to(kp.dtype).expand(shape)
    return torch.cat(
        [kp, score[..., None], line_base, line_dir, cam[..., None], desc], dim=-1
    )


@dataclasses.dataclass
class TrackStore(_Replace):
    obs: torch.Tensor  # (F, M, C) packed per-observation channels
    n_obs: torch.Tensor  # (F,) int — observations are packed at the front
    idp_base: torch.Tensor  # (F, 3) anchor position frozen at creation
    idp_m: torch.Tensor  # (F, 3) unit bearing
    idp_rho: torch.Tensor  # (F,) inverse depth
    tracked: torch.Tensor  # (F,) int tracked_for_n_frames
    lost: torch.Tensor  # (F,) int lost_for_n_frames
    valid: torch.Tensor  # (F,) bool live track
    track_id: torch.Tensor  # (F,) int creation-order id

    @property
    def kp(self):  # (F, M, 2)
        return self.obs[..., OBS_KP]

    @property
    def score(self):  # (F, M)
        return self.obs[..., OBS_SCORE]

    @property
    def line_base(self):  # (F, M, 3) camera center at observation time
        return self.obs[..., OBS_BASE]

    @property
    def line_dir(self):  # (F, M, 3) world ray at observation time
        return self.obs[..., OBS_DIR]

    @property
    def obs_cam_id(self):  # (F, M) int camera id of each observation
        return self.obs[..., OBS_CAM_ID].to(I64)

    @property
    def obs_valid(self):  # (F, M) bool — front-packed invariant
        M = self.obs.shape[1]
        return torch.arange(M, device=self.obs.device)[None, :] < self.n_obs[:, None]

    @property
    def desc(self):  # (F, M, Dd)
        return self.obs[..., OBS_DESC:]


@dataclasses.dataclass
class Diagnostics(_Replace):
    """Fault-rejection counters plus capacity-overflow counters."""

    n_homography_rejected: torch.Tensor  # () int
    n_epipolar_rejected: torch.Tensor  # () int
    n_gating_rejected: torch.Tensor  # () int
    n_track_overflow: torch.Tensor  # () int — spawns dropped: f_max exceeded
    n_update_overflow: torch.Tensor  # () int — valid features beyond u_max


@dataclasses.dataclass
class FilterState(_Replace):
    imu: ImuState
    cams: CameraStates
    P: torch.Tensor  # (D, D) error-state covariance
    tracks: TrackStore
    initialized: torch.Tensor  # () bool — IMU initialized
    next_track_id: torch.Tensor  # () int
    diag: Diagnostics

    @property
    def device(self) -> torch.device:
        return self.P.device


def init_state(cfg: MSCKFConfig, device=None) -> FilterState:
    """Fresh filter state: identity pose, zero covariance."""
    dev = resolve_device(device)
    dt = cfg.jdtype
    N, F, M, Dd = cfg.n_cam_slots, cfg.f_max, cfg.m_max, cfg.desc_dim
    D = cfg.err_dim

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    imu = ImuState(
        R_WI=torch.eye(3, dtype=dt, device=dev),
        p_WI=z(3), v_WI=z(3), bg=z(3), ba=z(3),
        timestamp=z(),
        step_id=z(dtype=I64),
        prop_count=z(dtype=I64),
    )
    cams = CameraStates(
        R=torch.eye(3, dtype=dt, device=dev).expand(N, 3, 3).clone(),
        t=z(N, 3),
        cam_id=torch.full((N,), -1, dtype=I64, device=dev),
        valid=z(N, dtype=torch.bool),
        n=z(dtype=I64),
    )
    obs0 = z(F, M, obs_channels(Dd))
    obs0[..., OBS_CAM_ID] = -1.0
    tracks = TrackStore(
        obs=obs0,
        n_obs=z(F, dtype=I64),
        idp_base=z(F, 3),
        idp_m=z(F, 3),
        idp_rho=torch.full((F,), 0.1, dtype=dt, device=dev),
        tracked=z(F, dtype=I64),
        lost=z(F, dtype=I64),
        valid=z(F, dtype=torch.bool),
        track_id=torch.full((F,), -1, dtype=I64, device=dev),
    )
    diag = Diagnostics(*(z(dtype=I64) for _ in range(5)))
    return FilterState(
        imu=imu, cams=cams, P=z(D, D), tracks=tracks,
        initialized=z(dtype=torch.bool), next_track_id=z(dtype=I64), diag=diag,
    )


# --- carrying state across frameworks: a flat dict of numpy arrays ---


def _flatten(obj, prefix, out):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            _flatten(v, key + ".", out)
        else:
            out[key] = v
    return out


def state_to_numpy(state: FilterState) -> dict:
    """Flat dict of numpy arrays keyed by field path (``"imu.R_WI"``,
    ``"tracks.obs"``, ``"P"``, ...)."""
    return {k: v.detach().cpu().numpy() for k, v in _flatten(state, "", {}).items()}


def state_from_numpy(d: dict, device=None) -> FilterState:
    """Inverse of :func:`state_to_numpy`. Floats keep their dtype, integers
    become int64, booleans stay boolean."""
    dev = resolve_device(device)

    def build(cls, prefix):
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{prefix}{f.name}"
            sub = _STATE_CLASSES.get(f.name) if cls is FilterState else None
            if sub is not None:
                kw[f.name] = build(sub, key + ".")
                continue
            a = np.asarray(d[key])
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int64)
            kw[f.name] = torch.as_tensor(a, device=dev).clone()
        return cls(**kw)

    return build(FilterState, "")


_STATE_CLASSES = {
    "imu": ImuState, "cams": CameraStates, "tracks": TrackStore, "diag": Diagnostics,
}

# torch pytrees, as the JAX package's state classes are JAX pytrees: so
# torch.func.vmap maps over a FilterState leaf by leaf (parallel/batched.py)
for _cls in (*_STATE_CLASSES.values(), FilterState):
    torch.utils._pytree.register_dataclass(_cls)


@tracing.span("select")
def select_state(pred: torch.Tensor, on_true, on_false):
    """What ``jax.vmap`` makes of ``lax.cond``: both branches have run, and
    every leaf of the result is the true branch's where ``pred``, else the
    false branch's (``pred`` is a 0-dim bool, one per sequence under
    ``torch.func.vmap``)."""
    return torch.utils._pytree.tree_map(
        lambda a, b: torch.where(pred, a, b), on_true, on_false
    )


@functools.lru_cache(maxsize=16)
def device_consts(cfg: MSCKFConfig, device: torch.device) -> SimpleNamespace:
    """The config's constant matrices as tensors on ``device``, made once.

    Building them from numpy inside the frame loop would copy from the host
    on every frame, and a pageable host-to-device copy waits for the device.
    """
    dt = cfg.jdtype

    def t(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return SimpleNamespace(
        K=t(cfg.K_np),
        Kinv=t(cfg.K_inv_np),
        R_IC=t(cfg.R_WC_np),
        t_IC=t(cfg.t_WC_np),
        gravity=t(cfg.gravity_np),
        qc=t(cfg.noise_cov_diag_np),
        chi2=t(cfg.chi2_table_np),
    )
