"""Filter orchestration: the camera-frame step and the sequence loop
(port of ``msckf_tpu/filter/msckf.py``).

The JAX package runs the whole sequence as one ``lax.scan``; here it is a
Python loop over camera-frame blocks, each of which
  1. propagates tick 0 as a 1-tick block (the fused propagation kernel),
  2. runs the camera step: augmentation, score filter, matching,
     verification (kernel), track extension and spawning, triage, EKF update
     (gating kernel), removal of lost tracks and empty cameras, and a prune
     when the window is full,
  3. propagates the remaining ticks as one block (the P15 recurrence kernel).

Host syncs: on the single path the JAX ``lax.cond``s become Python
branches, each of which reads one device value on the host. Per frame: the
prune test (``n > max_camera_states``) unless ``prune_path="masked"``, the
``has_camera`` test unless ``assume_camera``, and on a frame that prunes
with the cond form, the prune's own test before its update. ``FrameStats``
counts them; nothing else in ``frame_step`` reads the device.

With ``batched=True`` (under ``torch.func.vmap``, from
``parallel/batched.py``) every such branch becomes what ``jax.vmap`` makes
of ``lax.cond``: both branches run and each leaf is selected
(``filter/state.py::select_state``). That path reads nothing on the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.augmentation import state_augmentation
from msckf_tpu_torch.filter.marginalization import (
    cameras_without_features, prune_poorest_camera_states, remove_cameras,
)
from msckf_tpu_torch.filter.matching import fused_descriptors, mutual_match
from msckf_tpu_torch.filter.propagation import propagate_block
from msckf_tpu_torch.filter.state import FilterState, init_state, select_state
from msckf_tpu_torch.filter.tracks import extend_tracks, select_rows, spawn_tracks
from msckf_tpu_torch.filter.update import ekf_update, triage_features
from msckf_tpu_torch.filter.verification import verify_matches
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls


@dataclasses.dataclass
class FrameStats:
    """Tally of the loop's control flow. ``frames`` and ``host_syncs`` are
    host counts. The other three are host counts where the loop branches on
    the host; where counting them there would read the device (the batched
    path, the masked prune) they are int64 device tensors, one count per
    sequence on the batched path, to be read once after the loop."""

    frames: int = 0
    camera_steps: int = 0
    prunes: int = 0
    prune_updates: int = 0  # prunes whose features ran a second EKF update
    host_syncs: int = 0

    DEVICE_COUNTS = ("camera_steps", "prunes", "prune_updates")


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def add_camera_measurements(cfg: MSCKFConfig, state: FilterState, kp, desc, score,
                            kp_valid) -> FilterState:
    """Score filter, match, verify, extend/spawn tracks."""
    dt_ = cfg.jdtype
    kp = kp.to(dt_)
    desc = desc.to(dt_)
    score = score.to(dt_)

    # keypoint score filter: keep score >= 0.5 * mean
    n_kp = torch.sum(kp_valid)
    mean = torch.sum(torch.where(kp_valid, score, torch.zeros_like(score))) / torch.clamp(n_kp, min=1)
    keep = kp_valid & (score >= 0.5 * mean)

    cam_slot = state.cams.n - 1  # just augmented
    cam_R = _take(state.cams.R, cam_slot)
    cam_t = _take(state.cams.t, cam_slot)
    cam_id = state.imu.step_id

    # the reference's early exits (no kept keypoints, first frame, no
    # matches) collapse into one activity mask
    tr = state.tracks
    dg = state.diag
    m = mutual_match(fused_descriptors(tr), tr.valid, desc, keep, cfg.min_cosine_similarity)
    no_tracks = ~torch.any(tr.valid)
    act = torch.any(keep) & (m.any_match | no_tracks)

    kp2 = select_rows(m.track_to_kp, True, kp)  # (F, 2)
    v = verify_matches(cfg, tr, state.cams, m.track_matched, kp2, cam_R, cam_t)
    tr, (ext_colmask, ext_row) = extend_tracks(
        cfg, tr, v.accept, kp2,
        select_rows(m.track_to_kp, True, desc),
        select_rows(m.track_to_kp, True, score),
        cam_R, cam_t, cam_id, defer_obs=True,
    )
    # rejected matches and unmatched tracks age by one frame
    bump = ((m.track_matched & ~v.accept) | (tr.valid & ~m.track_matched)) & act
    tr = tr.replace(lost=tr.lost + bump.to(tr.lost.dtype))
    dg = dg.replace(
        n_homography_rejected=dg.n_homography_rejected + v.n_homo_rejected,
        n_epipolar_rejected=dg.n_epipolar_rejected + v.n_epi_rejected,
    )
    tracks, diag, next_id, (sp_written, sp_row) = spawn_tracks(
        cfg, tr, dg, state.next_track_id, kp, desc, score,
        keep & ~m.kp_matched & act, cam_R, cam_t, cam_id, defer_obs=True,
    )
    # one write of the observation buffer for both (row-disjoint) updates
    col0 = torch.arange(cfg.m_max, device=kp.device) == 0
    wmask = ext_colmask | (sp_written[:, None] & col0[None, :])  # (F, M)
    vals = torch.where(sp_written[:, None], sp_row, ext_row)  # (F, C)
    tracks = tracks.replace(obs=torch.where(wmask[..., None], vals[:, None, :], tracks.obs))
    return state.replace(tracks=tracks, diag=diag, next_track_id=next_id)


def process_features(cfg: MSCKFConfig, state: FilterState) -> FilterState:
    """Triage, update, delete lost tracks and empty cameras, all by masks."""
    tri = triage_features(cfg, state, state.tracks.valid)
    state = state.replace(tracks=tri.tracks)
    any_valid = torch.any(tri.valid)

    state = ekf_update(cfg, state, tri.valid)
    tr = state.tracks
    state = state.replace(tracks=tr.replace(valid=tr.valid & ~(tri.lost & any_valid)))
    empty = cameras_without_features(cfg, state) & any_valid
    return remove_cameras(cfg, state, empty)


@with_f32_matmuls
def camera_step(cfg: MSCKFConfig, state: FilterState, kp, desc, score, kp_valid,
                stats: FrameStats | None = None, batched: bool = False) -> FilterState:
    """The camera-frame update, then the prune when the window is full:
    with ``prune_path="masked"`` the prune runs every frame with its
    victims masked off while the window is not full (an exact no-op then);
    with ``"cond"`` (and any other value, as in the JAX package) it is a
    host-side branch, or with ``batched`` a select of both branches (the
    outer on the saturation, the prune's inner on its update, as
    ``jax.vmap`` makes of the JAX package's two ``lax.cond``s)."""
    if cfg.only_imu:
        return state
    state = state_augmentation(cfg, state)
    state = add_camera_measurements(cfg, state, kp, desc, score, kp_valid)
    state = process_features(cfg, state)
    saturated = state.cams.n > cfg.max_camera_states
    if stats is not None:
        stats.camera_steps += 1
    if cfg.prune_path == "masked" or batched:
        if stats is not None:
            stats.prunes = stats.prunes + saturated.to(torch.int64)
        # in the batched cond form the prune's result is selected only where
        # the window is full, so masking its victims elsewhere changes no
        # selected bit; it keeps the prune's update count to the prunes
        pruned = prune_poorest_camera_states(
            cfg, state, enable=saturated, branchless=cfg.prune_path == "masked",
            stats=stats, batched=batched,
        )
        return pruned if cfg.prune_path == "masked" else select_state(saturated, pruned, state)
    saturated = bool(saturated)  # host sync
    if stats is not None:
        stats.host_syncs += 1
        stats.prunes += int(saturated)
    if saturated:
        state = prune_poorest_camera_states(cfg, state, stats=stats)
    return state


class TickOutput(NamedTuple):
    """Per-IMU-tick telemetry."""

    R_WI: torch.Tensor  # (3, 3)
    p_WI: torch.Tensor  # (3,)
    v_WI: torch.Tensor  # (3,)
    sigma_rot: torch.Tensor  # (3,) diag P[0:3]
    sigma_pos: torch.Tensor  # (3,) diag P[12:15]
    n_cams: torch.Tensor  # () int
    n_tracks: torch.Tensor  # () int
    valid: torch.Tensor  # () bool — tick existed


def _tick_output(state: FilterState, valid) -> TickOutput:
    return TickOutput(
        R_WI=state.imu.R_WI,
        p_WI=state.imu.p_WI,
        v_WI=state.imu.v_WI,
        sigma_rot=torch.diagonal(state.P[0:3, 0:3]),
        sigma_pos=torch.diagonal(state.P[12:15, 12:15]),
        n_cams=state.cams.n,
        n_tracks=torch.sum(state.tracks.valid),
        valid=valid,
    )


def _block_outputs(state: FilterState, outs) -> TickOutput:
    R, p, v, s_rot, s_pos, valid = outs
    B = valid.shape[0]
    return TickOutput(
        R_WI=R, p_WI=p, v_WI=v, sigma_rot=s_rot, sigma_pos=s_pos,
        n_cams=state.cams.n.expand(B),
        n_tracks=torch.sum(state.tracks.valid).expand(B),
        valid=valid,
    )


def _stack_outputs(outs) -> TickOutput:
    return TickOutput(*(torch.stack(list(x)) for x in zip(*outs)))


@with_f32_matmuls
def frame_step(cfg: MSCKFConfig, state: FilterState, frame: dict,
               assume_camera: bool = False, stats: FrameStats | None = None,
               batched: bool = False):
    """One camera-frame block: B IMU ticks, the camera on tick 0.

    ``assume_camera``: every block carries a camera (``build_stream``
    guarantees it), so the per-frame ``has_camera`` test and its host sync
    are dropped. ``batched``: the call runs under ``torch.func.vmap`` (the
    batched entry points pass it), so each branch is a select of both
    branches and nothing is read on the host. Returns (state, TickOutput
    with a leading B axis)."""
    ts, gyro, acc, valid = (
        frame["imu_ts"], frame["imu_gyro"], frame["imu_acc"], frame["imu_valid"]
    )
    state, _ = propagate_block(cfg, state, ts[0:1], gyro[0:1], acc[0:1], valid[0:1])

    def cam(s, tally):
        return camera_step(cfg, s, frame["kp"], frame["desc"], frame["score"],
                           frame["kp_valid"], tally, batched)

    if assume_camera:
        state = cam(state, stats)
    elif batched:
        run_cam = frame["has_camera"] & valid[0]
        tally = FrameStats()  # the camera branch's counts, kept where it is selected
        state = select_state(run_cam, cam(state, tally), state)
        if stats is not None:
            for f in FrameStats.DEVICE_COUNTS:
                setattr(stats, f, getattr(stats, f) + run_cam.to(torch.int64) * getattr(tally, f))
    else:
        run_cam = bool(frame["has_camera"] & valid[0])  # host sync
        if stats is not None:
            stats.host_syncs += 1
        if run_cam:
            state = cam(state, stats)
    out0 = _tick_output(state, valid[0])

    state, outs = propagate_block(cfg, state, ts[1:], gyro[1:], acc[1:], valid[1:])
    rest = _block_outputs(state, outs)
    full = TickOutput(*(torch.cat([a[None], b], dim=0) for a, b in zip(out0, rest)))
    if stats is not None:
        stats.frames += 1
    return state, full


@with_f32_matmuls
def run_filter(cfg: MSCKFConfig, state: FilterState, stream: dict,
               assume_camera: bool = False, stats: FrameStats | None = None):
    """Run the filter over prepared frame blocks (leading dims (C, B)).
    Returns (final_state, TickOutput with shape (C, B, ...))."""
    outs = []
    for j in range(stream["imu_ts"].shape[0]):
        frame = {k: v[j] for k, v in stream.items()}
        state, out = frame_step(cfg, state, frame, assume_camera, stats)
        outs.append(out)
    return state, _stack_outputs(outs)


@with_f32_matmuls
def propagate_prefix(cfg: MSCKFConfig, state: FilterState, prefix: dict):
    """Propagate-only prefix before the first processed camera frame; during
    the reference's buffering phase the outputs report the constructor
    state. Returns (state, prefix TickOutput (Bp, ...))."""
    state, outs = propagate_block(
        cfg, state, prefix["imu_ts"], prefix["imu_gyro"], prefix["imu_acc"],
        prefix["imu_valid"],
    )
    pre = _block_outputs(state, outs)
    pi = prefix["pre_init"]
    dt_, dev = cfg.jdtype, state.device
    blank = TickOutput(
        R_WI=torch.eye(3, dtype=dt_, device=dev),
        p_WI=torch.zeros(3, dtype=dt_, device=dev),
        v_WI=torch.zeros(3, dtype=dt_, device=dev),
        sigma_rot=torch.zeros(3, dtype=dt_, device=dev),
        sigma_pos=torch.zeros(3, dtype=dt_, device=dev),
        n_cams=torch.zeros((), dtype=torch.int64, device=dev),
        n_tracks=torch.zeros((), dtype=torch.int64, device=dev),
        valid=torch.zeros((), dtype=torch.bool, device=dev),
    )
    pre = TickOutput(*(
        torch.where(pi.reshape((-1,) + (1,) * (o.ndim - 1)), b[None], o)
        for b, o in zip(blank, pre)
    ))
    return state, pre._replace(valid=prefix["imu_valid"])


@with_f32_matmuls
def run_sequence(cfg: MSCKFConfig, state: FilterState, prefix: dict, frames: dict,
                 assume_camera: bool = False, device=None,
                 stats: FrameStats | None = None):
    """Full sequence: the propagate-only prefix, then the camera-frame
    blocks. Runs on ``device`` (the GPU unless ``device="cpu"``); the state
    and the stream must already live there.

    Returns (final_state, prefix TickOutput (Bp, ...), frame TickOutput
    (C, B, ...))."""
    dev = resolve_device(device)
    check_on_device(state.P, dev, "the filter state")
    for name, x in (*prefix.items(), *frames.items()):
        check_on_device(x, dev, f"stream field {name!r}")
    state, pre_out = propagate_prefix(cfg, state, prefix)
    state, frame_out = run_filter(cfg, state, frames, assume_camera, stats)
    return state, pre_out, frame_out


def make_initial_state(cfg: MSCKFConfig, R_init=None, device=None) -> FilterState:
    """Fresh state on ``device`` (the GPU unless ``device="cpu"``), optionally
    with the gravity-aligned initial orientation from ``build_stream``."""
    state = init_state(cfg, device)
    if R_init is not None:
        R = torch.as_tensor(R_init, dtype=cfg.jdtype, device=state.device)
        state = state.replace(
            imu=state.imu.replace(R_WI=R),
            initialized=torch.ones((), dtype=torch.bool, device=state.device),
        )
    return state
