"""Sliding-window management: camera marginalization and pruning
(port of ``msckf_tpu/filter/marginalization.py``).

Removal is a compaction permutation over the padded buffers: surviving
cameras keep their insertion order, vacated slots are zeroed. With no
victims the permutation is the identity, so ``remove_cameras`` needs no
branch. The prune's second update keeps the JAX package's ``lax.cond`` on
``any(triage.valid)`` in one of three forms: a Python branch (one host sync
on a frame that prunes), a select of both branches under
``torch.func.vmap``, or, with ``branchless``, the update run unconditionally
(with no valid feature it is the exact identity).
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import FilterState, select_state
from msckf_tpu_torch.filter.tracks import compact_observations, select_rows, stable_rank
from msckf_tpu_torch.filter.update import ekf_update, triage_features
from msckf_tpu_torch.utils import tracing


def remove_cameras(cfg: MSCKFConfig, state: FilterState, victim: torch.Tensor) -> FilterState:
    """Marginalize the cameras marked in ``victim`` (slot mask): delete their
    6 covariance rows/cols (permute-compact, zero the tail), drop their
    observations from every track (order-preserving), delete emptied tracks."""
    N, D = cfg.n_cam_slots, cfg.err_dim
    dev = state.device
    cams = state.cams
    victim = victim & cams.valid
    keep = cams.valid & ~victim

    # dest slot i <- the kept slot with cumsum-rank i
    krank = torch.cumsum(keep, dim=0) - 1
    ar_N = torch.arange(N, device=dev)
    src = torch.sum(
        torch.where(keep[None, :] & (krank[None, :] == ar_N[:, None]), ar_N, 0), dim=1
    )  # 0 beyond n_new, masked by slot_live
    n_new = torch.sum(keep)
    slot_live = ar_N < n_new

    eye = torch.eye(3, dtype=cams.R.dtype, device=dev)
    new_cams = cams.replace(
        R=torch.where(slot_live[:, None, None], select_rows(src, slot_live, cams.R), eye),
        t=select_rows(src, slot_live, cams.t),
        cam_id=torch.where(slot_live, select_rows(src, slot_live, cams.cam_id), -1),
        valid=slot_live,
        n=n_new,
    )

    # covariance permutation: rows/cols [0:15] + 6 per kept camera, tail zeroed
    perm = torch.cat([
        torch.arange(15, device=dev),
        (15 + 6 * src[:, None] + torch.arange(6, device=dev)[None, :]).reshape(-1),
    ])
    live_rows = torch.cat([
        torch.ones(15, dtype=torch.bool, device=dev), torch.repeat_interleave(slot_live, 6)
    ])
    P = state.P[perm][:, perm]
    P = torch.where(live_rows[:, None] & live_rows[None, :], P,
                    torch.zeros((), dtype=P.dtype, device=dev))

    obs_is_victim = _obs_in_cam_mask(state.tracks.obs_cam_id, cams.cam_id, victim)
    tracks = compact_observations(state.tracks, ~obs_is_victim)
    return state.replace(cams=new_cams, P=P, tracks=tracks)


def _obs_in_cam_mask(obs_cam_id, cam_ids, cam_mask) -> torch.Tensor:
    """(F, M) bool: the observation's camera id resolves to a slot in
    ``cam_mask``."""
    eq = obs_cam_id[..., None] == cam_ids  # (F, M, N)
    return torch.any(eq & cam_mask, dim=-1)


def _per_camera_obs_mask(state: FilterState) -> torch.Tensor:
    """(F, M, N) bool: live observation (f, m) belongs to camera slot n."""
    tr = state.tracks
    eq = tr.obs_cam_id[..., None] == state.cams.cam_id
    return eq & (tr.valid[:, None] & tr.obs_valid)[..., None]


def cameras_without_features(cfg: MSCKFConfig, state: FilterState) -> torch.Tensor:
    """Slot mask of active cameras observed by no live track."""
    any_obs = torch.any(_per_camera_obs_mask(state).flatten(0, 1), dim=0)
    return state.cams.valid & ~any_obs


def camera_observation_counts(cfg: MSCKFConfig, state: FilterState) -> torch.Tensor:
    """Features-per-camera histogram."""
    return torch.sum(_per_camera_obs_mask(state).flatten(0, 1), dim=0)


def camera_first_encounter_rank(cfg: MSCKFConfig, state: FilterState) -> torch.Tensor:
    """Rank of each camera slot by the order the reference first encounters
    it: features in creation order (``track_id``), each feature's
    observations chronologically."""
    tr = state.tracks
    F, M = cfg.f_max, cfg.m_max
    dev = state.device
    per_cam = _per_camera_obs_mask(state)  # (F, M, N)
    seq = torch.where(tr.valid, tr.track_id, 1 << 30)
    trank = stable_rank(seq)
    enc = trank[:, None] * M + torch.arange(M, device=dev)[None, :]  # (F, M)
    first = torch.amin(
        torch.where(per_cam, enc[..., None], F * M).flatten(0, 1), dim=0
    )
    return stable_rank(first)


def select_prune_victims(cfg: MSCKFConfig, state: FilterState) -> torch.Tensor:
    """Slot mask of the (up to) two observed cameras with the fewest
    observations, count ties broken by first-encounter order."""
    N = cfg.n_cam_slots
    counts = camera_observation_counts(cfg, state)
    eligible = state.cams.valid & (counts > 0)
    enc_rank = camera_first_encounter_rank(cfg, state)
    key = torch.where(eligible, counts * N + enc_rank, 1 << 24)
    n_victims = torch.clamp(torch.sum(eligible), max=2)
    return stable_rank(key) < n_victims


@tracing.span("prune")
def prune_poorest_camera_states(cfg: MSCKFConfig, state: FilterState, enable=None,
                                branchless: bool = False, stats=None,
                                batched: bool = False) -> FilterState:
    """Pick the (up to) two observed cameras with the fewest observations,
    run a final update over the features that observe them, then
    marginalize them.

    ``enable`` (a 0-dim bool tensor): no victims where it is False, which
    makes the whole call an exact no-op (an empty triage subset, A = 0 and
    c = 0, the identity permutation). ``branchless``: the update runs
    whether or not a feature is valid (``prune_path="masked"``). Otherwise
    the update is the JAX package's ``lax.cond``: with ``batched`` (under
    ``torch.func.vmap``) both branches run and are selected, else a Python
    branch reads ``any(valid)`` on the host (one sync, counted in
    ``stats``). ``stats.prune_updates`` counts prunes whose update ran: a
    device tensor where a host count would need a sync."""
    victim = select_prune_victims(cfg, state)
    if enable is not None:
        victim = victim & enable
    in_victim = (
        _obs_in_cam_mask(state.tracks.obs_cam_id, state.cams.cam_id, victim)
        & state.tracks.obs_valid
    )
    subset = state.tracks.valid & torch.any(in_victim, dim=-1)

    tri = triage_features(cfg, state, subset)
    state = state.replace(tracks=tri.tracks)
    any_valid = torch.any(tri.valid)
    if branchless or batched:
        updated = ekf_update(cfg, state, tri.valid)
        state = updated if branchless else select_state(any_valid, updated, state)
        if stats is not None:
            stats.prune_updates = stats.prune_updates + any_valid.to(torch.int64)
    else:
        run_update = bool(any_valid)  # host sync
        if stats is not None:
            stats.host_syncs += 1
            stats.prune_updates += int(run_update)
        if run_update:
            state = ekf_update(cfg, state, tri.valid)
    return remove_cameras(cfg, state, victim)
