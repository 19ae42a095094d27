"""Sliding-window management: camera marginalization and pruning
(port of ``msckf_tpu/filter/marginalization.py``).

Removal is a compaction permutation over the padded buffers: surviving
cameras keep their insertion order, vacated slots are zeroed. With no
victims the permutation is the identity, so ``remove_cameras`` needs no
branch. Which camera an observation belongs to is looked up once, as its
slot (``observation_cam_slots``); counts, first encounters and victim
membership are scatters into and gathers from (N,) over those slots. The prune's second update keeps the JAX package's ``lax.cond`` on
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


def observation_cam_slots(state: FilterState):
    """Each observation's camera slot: ``(slot, found)``, both (F, M), the
    valid slot holding the observation's camera id and whether one does
    (``slot`` is meaningless where not ``found``).

    A binary search of the ids in slot order, which relies on the window's
    invariant: the valid slots are a prefix, in augmentation order (a new
    camera takes slot ``n``, a removal compacts the survivors in order), so
    their ids (the IMU step of each augmentation) ascend strictly, and free
    slots hold -1. Every per-camera question below is then a gather from or
    a scatter into (N,) over the (F, M) slots, with the same answer as the
    (F, M, N) compare of observation ids against slot ids."""
    cams = state.cams
    N = cams.cam_id.shape[0]
    key = torch.where(cams.valid, cams.cam_id, torch.iinfo(torch.int64).max)  # ascending
    obs_id = state.tracks.obs_cam_id
    slot = torch.clamp(torch.searchsorted(key, obs_id), max=N - 1)
    return slot, key[slot] == obs_id


def remove_cameras(cfg: MSCKFConfig, state: FilterState, victim: torch.Tensor,
                   slots=None) -> FilterState:
    """Marginalize the cameras marked in ``victim`` (slot mask): delete their
    6 covariance rows/cols (permute-compact, zero the tail), drop their
    observations from every track (order-preserving), delete emptied tracks.
    ``slots``: ``observation_cam_slots`` of a state with the same
    observations and camera ids, where the caller has it."""
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

    slot, found = observation_cam_slots(state) if slots is None else slots
    tracks = compact_observations(state.tracks, ~(victim[slot] & found))
    return state.replace(cams=new_cams, P=P, tracks=tracks)


def _live_slots(state: FilterState, slots):
    """(slot, live): each observation's slot, and whether it is a live
    observation of a live track in a valid slot."""
    tr = state.tracks
    slot, found = observation_cam_slots(state) if slots is None else slots
    return slot.reshape(-1), (found & tr.valid[:, None] & tr.obs_valid).reshape(-1)


def cameras_without_features(cfg: MSCKFConfig, state: FilterState, slots=None) -> torch.Tensor:
    """Slot mask of active cameras observed by no live track."""
    return state.cams.valid & (camera_observation_counts(cfg, state, slots) == 0)


def camera_observation_counts(cfg: MSCKFConfig, state: FilterState, slots=None) -> torch.Tensor:
    """Features-per-camera histogram: live observations scattered into
    their slots."""
    slot, live = _live_slots(state, slots)
    zeros = torch.zeros(cfg.n_cam_slots, dtype=torch.int64, device=state.device)
    return zeros.scatter_add(0, slot, live.to(torch.int64))


def camera_first_encounter_rank(cfg: MSCKFConfig, state: FilterState, slots=None) -> torch.Tensor:
    """Rank of each camera slot by the order the reference first encounters
    it: features in creation order (``track_id``), each feature's
    observations chronologically. A camera's first encounter is its live
    observation with the smallest (``track_id``, column): the ids of valid
    tracks are unique and non-negative (each spawn takes the next), so
    they order the tracks as their creation ranks do."""
    M = cfg.m_max
    dev = state.device
    enc = state.tracks.track_id[:, None] * M + torch.arange(M, device=dev)[None, :]  # (F, M)
    slot, live = _live_slots(state, slots)
    unseen = torch.iinfo(torch.int64).max
    first = torch.full((cfg.n_cam_slots,), unseen, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, slot, torch.where(live, enc.reshape(-1), unseen), "amin")
    return stable_rank(first)


def select_prune_victims(cfg: MSCKFConfig, state: FilterState, slots=None) -> torch.Tensor:
    """Slot mask of the (up to) two observed cameras with the fewest
    observations, count ties broken by first-encounter order."""
    N = cfg.n_cam_slots
    if slots is None:
        slots = observation_cam_slots(state)
    counts = camera_observation_counts(cfg, state, slots)
    eligible = state.cams.valid & (counts > 0)
    enc_rank = camera_first_encounter_rank(cfg, state, slots)
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
    # triage and the update write neither the observations nor the camera
    # ids, so this lookup serves the victims, the subset and the removal
    slots = observation_cam_slots(state)
    slot, found = slots
    victim = select_prune_victims(cfg, state, slots)
    if enable is not None:
        victim = victim & enable
    in_victim = victim[slot] & found & state.tracks.obs_valid
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
    return remove_cameras(cfg, state, victim, slots)
