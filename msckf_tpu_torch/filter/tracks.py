"""Track-store mutations on fixed-size buffers
(port of ``msckf_tpu/filter/tracks.py``).

  * spawn   — allocate free slots in keypoint-index order
  * extend  — append one observation at index ``n_obs`` for accepted matches
  * compact — order-preserving deletion of observations whose camera was
              marginalized, by cumsum ranks

The JAX package moves rows with one-hot matmuls (TPU gathers serialize);
here they are plain index gathers with the same values: each one-hot row
holds a single 1.0, so the matmul returns the selected row exactly.
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import OBS_CAM_ID, TrackStore, device_consts, pack_obs
from msckf_tpu_torch.ops.geometry import idp_angles_m

I64 = torch.int64


def stable_rank(key: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j : key[j] < key[i], or key[j] == key[i] and j < i}."""
    n = key.shape[0]
    idx = torch.arange(n, device=key.device)
    before = (key[None, :] < key[:, None]) | (
        (key[None, :] == key[:, None]) & (idx[None, :] < idx[:, None])
    )
    return torch.sum(before, dim=1)


def _rows_where(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``mask`` (broadcast over trailing dims), else zero."""
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def spawn_tracks(cfg: MSCKFConfig, tr: TrackStore, diag, next_track_id,
                 kp, desc, score, spawn_mask, cam_R, cam_t, cam_id,
                 defer_obs: bool = False):
    """New feature creation: the k-th spawning keypoint takes the k-th free
    slot. Returns (tracks, diag, next_track_id) and, with ``defer_obs``,
    ``(written (F,), placed_obs0 (F, C))`` for the caller's fused write."""
    dev = kp.device
    K = kp.shape[0]
    c = device_consts(cfg, dev)

    free_rank = torch.cumsum(~tr.valid, dim=0) - 1  # (F,)
    n_free = torch.sum(~tr.valid)
    rank = torch.cumsum(spawn_mask, dim=0) - 1  # (K,)
    overflow = torch.sum(spawn_mask & (rank >= n_free))

    homog = torch.cat([kp, torch.ones((K, 1), dtype=kp.dtype, device=dev)], dim=-1)
    W_v = (homog @ c.Kinv.T) @ cam_R.T  # (K, 3)
    obs0 = pack_obs(kp, score, cam_t.expand(K, 3), W_v, desc, cam_id=cam_id)  # (K, C)

    eq = spawn_mask[:, None] & (~tr.valid)[None, :] & (rank[:, None] == free_rank[None, :])
    written = torch.any(eq, dim=0)  # (F,)
    src = torch.argmax(eq.to(torch.uint8), dim=0)  # spawner per slot (unique)
    placed_obs0 = _rows_where(written, obs0[src])
    placed_m = _rows_where(written, idp_angles_m(W_v)[src])
    new_ids = next_track_id + 1 + rank
    placed_id = torch.sum(torch.where(eq, new_ids[:, None], 0), dim=0)

    one = torch.ones((), dtype=I64, device=dev)
    tracks = tr.replace(
        n_obs=torch.where(written, one, tr.n_obs),
        idp_base=torch.where(written[:, None], cam_t[None], tr.idp_base),
        idp_m=torch.where(written[:, None], placed_m, tr.idp_m),
        idp_rho=torch.where(written, torch.full_like(tr.idp_rho, 0.1), tr.idp_rho),
        tracked=torch.where(written, one, tr.tracked),
        lost=torch.where(written, 0 * one, tr.lost),
        valid=tr.valid | written,
        track_id=torch.where(written, placed_id, tr.track_id),
    )
    if not defer_obs:
        obs = tracks.obs.clone()
        obs[:, 0] = torch.where(written[:, None], placed_obs0, tr.obs[:, 0])
        tracks = tracks.replace(obs=obs)
    diag = diag.replace(n_track_overflow=diag.n_track_overflow + overflow)
    next_id = next_track_id + torch.sum(spawn_mask)
    if defer_obs:
        return tracks, diag, next_id, (written, placed_obs0)
    return tracks, diag, next_id


def extend_tracks(cfg: MSCKFConfig, tracks: TrackStore, accept, kp, desc, score,
                  cam_R, cam_t, cam_id, defer_obs: bool = False):
    """Append an observation to accepted tracks. With ``defer_obs`` returns
    ``(tracks, (colmask (F, M), new_row (F, C)))`` for the caller's write."""
    dev = kp.device
    F, M = cfg.f_max, cfg.m_max
    c = device_consts(cfg, dev)
    homog = torch.cat([kp, torch.ones((F, 1), dtype=kp.dtype, device=dev)], dim=-1)
    W_v = (homog @ c.Kinv.T) @ cam_R.T  # (F, 3)

    # capacity guard: a misconfigured m_max never overwrites the newest obs
    a = accept & (tracks.n_obs < M)
    cols = torch.where(a, torch.clamp(tracks.n_obs, 0, M - 1), M)  # M -> dropped
    new_row = pack_obs(kp, score, cam_t.expand(F, 3), W_v, desc, cam_id=cam_id)
    colmask = torch.arange(M, device=dev)[None, :] == cols[:, None]  # (F, M)
    out = tracks.replace(
        n_obs=torch.where(a, tracks.n_obs + 1, tracks.n_obs),
        tracked=torch.where(a, tracks.tracked + 1, tracks.tracked),
        lost=torch.where(a, torch.zeros_like(tracks.lost), tracks.lost),
    )
    if defer_obs:
        return out, (colmask, new_row)
    return out.replace(
        obs=torch.where(colmask[..., None], new_row[:, None, :], tracks.obs)
    )


def compact_observations(tracks: TrackStore, obs_keep: torch.Tensor) -> TrackStore:
    """Order-preserving deletion of observations: kept observations pack to
    the front in order, slots beyond the new ``n_obs`` come back zeroed with
    the -1 camera-id sentinel, and tracks left empty are invalidated."""
    F, M = tracks.obs.shape[:2]
    dev = tracks.obs.device
    keep = tracks.obs_valid & obs_keep
    kept_rank = torch.cumsum(keep, dim=1) - 1  # (F, M)
    n_obs = torch.sum(keep, dim=1)
    track_alive = tracks.valid & (n_obs > 0)
    # source column of each destination row: kept obs j lands at row
    # kept_rank[j]; the others spill into column M; rows past n_obs read 0
    cols = torch.arange(M, device=dev).expand(F, M)
    dest = torch.where(keep, kept_rank, M)
    src = torch.zeros((F, M + 1), dtype=cols.dtype, device=dev).scatter(1, dest, cols)[:, :M]
    row_live = torch.arange(M, device=dev)[None, :] < n_obs[:, None]
    obs = torch.gather(tracks.obs, 1, src[..., None].expand(tracks.obs.shape))
    # one pass writes the dead rows: zero, with the -1 camera id
    ch_cam = torch.arange(obs.shape[-1], device=dev) == OBS_CAM_ID
    dead = torch.where(ch_cam, -1.0, 0.0).to(obs.dtype)
    obs = torch.where(row_live[..., None], obs, dead)
    return tracks.replace(obs=obs, n_obs=n_obs, valid=track_alive)


def select_rows(idx: torch.Tensor, ok, x: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with rows where ``~ok`` zeroed (False for bool ``x``)."""
    out = x[torch.clamp(idx, 0, x.shape[0] - 1)]
    if ok is True:
        return out
    if x.dtype == torch.bool:
        return ok.reshape(ok.shape + (1,) * (x.ndim - 1)) & out
    return _rows_where(ok, out)


def resolve_cam_slots(obs_cam_id: torch.Tensor, cam_ids: torch.Tensor):
    """Map per-observation camera ids to camera slots: returns (slots,
    found), the first slot holding the id (0 where none does) and whether
    one does."""
    eq = obs_cam_id[..., None] == cam_ids  # (..., N)
    found = torch.any(eq, dim=-1)
    slots = torch.argmax(eq.to(torch.uint8), dim=-1)
    return slots, found


def gather_cam_poses(obs_cam_id: torch.Tensor, cams):
    """Per-observation camera pose lookup as a one-hot product, exactly as
    the JAX package computes it: returns (R (..., 3, 3), t (..., 3), onehot
    (..., N)). An id matching no slot gives zero pose; the id -1 of a dead
    observation matches every free slot. Every consumer masks those rows."""
    w = (obs_cam_id[..., None] == cams.cam_id).to(cams.R.dtype)  # (..., N)
    N = cams.cam_id.shape[0]
    R = (w @ cams.R.reshape(N, 9)).reshape(obs_cam_id.shape + (3, 3))
    t = w @ cams.t
    return R, t, w
