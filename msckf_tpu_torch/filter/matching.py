"""Masked mutual-nearest-neighbor cosine matching
(port of ``msckf_tpu/filter/matching.py``).

cossim = d1 @ d2^T; match12 = argmax over keypoints; match21 = argmax over
tracks; a track matches when the two agree and its best similarity is above
the threshold. Ties resolve to the lowest index (``torch.argmax`` and
``jnp.argmax`` agree on that).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msckf_tpu_torch.filter.state import TrackStore


class MatchResult(NamedTuple):
    track_matched: torch.Tensor  # (F,) bool
    track_to_kp: torch.Tensor  # (F,) int — matched keypoint (valid where matched)
    kp_matched: torch.Tensor  # (K,) bool — keypoint consumed by a match
    any_match: torch.Tensor  # () bool


def fused_descriptors(tracks: TrackStore) -> torch.Tensor:
    """Score-weighted average descriptor per track."""
    w = torch.where(tracks.obs_valid, tracks.score, torch.zeros_like(tracks.score))
    num = torch.einsum("fm,fmd->fd", w, tracks.desc)
    den = torch.sum(w, dim=-1, keepdim=True)
    return num / torch.where(den == 0, torch.ones_like(den), den)


def mutual_match(desc1, valid1, desc2, valid2, min_cossim: float) -> MatchResult:
    neg = torch.full((), -1e30, dtype=desc1.dtype, device=desc1.device)
    sim = desc1 @ desc2.T  # (F, K)
    sim = torch.where(valid1[:, None] & valid2[None, :], sim, neg)

    match12 = torch.argmax(sim, dim=1)  # (F,)
    best12 = torch.amax(sim, dim=1)
    match21 = torch.argmax(sim, dim=0)  # (K,)

    F, K = desc1.shape[0], desc2.shape[0]
    mutual = match21[match12] == torch.arange(F, device=desc1.device)
    if min_cossim > 0:  # upstream skips the similarity gate when <= 0
        good = best12 > min_cossim
    else:
        good = torch.ones_like(mutual)
    track_matched = valid1 & mutual & good & valid2[match12]

    kp_hits = torch.zeros(K, dtype=torch.int64, device=desc1.device)
    kp_matched = kp_hits.scatter_add(0, match12, track_matched.to(torch.int64)) > 0
    return MatchResult(
        track_matched=track_matched,
        track_to_kp=match12,
        kp_matched=kp_matched,
        any_match=torch.any(track_matched),
    )
