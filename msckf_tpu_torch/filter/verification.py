"""Two-tier geometric match verification over (track x observation)
(port of ``msckf_tpu/filter/verification.py``).

Every historical observation of a matched track votes: a short baseline
(< 0.01 m) uses the rotation-homography symmetric transfer error, a long one
the signed epipolar residual. One failing observation rejects the match, and
the first failing observation decides which rejection counter increments.
The scores come from the verification kernel (``ops/kernels.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msckf_tpu_torch.config import MSCKFConfig, unsupported
from msckf_tpu_torch.filter.state import CameraStates, TrackStore, device_consts
from msckf_tpu_torch.filter.tracks import gather_cam_poses
from msckf_tpu_torch.ops import kernels


class VerifyResult(NamedTuple):
    accept: torch.Tensor  # (F,) bool — match survives all observation votes
    n_homo_rejected: torch.Tensor  # () int
    n_epi_rejected: torch.Tensor  # () int


def verify_matches(cfg: MSCKFConfig, tracks: TrackStore, cams: CameraStates,
                   candidate: torch.Tensor, kp2: torch.Tensor,
                   cam_R: torch.Tensor, cam_t: torch.Tensor) -> VerifyResult:
    if not cfg.use_pallas:
        unsupported("use_pallas", False, "§1 later slices: the XLA-only forms")
    c = device_consts(cfg, kp2.device)
    R1, t1, _ = gather_cam_poses(tracks.obs_cam_id, cams)  # (F, M, 3, 3), (F, M, 3)
    homo_score, epi_score, baseline = kernels.verification_scores(
        R1.contiguous(), t1.contiguous(), tracks.kp.contiguous(), kp2.contiguous(),
        cam_R.contiguous(), cam_t.contiguous(), c.K, c.Kinv,
    )

    short = baseline < 0.01
    reject = torch.where(
        short,
        homo_score > cfg.homography_rejection_threshold,
        epi_score > cfg.epipolar_rejection_threshold,
    )
    reject = reject & tracks.obs_valid & candidate[:, None]

    any_reject = torch.any(reject, dim=-1)
    accept = candidate & ~any_reject

    # first failing observation decides the counter
    M = reject.shape[1]
    cols = torch.arange(M, device=reject.device)
    first_fail = torch.amin(torch.where(reject, cols, M - 1), dim=-1)  # (F,)
    fail_is_homo = torch.gather(short, 1, first_fail[:, None])[:, 0]
    n_homo = torch.sum(any_reject & fail_is_homo)
    n_epi = torch.sum(any_reject & ~fail_is_homo)
    return VerifyResult(accept=accept, n_homo_rejected=n_homo, n_epi_rejected=n_epi)
