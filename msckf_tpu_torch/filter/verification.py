"""Two-tier geometric match verification over (track x observation)
(port of ``msckf_tpu/filter/verification.py``).

Every historical observation of a matched track votes: a short baseline
(< 0.01 m) uses the rotation-homography symmetric transfer error, a long one
the signed epipolar residual. One failing observation rejects the match, and
the first failing observation decides which rejection counter increments.
The scores come from the verification kernel (``ops/kernels.py``) or, with
``use_pallas=False``, from :func:`_scores_xla`, the JAX package's XLA form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import CameraStates, TrackStore, device_consts
from msckf_tpu_torch.filter.tracks import gather_cam_poses
from msckf_tpu_torch.ops import kernels
from msckf_tpu_torch.ops.geometry import skew
from msckf_tpu_torch.ops.smallmat import matmul_small, matvec_small, transpose_small
from msckf_tpu_torch.utils import tracing


class VerifyResult(NamedTuple):
    accept: torch.Tensor  # (F,) bool — match survives all observation votes
    n_homo_rejected: torch.Tensor  # () int
    n_epi_rejected: torch.Tensor  # () int


@tracing.span("verify")
def verify_matches(cfg: MSCKFConfig, tracks: TrackStore, cams: CameraStates,
                   candidate: torch.Tensor, kp2: torch.Tensor,
                   cam_R: torch.Tensor, cam_t: torch.Tensor) -> VerifyResult:
    c = device_consts(cfg, kp2.device)
    R1, t1, _ = gather_cam_poses(tracks.obs_cam_id, cams)  # (F, M, 3, 3), (F, M, 3)
    if cfg.use_pallas:
        homo_score, epi_score, baseline = kernels.verification_scores(
            R1.contiguous(), t1.contiguous(), tracks.kp.contiguous(), kp2.contiguous(),
            cam_R.contiguous(), cam_t.contiguous(), c.K, c.Kinv,
        )
    else:
        homo_score, epi_score, baseline = _scores_xla(R1, t1, tracks.kp, kp2, cam_R, cam_t,
                                                      c.K, c.Kinv)

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


def _scores_xla(R1, t1, kp1, kp2, cam_R, cam_t, K, Kinv):
    """(homography symmetric transfer error, signed epipolar residual,
    baseline) per (track, observation) by small batched products, the JAX
    package's form without the kernel. T_C1_C2 = T_W_C1^-1 T_W_C2 gives R12
    and t12; H = K R12 K^-1 and its inverse K R12^T K^-1 give the two
    transfer errors, F = K^-T [t12]x R12 K^-1 the epipolar residual
    x2^T F x1. Both projective divisions keep the kernel's guard |z| >= 1e-30,
    where the JAX package's XLA form divides unguarded."""
    R1t = transpose_small(R1)
    R12 = matmul_small(R1t, cam_R.expand(R1.shape))  # (F, M, 3, 3)
    t12 = matvec_small(R1t, cam_t - t1)  # (F, M, 3) == R1^T (t2 - t1)
    baseline = torch.linalg.vector_norm(t12, dim=-1)

    x1 = torch.cat([kp1, torch.ones_like(kp1[..., :1])], dim=-1)  # (F, M, 3)
    x2 = torch.cat([kp2, torch.ones_like(kp2[..., :1])], dim=-1)  # (F, 3)

    def project(x):
        z = x[..., 2:3]
        return x[..., :2] / torch.where(z.abs() < 1e-30, torch.full_like(z, 1e-30), z)

    Kb = K.expand(R12.shape)
    Kinvb = Kinv.expand(R12.shape)
    H = matmul_small(matmul_small(Kb, R12), Kinvb)
    Hinv = matmul_small(matmul_small(Kb, transpose_small(R12)), Kinvb)
    x1_pred = project(matvec_small(Hinv, x2[:, None, :].expand(H.shape[:-1])))
    x2_pred = project(matvec_small(H, x1))
    # the current keypoint against H^-1 x2, as the reference compares them
    homo_score = 0.5 * (torch.linalg.vector_norm(kp2[:, None, :] - x1_pred, dim=-1)
                        + torch.linalg.vector_norm(kp1 - x2_pred, dim=-1))

    Fm = matmul_small(matmul_small(matmul_small(Kinv.T.expand(R12.shape), skew(t12)), R12),
                      Kinvb)
    epi_score = torch.sum(x2[:, None, :] * matvec_small(Fm, x1), dim=-1)
    return homo_score, epi_score, baseline
