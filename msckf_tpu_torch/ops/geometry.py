"""SO(3) primitives over torch tensors (port of ``msckf_tpu/ops/geometry.py``).

Rotations are 3x3 matrices; every function batches over leading dims.
"""

from __future__ import annotations

import torch


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def skew(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: ``(..., 3) -> (..., 3, 3)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues_unit(axis: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """R = I + sin(theta) [axis]_x + (1 - cos(theta)) [axis]_x^2, unit axis."""
    K = skew(axis)
    I = _eye3(axis).expand(K.shape)
    s = torch.sin(theta)[..., None, None]
    c = (1.0 - torch.cos(theta))[..., None, None]
    return I + s * K + c * (K @ K)


def so3_exp(rotvec: torch.Tensor) -> torch.Tensor:
    """Exponential map; the series form below 1e-8 rad avoids 0/0."""
    theta = torch.linalg.vector_norm(rotvec, dim=-1)
    K = skew(rotvec)  # un-normalized rotvec, like the reference
    I = _eye3(rotvec).expand(K.shape)
    t2 = theta * theta
    small = theta < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    return I + a[..., None, None] * K + b[..., None, None] * (K @ K)


def idp_angles_m(direction: torch.Tensor) -> torch.Tensor:
    """Unit bearing m = [cos(phi) sin(theta), -sin(phi), cos(phi) cos(theta)]
    with theta = atan2(x, z), phi = atan2(-y, sqrt(x^2 + z^2))."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    theta = torch.atan2(x, z)
    phi = torch.atan2(-y, torch.sqrt(x * x + z * z))
    return torch.stack(
        [torch.cos(phi) * torch.sin(theta), -torch.sin(phi),
         torch.cos(phi) * torch.cos(theta)],
        dim=-1,
    )
