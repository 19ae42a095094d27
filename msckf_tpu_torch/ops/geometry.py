"""SO(3)/SE(3) primitives over torch tensors (port of
``msckf_tpu/ops/geometry.py``).

Rotations are 3x3 matrices, quaternions scalar-last ``[x, y, z, w]`` (scipy's
convention), isometries ``(R, t)`` pairs with a closed-form inverse. Every
function batches over leading dims and returns tensors on its inputs'
device.
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


def iso_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def iso_inverse(R, t):
    """Closed-form SE(3) inverse."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def iso_apply(R, t, p):
    """Transform point(s) p by (R, t)."""
    return (R @ p[..., None])[..., 0] + t


def iso_rotate(R, p):
    return (R @ p[..., None])[..., 0]


def normalize(v: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=axis, keepdim=True)


def angle_between_directions(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Angle between direction vectors."""
    dot = torch.clamp(torch.sum(normalize(d1) * normalize(d2), dim=-1), -1.0, 1.0)
    return torch.arccos(dot)


def gravity_align_rotation(mean_acc: torch.Tensor, w_gravity: torch.Tensor) -> torch.Tensor:
    """R_W_I aligning the body-frame mean accelerometer with world gravity:
    the Rodrigues rotation about cross(acc_dir, g_dir), identity at theta ~ 0
    and -identity at theta ~ pi (``np.isclose``'s tolerances)."""
    a_dir = normalize(mean_acc)
    g_dir = normalize(w_gravity).expand(a_dir.shape)
    axis = torch.linalg.cross(a_dir, g_dir, dim=-1)
    axis_norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    safe_axis = axis / torch.where(axis_norm < 1e-12, torch.ones_like(axis_norm), axis_norm)
    theta = torch.arccos(torch.clamp(torch.sum(a_dir * g_dir, dim=-1), -1.0, 1.0))
    R = rodrigues_unit(safe_axis, theta)
    I = _eye3(mean_acc).expand(R.shape)
    R = torch.where(torch.isclose(theta, torch.zeros_like(theta))[..., None, None], I, R)
    return torch.where(torch.isclose(theta, torch.full_like(theta, torch.pi))[..., None, None],
                       -I, R)


def svd_orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """The nearest orthogonal matrix in Frobenius norm, U V^T of the SVD."""
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh


# rotation <-> quaternion / euler conversions (scipy-compatible, [x, y, z, w])


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Scalar-last quaternion (normalized first) to a rotation matrix."""
    q = normalize(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to a scalar-last quaternion with w >= 0: Shepperd's
    method, the numerically strongest of its four forms selected without a
    branch."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    qw = torch.sqrt(torch.clamp(qw, min=1e-24))
    case = torch.argmax(qw, dim=-1)

    def mk(i):
        s = qw[..., i] * 2.0
        if i == 0:
            return torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, s / 4.0], -1)
        if i == 1:
            return torch.stack([s / 4.0, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1)
        if i == 2:
            return torch.stack([(m01 + m10) / s, s / 4.0, (m12 + m21) / s, (m02 - m20) / s], -1)
        return torch.stack([(m02 + m20) / s, (m12 + m21) / s, s / 4.0, (m10 - m01) / s], -1)

    cands = torch.stack([mk(0), mk(1), mk(2), mk(3)], dim=-2)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = normalize(torch.take_along_dim(cands, idx, dim=-2)[..., 0, :])
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def _axis_rotation(t: torch.Tensor, axis: int) -> torch.Tensor:
    """The rotation by angle t about coordinate axis 0 (x), 1 (y) or 2 (z)."""
    o, z, c, s = torch.ones_like(t), torch.zeros_like(t), torch.cos(t), torch.sin(t)
    rows = {
        0: [[o, z, z], [z, c, -s], [z, s, c]],
        1: [[c, z, s], [z, o, z], [-s, z, c]],
        2: [[c, -s, z], [s, c, z], [z, z, o]],
    }[axis]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_xyz_intrinsic_to_R(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ euler angles to R, matching scipy's 'XYZ':
    R = Rx(a) @ Ry(b) @ Rz(c)."""
    return (_axis_rotation(euler[..., 0], 0) @ _axis_rotation(euler[..., 1], 1)
            @ _axis_rotation(euler[..., 2], 2))


def R_to_euler_xyz_intrinsic(R: torch.Tensor) -> torch.Tensor:
    """R to intrinsic XYZ euler angles, matching scipy's 'XYZ'. From
    R = Rx(a) Ry(b) Rz(c): R[0,2] = sin b, R[1,2] = -cos b sin a,
    R[2,2] = cos b cos a, R[0,1] = -cos b sin c, R[0,0] = cos b cos c."""
    b = torch.arcsin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    c = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)
