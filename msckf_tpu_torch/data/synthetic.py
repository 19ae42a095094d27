"""Synthetic circle sequence (host-side NumPy).

The port's own copy of ``msckf_tpu/data/synthetic.py``'s circle preset, kept
here because importing any ``msckf_tpu`` module imports JAX. The arithmetic
and the order of random draws are the same, so one seed gives the same
sequence in both packages: waypoint segments (cubic-spline positions, Slerp
orientations), analytic IMU from pose finite differences plus noise and
random-walk biases, and random 3D points projected through the pinhole
camera into keypoints with random unit descriptors.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation, Slerp


@dataclasses.dataclass
class SyntheticSequence:
    timestamps: np.ndarray  # (T,)
    poses_R: np.ndarray  # (T, 3, 3) ground-truth T_W_Ii rotations
    poses_t: np.ndarray  # (T, 3)
    imu_gyro_gt: np.ndarray  # (T, 3)
    imu_acc_gt: np.ndarray  # (T, 3)
    imu_gyro: np.ndarray  # (T, 3) noisy
    imu_acc: np.ndarray  # (T, 3)
    cam_frame_ticks: np.ndarray  # (C,) tick index of each camera frame
    cam_keypoints: List[np.ndarray]  # per frame (n_i, 2)
    cam_descriptors: List[np.ndarray]  # per frame (n_i, desc)
    cam_scores: List[np.ndarray]  # per frame (n_i,)
    world_points: np.ndarray  # (P, 3)
    world_descriptors: np.ndarray  # (P, desc)


def euler_to_R(euler) -> np.ndarray:
    return Rotation.from_euler("XYZ", euler).as_matrix()


def segment_poses(position_waypoints, orientation_waypoints, rate: float):
    """Poses along one segment: 2 waypoints = linear, 3 = cubic spline;
    orientations Slerp between the two end eulers; ~``rate`` samples per m."""
    wp = np.asarray(position_waypoints, dtype=np.float64)
    R0 = euler_to_R(orientation_waypoints[0])
    R1 = euler_to_R(orientation_waypoints[1])
    if len(wp) == 2:
        dist = np.linalg.norm(wp[1] - wp[0])
        n = int(dist * rate)
        t = np.linspace(0.0, 1.0, n)
        pos = (1 - t)[:, None] * wp[0] + t[:, None] * wp[1]
    elif len(wp) == 3:
        dist = np.linalg.norm(wp[1] - wp[0]) + np.linalg.norm(wp[2] - wp[1])
        n = int(dist * rate)
        tk = np.linspace(0.0, 1.0, 3)
        t = np.linspace(0.0, 1.0, n)
        pos = np.stack([CubicSpline(tk, wp[:, d])(t) for d in range(3)], axis=-1)
    else:
        raise ValueError("segments take 2 (linear) or 3 (cubic) waypoints")
    slerp = Slerp([0.0, 1.0], Rotation.from_matrix(np.stack([R0, R1])))
    return slerp(t).as_matrix(), pos


def analytic_imu(poses_R, poses_t, dt: float, gravity):
    """Body-frame accel/gyro from pose finite differences; index 0 is zero."""
    T = len(poses_t)
    vel = np.zeros((T, 3))
    vel[1:] = (poses_t[1:] - poses_t[:-1]) / dt
    acc = np.zeros((T, 3))
    gyro = np.zeros((T, 3))
    quats = Rotation.from_matrix(poses_R).as_quat()  # (T, 4) x,y,z,w
    for i in range(1, T):
        a_w = (vel[i] - vel[i - 1]) / dt + gravity
        acc[i] = poses_R[i - 1].T @ a_w
        q1 = quats[i - 1]
        q2 = quats[i]
        if np.dot(q1, q2) < 0:
            q2 = -q2
        w1, x1, y1, z1 = q1[3], q1[0], q1[1], q1[2]
        w2, x2, y2, z2 = q2[3], q2[0], q2[1], q2[2]
        gyro[i] = (2.0 / dt) * np.array(
            [
                w1 * x2 - x1 * w2 - y1 * z2 + z1 * y2,
                w1 * y2 + x1 * z2 - y1 * w2 - z1 * x2,
                w1 * z2 - x1 * y2 + y1 * x2 - z1 * w2,
            ]
        )
    return gyro, acc


def random_world_points(rng, n_points: int, scale, origin, desc_dim: int = 10):
    """Uniform box of 3D points with random unit descriptors."""
    wp = rng.random((n_points, 3)) * np.asarray(scale, float) + np.asarray(origin, float)
    wd = rng.random((n_points, desc_dim))
    wd /= np.linalg.norm(wd, axis=1, keepdims=True)
    return wp, wd


def circle_segments() -> list:
    """The "circular" preset: a closed loop of four cubic segments."""
    s2 = np.sqrt(2.0)
    return [
        ([[0, 0, 0], [s2, 2 - s2, 0], [2, 2, 0]], [[0, 0, 0], [0, 0, np.pi / 2]]),
        ([[2, 2, 0], [s2, 2 + s2, 0], [0, 4, 0]], [[0, 0, np.pi / 2], [0, 0, np.pi]]),
        ([[0, 4, 0], [-s2, 2 + s2, 0], [-2, 2, 0]], [[0, 0, np.pi], [0, 0, 3 * np.pi / 2]]),
        ([[-2, 2, 0], [-s2, 2 - s2, 0], [0, 0, 0]], [[0, 0, 3 * np.pi / 2], [0, 0, 0]]),
    ]


def generate_sequence(segments, world_points, world_descriptors, rng=None,
                      rate: float = 200.0, camera_every: int = 10, K=None, R_WC=None,
                      width: int = 640, height: int = 480, sigma_pixel: float = 0.01,
                      sigma_acc: float = 1e-4, sigma_gyro: float = 1e-5,
                      sigma_ba: float = 1e-5, sigma_bg: float = 1e-6,
                      stationary_prefix: int = 19, gravity=None) -> SyntheticSequence:
    """Full synthetic sequence from waypoint segments and world points."""
    rng = rng or np.random.default_rng(42)
    if K is None:
        K = np.array([[180.0, 0, 320], [0, 180.0, 240], [0, 0, 1]])
    if R_WC is None:
        R_WC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    if gravity is None:
        gravity = np.array([0.0, 0.0, -9.81])
    dt = 1.0 / rate
    wp, wd = np.asarray(world_points, float), np.asarray(world_descriptors, float)

    Rs, ts = [], []
    for pw, ow in segments:
        r, p = segment_poses(np.array(pw, dtype=float), np.array(ow, dtype=float), rate)
        Rs.append(r)
        ts.append(p)
    poses_R = np.concatenate([np.tile(np.eye(3), (stationary_prefix, 1, 1))] + Rs)
    poses_t = np.concatenate([np.zeros((stationary_prefix, 3))] + ts)
    T = len(poses_t)
    timestamps = np.arange(T) * dt

    gyro_gt, acc_gt = analytic_imu(poses_R, poses_t, dt, gravity)

    gyro = gyro_gt + rng.normal(0, sigma_gyro, (T, 3))
    acc = acc_gt + rng.normal(0, sigma_acc, (T, 3))
    bg = np.cumsum(rng.normal(0, sigma_bg, (T, 3)), axis=0)
    ba = np.cumsum(rng.normal(0, sigma_ba, (T, 3)), axis=0)
    gyro += bg
    acc += ba
    gyro[0] = 0
    acc[0] = 0

    score_noisy = 1.0 / (1.0 + 2.0 * sigma_pixel**2)
    cam_ticks, kps, descs, scores = [], [], [], []
    for i in range(0, T, camera_every):
        R_wc = poses_R[i] @ R_WC
        t_wc = poses_t[i]
        pc = (wp - t_wc) @ R_wc  # R_wc^T (wp - t)
        uvw = pc @ K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = uvw[:, :2] / uvw[:, 2:3]
        vis = (pc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        uv_n = uv[vis] + rng.normal(0, sigma_pixel, (int(vis.sum()), 2))
        cam_ticks.append(i)
        kps.append(uv_n)
        descs.append(wd[vis])
        scores.append(np.full(int(vis.sum()), score_noisy))

    return SyntheticSequence(
        timestamps=timestamps, poses_R=poses_R, poses_t=poses_t,
        imu_gyro_gt=gyro_gt, imu_acc_gt=acc_gt, imu_gyro=gyro, imu_acc=acc,
        cam_frame_ticks=np.array(cam_ticks), cam_keypoints=kps,
        cam_descriptors=descs, cam_scores=scores,
        world_points=wp, world_descriptors=wd,
    )


def generate_circle_sequence(rng=None, n_world_points: int = 400, desc_dim: int = 10,
                             **kwargs) -> SyntheticSequence:
    """Circle preset: 400 points in a 12x12x5 box at (-6, -4, 0)."""
    rng = rng or np.random.default_rng(42)
    wp, wd = random_world_points(rng, n_world_points, [12.0, 12.0, 5.0], [-6.0, -4.0, 0.0], desc_dim)
    return generate_sequence(circle_segments(), wp, wd, rng=rng, **kwargs)
