"""A frozen NumPy copy of the port's synthetic source and stream preparation
(``msckf_tpu_torch/data/synthetic.py::generate_sequence`` and
``data/stream.py::build_stream``), with the random draws passed in instead
of drawn from a NumPy generator, so that the benchmark's generator can be
held against it draw for draw. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation, Slerp


def segment_poses(position_waypoints, orientation_waypoints, rate: float):
    wp = np.asarray(position_waypoints, dtype=np.float64)
    R0 = Rotation.from_euler("XYZ", orientation_waypoints[0]).as_matrix()
    R1 = Rotation.from_euler("XYZ", orientation_waypoints[1]).as_matrix()
    if len(wp) == 2:
        dist = np.linalg.norm(wp[1] - wp[0])
        n = int(dist * rate)
        t = np.linspace(0.0, 1.0, n)
        pos = (1 - t)[:, None] * wp[0] + t[:, None] * wp[1]
    else:
        dist = np.linalg.norm(wp[1] - wp[0]) + np.linalg.norm(wp[2] - wp[1])
        n = int(dist * rate)
        tk = np.linspace(0.0, 1.0, 3)
        t = np.linspace(0.0, 1.0, n)
        pos = np.stack([CubicSpline(tk, wp[:, d])(t) for d in range(3)], axis=-1)
    slerp = Slerp([0.0, 1.0], Rotation.from_matrix(np.stack([R0, R1])))
    return slerp(t).as_matrix(), pos


def analytic_imu(poses_R, poses_t, dt: float, gravity):
    T = len(poses_t)
    vel = np.zeros((T, 3))
    vel[1:] = (poses_t[1:] - poses_t[:-1]) / dt
    acc = np.zeros((T, 3))
    gyro = np.zeros((T, 3))
    quats = Rotation.from_matrix(poses_R).as_quat()
    for i in range(1, T):
        a_w = (vel[i] - vel[i - 1]) / dt + gravity
        acc[i] = poses_R[i - 1].T @ a_w
        q1 = quats[i - 1]
        q2 = quats[i]
        if np.dot(q1, q2) < 0:
            q2 = -q2
        w1, x1, y1, z1 = q1[3], q1[0], q1[1], q1[2]
        w2, x2, y2, z2 = q2[3], q2[0], q2[1], q2[2]
        gyro[i] = (2.0 / dt) * np.array([
            w1 * x2 - x1 * w2 - y1 * z2 + z1 * y2,
            w1 * y2 + x1 * z2 - y1 * w2 - z1 * x2,
            w1 * z2 - x1 * y2 + y1 * x2 - z1 * w2,
        ])
    return gyro, acc


def generate_sequence(p: dict, point_u, desc_u, n_gyro, n_acc, n_bg, n_ba, n_pixel):
    """One row: ``generate_circle_sequence`` with its draws given."""
    rate = p["rate_hz"]
    dt = 1.0 / rate
    K = np.asarray(p["camera_K"], float)
    R_WC = np.asarray(p["camera_R_IC"], float)
    gravity = np.asarray(p["gravity"], float)
    wp = point_u * np.asarray(p["box_scale"], float) + np.asarray(p["box_origin"], float)
    wd = desc_u / np.linalg.norm(desc_u, axis=1, keepdims=True)

    Rs, ts = [], []
    for _ in range(p["laps"]):
        for seg in p["segments"]:
            r, q = segment_poses(seg["positions"], seg["eulers_xyz"], rate)
            Rs.append(r)
            ts.append(q)
    n0 = p["stationary_prefix"]
    poses_R = np.concatenate([np.tile(np.eye(3), (n0, 1, 1))] + Rs)
    poses_t = np.concatenate([np.zeros((n0, 3))] + ts)
    T = len(poses_t)
    timestamps = np.arange(T) * dt
    gyro_gt, acc_gt = analytic_imu(poses_R, poses_t, dt, gravity)
    gyro = gyro_gt + p["sigma_gyro"] * n_gyro
    acc = acc_gt + p["sigma_acc"] * n_acc
    gyro += np.cumsum(p["sigma_bg"] * n_bg, axis=0)
    acc += np.cumsum(p["sigma_ba"] * n_ba, axis=0)
    gyro[0] = 0
    acc[0] = 0

    score_noisy = 1.0 / (1.0 + 2.0 * p["sigma_pixel"] ** 2)
    cam_ticks, kps, descs, scores = [], [], [], []
    for j, i in enumerate(range(0, T, p["camera_every"])):
        R_wc = poses_R[i] @ R_WC
        pc = (wp - poses_t[i]) @ R_wc
        uvw = pc @ K.T
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = uvw[:, :2] / uvw[:, 2:3]
        vis = (pc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < p["width"]) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < p["height"])
        cam_ticks.append(i)
        kps.append(uv[vis] + p["sigma_pixel"] * n_pixel[j][vis])
        descs.append(wd[vis])
        scores.append(np.full(int(vis.sum()), score_noisy))
    return timestamps, gyro, acc, np.array(cam_ticks), kps, descs, scores


def gravity_align_numpy(mean_acc, gravity):
    g = gravity / np.linalg.norm(gravity)
    a = mean_acc / np.linalg.norm(mean_acc)
    axis = np.cross(a, g)
    n = np.linalg.norm(axis)
    theta = np.arccos(np.clip(a @ g, -1.0, 1.0))
    if np.isclose(theta, 0.0):
        return np.eye(3)
    if np.isclose(theta, np.pi):
        return -np.eye(3)
    axis = axis / n
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * (Kx @ Kx)


def build_stream(gravity, k_max, desc_dim, imu_ts, imu_gyro, imu_acc, cam_ticks,
                 cam_keypoints, cam_descriptors, cam_scores):
    """``build_stream`` with ``skip_first_frame`` and no ``max_ticks``."""
    cam_ticks = np.asarray(cam_ticks)[1:]
    cam_keypoints = list(cam_keypoints)[1:]
    cam_descriptors = list(cam_descriptors)[1:]
    cam_scores = list(cam_scores)[1:]
    T = len(imu_ts)
    init_tick = int(cam_ticks[0])
    R_init = gravity_align_numpy(imu_acc[: init_tick + 1].mean(axis=0), gravity)
    first = int(cam_ticks[1])
    prefix = dict(
        imu_ts=imu_ts[:first], imu_gyro=imu_gyro[:first], imu_acc=imu_acc[:first],
        imu_valid=np.ones(first, dtype=bool), pre_init=np.arange(first) <= init_tick,
    )
    proc_ticks = cam_ticks[1:]
    bounds = np.append(proc_ticks, T)
    lens = np.diff(bounds)
    C, B = len(proc_ticks), int(lens.max())
    fr_ts = np.zeros((C, B))
    fr_gyro = np.zeros((C, B, 3))
    fr_acc = np.zeros((C, B, 3))
    fr_valid = np.zeros((C, B), bool)
    kp = np.zeros((C, k_max, 2))
    desc = np.zeros((C, k_max, desc_dim))
    score = np.zeros((C, k_max))
    kp_valid = np.zeros((C, k_max), bool)
    for j in range(C):
        a, b = int(bounds[j]), int(bounds[j + 1])
        n = b - a
        fr_ts[j, :n] = imu_ts[a:b]
        fr_gyro[j, :n] = imu_gyro[a:b]
        fr_acc[j, :n] = imu_acc[a:b]
        fr_valid[j, :n] = True
        kpi = np.asarray(cam_keypoints[j + 1])
        di = np.asarray(cam_descriptors[j + 1])
        si = np.asarray(cam_scores[j + 1])
        nk = min(len(kpi), k_max)
        kp[j, :nk] = kpi[:nk]
        desc[j, :nk, : di.shape[1]] = di[:nk]
        score[j, :nk] = si[:nk]
        kp_valid[j, :nk] = True
    frames = dict(
        imu_ts=fr_ts, imu_gyro=fr_gyro, imu_acc=fr_acc, imu_valid=fr_valid,
        has_camera=np.ones(C, dtype=bool), kp=kp, desc=desc, score=score, kp_valid=kp_valid,
    )
    return R_init, prefix, frames
