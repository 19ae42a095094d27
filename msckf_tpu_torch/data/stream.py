"""Sensor-stream preparation (port of ``msckf_tpu/data/stream.py``).

``build_stream`` is the JAX package's host-side NumPy pass, copied: it
gravity-aligns the initial orientation from the pre-vision accelerometer
mean, splits the IMU ticks into a propagate-only prefix and camera-frame
blocks (tick 0 of each block carries the camera), and pads keypoints and
descriptors to the config's static shapes. ``to_device`` turns the result
into torch tensors on the GPU (or the CPU, when asked). ``build_image_stream``
is the image-in pipeline's form, which carries the IMU blocks only, and
``suggest_capacities`` sizes the buffers for a dataset. ``circle_streams``
stacks the streams of several seeds of the circle preset for the batched
path.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.ops.device import resolve_device


class PreparedStream(NamedTuple):
    R_init: np.ndarray  # (3, 3) gravity-aligned initial orientation
    prefix: dict  # propagate-only ticks before the first processed frame
    frames: dict  # frame blocks for the main loop
    n_ticks: int  # total IMU ticks represented
    proc_cam_idx: np.ndarray | None = None


def gravity_align_numpy(mean_acc: np.ndarray, gravity: np.ndarray) -> np.ndarray:
    """R_W_I aligning the mean body-frame accelerometer with gravity."""
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


def build_stream(cfg: MSCKFConfig, imu_ts, imu_gyro, imu_acc, cam_ticks,
                 cam_keypoints: Sequence[np.ndarray], cam_descriptors: Sequence[np.ndarray],
                 cam_scores: Sequence[np.ndarray], max_ticks: int | None = None,
                 skip_first_frame: bool = True) -> PreparedStream:
    """Prefix and padded frame blocks from an IMU stream and per-frame
    features. ``cam_ticks[0]`` is the initialization trigger (never
    processed); with ``skip_first_frame`` the reference main loop's unused
    camera index 0 is dropped first."""
    orig_cam_idx = np.arange(len(np.asarray(cam_ticks)))
    if skip_first_frame:
        cam_ticks = np.asarray(cam_ticks)[1:]
        cam_keypoints = list(cam_keypoints)[1:]
        cam_descriptors = list(cam_descriptors)[1:]
        cam_scores = list(cam_scores)[1:]
        orig_cam_idx = orig_cam_idx[1:]
    f64 = np.float64
    imu_ts = np.asarray(imu_ts, f64)
    imu_gyro = np.asarray(imu_gyro, f64)
    imu_acc = np.asarray(imu_acc, f64)
    T = len(imu_ts) if max_ticks is None else min(max_ticks, len(imu_ts))
    cam_ticks = np.asarray(cam_ticks, np.int64)
    keep = cam_ticks < T
    cam_ticks = cam_ticks[keep]
    orig_cam_idx = orig_cam_idx[keep]
    if len(cam_ticks) < 2:
        raise ValueError("need at least two camera frames (init trigger + one)")

    init_tick = int(cam_ticks[0])
    mean_acc = imu_acc[: init_tick + 1].mean(axis=0)
    R_init = gravity_align_numpy(mean_acc, cfg.gravity_np)

    first = int(cam_ticks[1])
    prefix = dict(
        imu_ts=imu_ts[:first],
        imu_gyro=imu_gyro[:first],
        imu_acc=imu_acc[:first],
        imu_valid=np.ones(first, dtype=bool),
        pre_init=np.arange(first) <= init_tick,
    )

    proc_ticks = cam_ticks[1:]
    bounds = np.append(proc_ticks, T)
    lens = np.diff(bounds)
    C = len(proc_ticks)
    B = int(lens.max())
    K, Dd = cfg.k_max, cfg.desc_dim

    fr_ts = np.zeros((C, B), f64)
    fr_gyro = np.zeros((C, B, 3), f64)
    fr_acc = np.zeros((C, B, 3), f64)
    fr_valid = np.zeros((C, B), bool)
    kp = np.zeros((C, K, 2), f64)
    desc = np.zeros((C, K, Dd), f64)
    score = np.zeros((C, K), f64)
    kp_valid = np.zeros((C, K), bool)
    for j in range(C):
        a, b = int(bounds[j]), int(bounds[j + 1])
        n = b - a
        fr_ts[j, :n] = imu_ts[a:b]
        fr_gyro[j, :n] = imu_gyro[a:b]
        fr_acc[j, :n] = imu_acc[a:b]
        fr_valid[j, :n] = True
        kpi = np.asarray(cam_keypoints[j + 1], f64)
        di = np.asarray(cam_descriptors[j + 1], f64)
        si = np.asarray(cam_scores[j + 1], f64)
        nk = min(len(kpi), K)
        kp[j, :nk] = kpi[:nk]
        desc[j, :nk, : di.shape[1]] = di[:nk]
        score[j, :nk] = si[:nk]
        kp_valid[j, :nk] = True

    frames = dict(
        imu_ts=fr_ts, imu_gyro=fr_gyro, imu_acc=fr_acc, imu_valid=fr_valid,
        has_camera=np.ones(C, dtype=bool),
        kp=kp, desc=desc, score=score, kp_valid=kp_valid,
    )
    return PreparedStream(
        R_init=R_init, prefix=prefix, frames=frames, n_ticks=T,
        proc_cam_idx=orig_cam_idx[1:],
    )


def to_device(stream: PreparedStream, cfg: MSCKFConfig, device=None) -> PreparedStream:
    """Float payloads cast to the filter dtype, everything as torch tensors
    on ``device`` (the GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def cast(d):
        out = {}
        for k, v in d.items():
            if v.dtype == np.float64:
                out[k] = torch.as_tensor(v, dtype=cfg.jdtype, device=dev)
            else:
                out[k] = torch.as_tensor(v, device=dev)
        return out

    return PreparedStream(
        R_init=stream.R_init, prefix=cast(stream.prefix), frames=cast(stream.frames),
        n_ticks=stream.n_ticks, proc_cam_idx=stream.proc_cam_idx,
    )


def suggest_capacities(cam_keypoints, max_camera_states: int = 30) -> dict:
    """Heuristic buffer capacities for a dataset (zero overflow on typical
    track churn; the ``Diagnostics`` counters report a run that exceeds
    them). ``k_max`` covers the largest per-frame keypoint count; the track
    slots hold three times it, since weak matching spawns most keypoints as
    fresh tracks that live two or three frames."""
    max_kp = max((len(k) for k in cam_keypoints), default=0)

    def round_up(x, m):
        return ((int(x) + m - 1) // m) * m

    return dict(
        k_max=max(round_up(max_kp, 128), 128),
        f_max=max(round_up(3 * max_kp, 128), 256),
        u_max=48,
        m_max=max_camera_states + 2,
        n_cam_slots=max_camera_states + 2,
    )


IMU_FRAME_KEYS = ("imu_ts", "imu_gyro", "imu_acc", "imu_valid")


def build_image_stream(cfg: MSCKFConfig, imu_ts, imu_gyro, imu_acc, cam_ticks,
                       max_ticks: int | None = None,
                       skip_first_frame: bool = True) -> PreparedStream:
    """``build_stream`` for the image-in pipeline (``msckf_tpu_torch/
    pipeline.py``): no features yet, so ``frames`` carries only the IMU
    keys, and ``proc_cam_idx`` selects the caller's images that line up
    with the frames (``images[stream.proc_cam_idx]``)."""
    C = len(np.asarray(cam_ticks))
    st = build_stream(
        cfg, imu_ts, imu_gyro, imu_acc, cam_ticks, [np.zeros((0, 2))] * C,
        [np.zeros((0, cfg.desc_dim))] * C, [np.zeros((0,))] * C,
        max_ticks=max_ticks, skip_first_frame=skip_first_frame,
    )
    return st._replace(frames={k: st.frames[k] for k in IMU_FRAME_KEYS})


def circle_streams(cfg: MSCKFConfig, seeds, max_ticks: int | None = None,
                   n_world_points: int = 400) -> PreparedStream:
    """One prepared stream of the circle preset per seed, stacked along a
    leading batch axis (``R_init`` (B, 3, 3), every prefix and frame field
    (B, ...)), for the batched entry points; ``to_device`` moves it. The
    seeds change the noise, the world points and the keypoints, not the
    trajectory or the camera ticks, so the streams have equal shapes."""
    streams = []
    for seed in seeds:
        seq = generate_circle_sequence(rng=np.random.default_rng(seed),
                                       n_world_points=n_world_points)
        streams.append(build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc,
                                    seq.cam_frame_ticks, seq.cam_keypoints,
                                    seq.cam_descriptors, seq.cam_scores, max_ticks=max_ticks))

    def stack(dicts):
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    return PreparedStream(
        R_init=np.stack([st.R_init for st in streams]),
        prefix=stack([st.prefix for st in streams]),
        frames=stack([st.frames for st in streams]),
        n_ticks=streams[0].n_ticks, proc_cam_idx=streams[0].proc_cam_idx,
    )
