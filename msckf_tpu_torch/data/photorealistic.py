"""Synthetic IMU from ground-truth trajectories in the TartanAir and
PeringLab formats (port of ``msckf_tpu/data/photorealistic.py``).

Camera-frame poses are re-framed into the IMU/world frame, upsampled 10x
(positions by lerp, rotations by Slerp), turned into accelerometer and
gyroscope readings by finite differences and the quaternion-rate formula,
and given white noise and random-walk biases; ``camera.csv``, ``imu.csv``,
``imu_gt.csv`` and ``transforms_gt.csv`` are written through
``data/parser.py::write_table`` (20 Hz camera with a 3-frame stationary
prefix, ~200 Hz IMU). numpy and scipy, no pandas: the same ``rng`` gives the
JAX module's bits, and the files are the same bytes.

The JAX module reads the raw trajectory with pandas, whose default float
converter is not correctly rounded: it keeps 17 digits, leading zeros
included. ``load_raw_trajectory`` reads it with the same arithmetic
(``_pandas_float``), so both packages start from the same poses; the
port's dataset parser (``data/parser.py``) reads the CSVs it writes
correctly rounded, as its native reader does.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation, Slerp

from msckf_tpu_torch.data.parser import write_table
from msckf_tpu_torch.data.synthetic import analytic_imu

TRAJECTORY_FORMATS = {
    # columns, separator
    "peringlab": (["timestamp", "x", "y", "z", "qw", "qx", "qy", "qz"], ","),
    "tartanair": (["x", "y", "z", "qx", "qy", "qz", "qw"], " "),
}


_POW10 = [float(f"1e{k}") for k in range(309)]
_DIGITS = "0123456789"


def _pandas_float(s: str) -> float:
    """A decimal number as pandas' default C parser reads it
    (``precise_xstrtod``): at most 17 significant digits, leading zeros
    included, accumulated in a double, then one multiplication or division
    by a power of ten. Not correctly rounded."""
    p, n = 0, len(s)
    while p < n and s[p] in " \t\n\r\f\v":
        p += 1
    neg = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and s[p] in _DIGITS:
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < 17 and p < n and s[p] in _DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and s[p] in _DIGITS:
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a number: {s!r}")
    if neg:
        number = -number
    if p < n and s[p] in "eE":
        q = p + 1
        eneg = q < n and s[q] == "-"
        if q < n and s[q] in "+-":
            q += 1
        e, edigits = 0, 0
        while edigits < 10 and q < n and s[q] in _DIGITS:
            e = e * 10 + ord(s[q]) - 48
            edigits += 1
            q += 1
        if edigits:
            exponent += -e if eneg else e
            p = q
    if p < n and s[p:].strip():
        raise ValueError(f"not a number: {s!r}")
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def load_raw_trajectory(path: str, source: str) -> tuple[np.ndarray, np.ndarray]:
    """(R (T, 3, 3), t (T, 3)) camera-frame poses from a raw trajectory file;
    its first row is a header (whatever its names) and its numbers are read
    as pandas' ``read_csv(path, sep=sep, header=0)`` reads them."""
    cols, sep = TRAJECTORY_FORMATS[source]
    with open(path) as f:
        lines = [line.rstrip("\r\n") for line in f.readlines()[1:]]
    rows = [line.split(sep) for line in lines if line.strip()]
    if any(len(r) != len(cols) for r in rows):
        raise ValueError(f"{path}: a row without the {len(cols)} columns of the {source} "
                         f"format")
    ix = {c: i for i, c in enumerate(cols)}

    def columns(names):
        return np.array([[_pandas_float(r[ix[c]]) for c in names] for r in rows],
                        np.float64).reshape(-1, len(names))

    return Rotation.from_quat(columns(["qx", "qy", "qz", "qw"])).as_matrix(), \
        columns(["x", "y", "z"])


def reframe_to_world(R_cam: np.ndarray, t_cam: np.ndarray, R_WC: np.ndarray):
    """T_W0_Wi = (T_W_C0 T_WC^-1)^-1 T_W_Ci T_WC^-1, after a 3-pose identity
    prefix."""
    T = len(t_cam)
    T_WC = np.eye(4)
    T_WC[:3, :3] = R_WC
    T_WC_inv = np.linalg.inv(T_WC)

    def mat(i):
        M = np.eye(4)
        M[:3, :3] = R_cam[i]
        M[:3, 3] = t_cam[i]
        return M

    T_W_W0_inv = np.linalg.inv(mat(0) @ T_WC_inv)
    out_R = [np.eye(3)] * 3
    out_t = [np.zeros(3)] * 3
    for i in range(1, T):
        M = T_W_W0_inv @ (mat(i) @ T_WC_inv)
        out_R.append(M[:3, :3])
        out_t.append(M[:3, 3])
    return np.stack(out_R), np.stack(out_t)


def upsample_poses(R: np.ndarray, t: np.ndarray, ts: np.ndarray, factor: int = 10):
    """Lerp positions and Slerp rotations, ``factor`` samples per step; the
    first sample of each interval is kept once."""
    out_R = [R[0]]
    out_t = [t[0]]
    out_ts = [ts[0]]
    u = np.linspace(0.0, 1.0, factor)
    for i in range(1, len(t)):
        pos = np.outer(1 - u, t[i - 1]) + np.outer(u, t[i])
        slerp = Slerp([0.0, 1.0], Rotation.from_matrix(np.stack([R[i - 1], R[i]])))
        rots = slerp(u).as_matrix()
        tss = (1 - u) * ts[i - 1] + u * ts[i]
        out_R.extend(rots[1:])
        out_t.extend(pos[1:])
        out_ts.extend(tss[1:])
    return np.stack(out_R), np.stack(out_t), np.asarray(out_ts)


def generate_photorealistic(
    source: str,
    sequence_dir: str,
    accelerometer_noise_density: float = 0.01,
    gyroscope_noise_density: float = 0.001,
    accelerometer_random_walk: float = 0.001,
    gyroscope_random_walk: float = 0.0001,
    R_WC: np.ndarray | None = None,
    camera_dt: float = 0.05,
    upsample: int = 10,
    gravity: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    write: bool = True,
):
    """One sequence directory (``trajectory.csv`` and ``cam/``) into
    camera.csv, imu_gt.csv, imu.csv and transforms_gt.csv. Returns the
    generated arrays."""
    rng = rng or np.random.default_rng(42)
    if R_WC is None:
        R_WC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    if gravity is None:
        gravity = np.array([0.0, 0.0, -9.81])

    R_cam, t_cam = load_raw_trajectory(f"{sequence_dir}/trajectory.csv", source)
    R_gt, t_gt = reframe_to_world(R_cam, t_cam, R_WC)
    gt_ts = np.arange(len(t_gt)) * camera_dt  # 3-frame prefix then 20 Hz

    R_up, t_up, ts_up = upsample_poses(R_gt, t_gt, gt_ts, factor=upsample)
    # linspace(0, 1, factor) spans each camera interval with factor - 1
    # steps, so the IMU tick is camera_dt / (factor - 1)
    dt = camera_dt / (upsample - 1)
    gyro_gt, acc_gt = analytic_imu(R_up, t_up, dt, gravity)

    T = len(ts_up)
    acc = acc_gt + accelerometer_noise_density * rng.normal(size=(T, 3))
    gyro = gyro_gt + gyroscope_noise_density * rng.normal(size=(T, 3))
    ba = np.cumsum(accelerometer_random_walk * rng.normal(size=(T, 3)), axis=0)
    bg = np.cumsum(gyroscope_random_walk * rng.normal(size=(T, 3)), axis=0)
    acc = acc + ba
    gyro = gyro + bg
    acc[0] = 0
    gyro[0] = 0

    if write:
        for name, g, a in (("imu_gt.csv", gyro_gt, acc_gt), ("imu.csv", gyro, acc)):
            write_table(f"{sequence_dir}/{name}", {
                "timestamp": ts_up,
                "wx": g[:, 0], "wy": g[:, 1], "wz": g[:, 2],
                "ax": a[:, 0], "ay": a[:, 1], "az": a[:, 2],
            })
        tf = {"timestamp": ts_up}
        for r in range(3):
            for c in range(4):
                tf[f"T{r}{c}"] = R_up[:, r, c] if c < 3 else t_up[:, r]
        write_table(f"{sequence_dir}/transforms_gt.csv", tf)

        cam_dir = f"{sequence_dir}/cam"
        if os.path.isdir(cam_dir):
            paths = sorted(os.listdir(cam_dir))
            # the 3-frame prefix on the first three images, then one frame
            # per image after the first
            ts = [i * camera_dt for i in range(3)]
            files = [paths[min(i, len(paths) - 1)] for i in range(3)]
            for i, p in enumerate(paths):
                if i >= 1:
                    ts.append(i * camera_dt + ts[2])
                    files.append(p)
            write_table(f"{sequence_dir}/camera.csv", {
                "timestamp": ts, "image_path": [f"{cam_dir}/{p}" for p in files],
            })

    return dict(
        timestamps=ts_up, poses_R=R_up, poses_t=t_up,
        imu_gyro_gt=gyro_gt, imu_acc_gt=acc_gt, imu_gyro=gyro, imu_acc=acc,
    )
