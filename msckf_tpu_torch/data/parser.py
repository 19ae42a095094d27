"""CSV dataset parser (port of ``msckf_tpu/data/parser.py``).

Reads and writes the reference's on-disk layout: ``transforms_gt.csv``
(timestamp + flattened 3x4 pose), ``imu.csv`` / ``imu_gt.csv``
(timestamp, wx..az), ``camera.csv`` (timestamp, image_path) with optional
timestamp windowing, per-frame synthetic measurement CSVs (timestamp, id,
x, y, score, descriptor_0..9) and ``world_points.csv``.

The JAX package parses with pandas; this module uses the ``csv`` module and
numpy, so it runs where pandas is not installed, and reads the per-frame
keypoint files and ``load_imu_batch``'s IMU files through the native reader
(``data/native_io.py``) where the JAX parser does. A table is a dict of
columns: a float64 array for a numeric column, a list of strings
otherwise. The writer formats every float by its shortest round-trip
``repr`` and every integer as a plain integer, which is what pandas'
``to_csv`` writes, so the files of both packages are the same bytes. The
reader parses floats with correct rounding, so a written array reads back
bit for bit.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from msckf_tpu_torch.data import native_io


def read_table(path: str, sep: str = ",") -> dict:
    """A CSV with a header row as a dict of columns."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    header, body = rows[0], rows[1:]
    cols = {}
    for i, name in enumerate(header):
        vals = [r[i] for r in body]
        try:
            cols[name] = np.array([float(v) for v in vals], dtype=np.float64)
        except ValueError:
            cols[name] = vals
    return cols


def write_table(path: str, cols: dict) -> None:
    """Write a dict of equal-length columns as CSV, in pandas' format."""

    def fmt(v):
        if isinstance(v, (int, np.integer)):
            return str(int(v))
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return str(v)

    names = list(cols)
    columns = [list(cols[n]) for n in names]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for row in zip(*columns):
            w.writerow([fmt(v) for v in row])


def _rows(table: dict, keep: np.ndarray) -> dict:
    """The rows of a table where ``keep``."""
    return {k: (v[keep] if isinstance(v, np.ndarray) else [x for x, y in zip(v, keep) if y])
            for k, v in table.items()}


class Parser:
    def __init__(
        self,
        source: str,
        sequence: str,
        base_path: str = "./data",
        gt: bool = True,
        initial_time_stamp: float = -1,
        final_time_stamp: float = -1,
    ):
        self.root = f"{base_path}/{source}/{sequence}/"
        self.source = source
        self.gt = gt
        self.t0 = initial_time_stamp
        self.t1 = final_time_stamp
        self.transforms_file = self.root + "transforms_gt.csv"
        self.imu_file = self.root + ("imu_gt.csv" if gt else "imu.csv")
        if source == "synthetic":
            self.cam_file = self.root + ("camera_gt.csv" if gt else "camera.csv")
        else:
            self.cam_file = self.root + "camera.csv"

    def _window(self, table: dict) -> dict:
        ts = table["timestamp"]
        keep = np.ones(len(ts), dtype=bool)
        if self.t0 != -1:
            keep &= ts >= self.t0
        if self.t1 != -1:
            keep &= ts <= self.t1
        return _rows(table, keep)

    def extract_gt_trajectory(self) -> dict:
        return self._window(read_table(self.transforms_file))

    def extract_imu(self) -> dict:
        return self._window(read_table(self.imu_file))

    def extract_images(self) -> dict:
        return self._window(read_table(self.cam_file))

    def extract_synthetic_camera_measurements(self, path: str):
        """(keypoints (n, 2), descriptors (n, 10), scores (n,)) of one
        per-frame keypoint CSV (columns timestamp, id, x, y, score,
        descriptor_0..9), read by the native mmap parser where it is built:
        this is the per-frame hot path of dataset loading."""
        a = native_io.read_numeric_csv(path)
        return a[:, 2:4], a[:, 5:15], a[:, 4]

    def extract_gt_world_points(self) -> np.ndarray:
        t = read_table(self.root + "world_points.csv")
        return np.stack([t["x"], t["y"], t["z"]], axis=-1)


def read_camera_info(base_path: str, source: str) -> dict | None:
    """Per-dataset camera intrinsics: ``{base}/{source}/camera_info.csv``
    with columns fx, fy, px, py, w, h. Returns config overrides (K, width,
    height), or None when the file is absent (the caller decides how loud
    to be)."""
    path = f"{base_path}/{source}/camera_info.csv"
    if not os.path.exists(path):
        return None
    row = {k: v[0] for k, v in read_table(path).items()}
    K = (
        (float(row["fx"]), 0.0, float(row["px"])),
        (0.0, float(row["fy"]), float(row["py"])),
        (0.0, 0.0, 1.0),
    )
    return dict(K=K, width=int(row["w"]), height=int(row["h"]))


def gt_trajectory_arrays(table: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(timestamps, R (T, 3, 3), t (T, 3)) from a transforms_gt table."""
    R = np.stack(
        [np.stack([table[f"T{r}{c}"] for c in range(3)], axis=-1) for r in range(3)],
        axis=1,
    )
    t = np.stack([table["T03"], table["T13"], table["T23"]], axis=-1)
    return table["timestamp"], R, t


def imu_arrays(table: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    gyro = np.stack([table["wx"], table["wy"], table["wz"]], axis=-1)
    acc = np.stack([table["ax"], table["ay"], table["az"]], axis=-1)
    return table["timestamp"], gyro, acc


def save_sequence_csv(seq, folder: str) -> None:
    """Write a generated SyntheticSequence in the reference's on-disk layout:
    transforms_gt/imu_gt/imu/camera CSVs plus per-frame keypoint files."""
    os.makedirs(f"{folder}/cam_noisy", exist_ok=True)
    tf = {"timestamp": seq.timestamps}
    for r in range(3):
        for c in range(4):
            tf[f"T{r}{c}"] = seq.poses_R[:, r, c] if c < 3 else seq.poses_t[:, r]
    write_table(f"{folder}/transforms_gt.csv", tf)

    for name, g, a in (
        ("imu_gt.csv", seq.imu_gyro_gt, seq.imu_acc_gt),
        ("imu.csv", seq.imu_gyro, seq.imu_acc),
    ):
        write_table(f"{folder}/{name}", {
            "timestamp": seq.timestamps,
            "wx": g[:, 0], "wy": g[:, 1], "wz": g[:, 2],
            "ax": a[:, 0], "ay": a[:, 1], "az": a[:, 2],
        })

    cam_ts, cam_paths = [], []
    for j, tick in enumerate(seq.cam_frame_ticks):
        path = f"{folder}/cam_noisy/{int(tick):05d}.csv"
        cam_ts.append(seq.timestamps[int(tick)])
        cam_paths.append(path)
        kp, d, s = seq.cam_keypoints[j], seq.cam_descriptors[j], seq.cam_scores[j]
        rows = {
            "timestamp": np.full(len(kp), seq.timestamps[int(tick)]),
            "id": np.arange(len(kp)),
            "x": kp[:, 0],
            "y": kp[:, 1],
            "score": s,
        }
        for i in range(d.shape[1]):
            rows[f"descriptor_{i}"] = d[:, i]
        write_table(path, rows)
    write_table(f"{folder}/camera.csv", {"timestamp": cam_ts, "image_path": cam_paths})

    wp = {
        "id": np.arange(len(seq.world_points)),
        "x": seq.world_points[:, 0],
        "y": seq.world_points[:, 1],
        "z": seq.world_points[:, 2],
    }
    for i in range(seq.world_descriptors.shape[1]):
        wp[f"descriptor_{i}"] = seq.world_descriptors[:, i]
    write_table(f"{folder}/world_points.csv", wp)


def load_imu_batch(paths, threads=None):
    """Read many imu.csv files on the native thread pool
    (``native_io.read_numeric_csvs``; the host feeder of a batched
    multi-sequence run). Returns a list of (ts, gyro, acc) in input order."""
    paths = list(paths)
    headers = []
    for p in paths:
        with open(p, newline="") as f:
            headers.append([c.strip() for c in next(csv.reader(f))])
    out = []
    for hdr, arr in zip(headers, native_io.read_numeric_csvs(paths, threads=threads)):
        out.append(imu_arrays({name: arr[:, i] for i, name in enumerate(hdr)}))
    return out
