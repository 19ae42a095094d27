"""Visualization and live telemetry, gated on optional packages (port of
``msckf_tpu/utils/viz.py``).

* Rerun: ``stream_to_rerun`` replays a finished run into the viewer or an
  ``.rrd`` recording; ``LiveRerunStream`` logs each tick of a chunk-streamed
  run (``filter/streamed.py``'s ``on_prefix`` / ``on_chunk`` hand it the
  numpy ``TickOutput`` of each fetched piece) while the next chunk runs.
* Canvases: a matplotlib 2D camera-image canvas with keypoints and
  covariance ellipses, and a 3D scatter canvas.

Neither rerun nor matplotlib is imported with the module: ``HAVE_RERUN``
says whether rerun is installed, and each function imports what it draws
with.
"""

from __future__ import annotations

import importlib
import importlib.util

import numpy as np

HAVE_RERUN = importlib.util.find_spec("rerun") is not None


def _rr():
    if not HAVE_RERUN:
        raise ImportError("rerun-sdk is not installed; install extras [viz]")
    return importlib.import_module("rerun")


def stream_to_rerun(
    gt_t: np.ndarray,  # (T, 3)
    est_R: np.ndarray,  # (T, 3, 3)
    est_t: np.ndarray,  # (T, 3)
    metrics,  # TrajectoryMetrics
    n_tracks: np.ndarray | None = None,
    n_cams: np.ndarray | None = None,
    app_id: str = "vio",
    save_path: str | None = None,
    spawn: bool = False,
):
    """Replay a finished run into the Rerun viewer or an .rrd recording,
    one frame of the timeline a tick."""
    rr = _rr()
    rr.init(app_id, spawn=spawn)
    if save_path:
        rr.save(save_path)
    for i in range(len(est_t)):
        rr.set_time(timeline="frame", sequence=i)
        rr.log("world/gt_trajectory", rr.Points3D(gt_t[: i + 1], radii=0.01))
        rr.log("world/estimated_trajectory", rr.Points3D(est_t[: i + 1], radii=0.01))
        rr.log(
            "world/camera_vio",
            rr.Transform3D(translation=est_t[i], mat3x3=est_R[i], axis_length=0.2),
        )
        rr.log(
            "world/imu_position_covariance",
            rr.Ellipsoids3D(centers=[gt_t[i]], half_sizes=[metrics.ate_bounds[i]]),
        )
        rr.log("relative_translation_error/t", rr.Scalars(metrics.rte[i]))
        rr.log("relative_orientation_error/r", rr.Scalars(metrics.roe[i]))
        for axis, name in enumerate("xyz"):
            rr.log(f"absolute_translation_error/{name}", rr.Scalars(metrics.ate[i, axis]))
            rr.log(f"absolute_translation_error/{name}ub", rr.Scalars(metrics.ate_bounds[i, axis]))
            rr.log(f"absolute_translation_error/{name}lb", rr.Scalars(-metrics.ate_bounds[i, axis]))
        for axis, name in enumerate(("roll", "pitch", "yaw")):
            rr.log(f"absolute_orientation_error/{name}", rr.Scalars(metrics.aoe[i, axis]))
        if n_tracks is not None:
            rr.log("msckf/features", rr.Scalars(int(n_tracks[i])))
        if n_cams is not None:
            rr.log("msckf/camera_states", rr.Scalars(int(n_cams[i])))


class LiveRerunStream:
    """Per-tick telemetry during a chunk-streamed run: wire ``consume`` to
    ``run_sequence_streamed(on_prefix=..., on_chunk=...)`` and every tick is
    logged while the next chunk still computes, with 3-sigma bounds from the
    filter's own covariance outputs.

    ``sink``: the rerun module by default; any object with compatible
    ``set_time`` and ``log`` methods (a recorder in the tests).
    """

    def __init__(self, gt_R, gt_t, app_id: str = "vio",
                 save_path: str | None = None, spawn: bool = False, sink=None):
        if sink is None:
            sink = _rr()
            sink.init(app_id, spawn=spawn)
            if save_path:
                sink.save(save_path)
        self.sink = sink
        self.gt_t = np.asarray(gt_t)
        self.gt_R = np.asarray(gt_R)
        self.tick = 0
        self._est_t: list = []

    def consume(self, tick_out) -> None:
        """Log one fetched TickOutput (the prefix block or a frame chunk),
        shaped (chunk, B, ...) or (T, ...); padding ticks are skipped."""
        s = self.sink
        valid = np.asarray(tick_out.valid)
        v = valid.reshape(-1)

        def flat(a):
            a = np.asarray(a)
            return a.reshape((-1,) + a.shape[valid.ndim:])[v]

        est_R, est_t = flat(tick_out.R_WI), flat(tick_out.p_WI)
        sig_pos, sig_rot = flat(tick_out.sigma_pos), flat(tick_out.sigma_rot)
        n_tracks, n_cams = flat(tick_out.n_tracks), flat(tick_out.n_cams)

        for j in range(len(est_t)):
            i = self.tick
            if i >= len(self.gt_t):
                return
            self._est_t.append(est_t[j])
            s.set_time(timeline="frame", sequence=i)
            s.log("world/gt_trajectory", _points3d(self.gt_t[: i + 1]))
            s.log("world/estimated_trajectory", _points3d(np.asarray(self._est_t)))
            s.log("world/camera_vio", _transform3d(translation=est_t[j], mat3x3=est_R[j]))
            s.log(
                "world/imu_position_covariance",
                _ellipsoids3d(centers=[est_t[j]], half_sizes=[3.0 * sig_pos[j]]),
            )
            ate = est_t[j] - self.gt_t[i]
            aoe = _rot_angles(self.gt_R[i].T @ est_R[j])
            for axis, name in enumerate("xyz"):
                s.log(f"absolute_translation_error/{name}", _scalars(ate[axis]))
                s.log(f"absolute_translation_error/{name}ub", _scalars(3.0 * sig_pos[j, axis]))
                s.log(f"absolute_translation_error/{name}lb", _scalars(-3.0 * sig_pos[j, axis]))
            for axis, name in enumerate(("roll", "pitch", "yaw")):
                s.log(f"absolute_orientation_error/{name}", _scalars(aoe[axis]))
                s.log(f"absolute_orientation_error/{name}ub", _scalars(3.0 * sig_rot[j, axis]))
            s.log("msckf/features", _scalars(int(n_tracks[j])))
            s.log("msckf/camera_states", _scalars(int(n_cams[j])))
            self.tick += 1


def _rot_angles(R_err: np.ndarray) -> np.ndarray:
    """xyz Euler angles (roll, pitch, yaw) of a small error rotation."""
    sy = float(np.hypot(R_err[0, 0], R_err[1, 0]))
    if sy > 1e-6:
        return np.array([
            np.arctan2(R_err[2, 1], R_err[2, 2]),
            np.arctan2(-R_err[2, 0], sy),
            np.arctan2(R_err[1, 0], R_err[0, 0]),
        ])
    return np.array([
        np.arctan2(-R_err[1, 2], R_err[1, 1]),
        np.arctan2(-R_err[2, 0], sy),
        0.0,
    ])


# the payloads: rerun's archetypes, or (name, data) tuples without rerun


def _points3d(pts):
    return _rr().Points3D(pts, radii=0.01) if HAVE_RERUN else ("Points3D", np.asarray(pts))


def _transform3d(translation, mat3x3):
    if HAVE_RERUN:
        return _rr().Transform3D(translation=translation, mat3x3=mat3x3, axis_length=0.2)
    return ("Transform3D", np.asarray(translation))


def _ellipsoids3d(centers, half_sizes):
    if HAVE_RERUN:
        return _rr().Ellipsoids3D(centers=centers, half_sizes=half_sizes)
    return ("Ellipsoids3D", np.asarray(centers))


def _scalars(x):
    return _rr().Scalars(x) if HAVE_RERUN else ("Scalars", float(x))


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class CameraImageCanvas:
    """2D image-plane canvas with keypoints and covariance ellipses."""

    def __init__(self, width: int = 640, height: int = 480):
        self.plt = _pyplot()
        self.fig, self.ax = self.plt.subplots(figsize=(8, 6))
        self.ax.set_xlim(0, width)
        self.ax.set_ylim(height, 0)
        self.ax.set_aspect("equal")

    def add_points(self, pts: np.ndarray, color="red", size=8, labels=None):
        self.ax.scatter(pts[:, 0], pts[:, 1], c=color, s=size)
        if labels is not None:
            for p, label in zip(pts, labels):
                self.ax.annotate(str(label), p)

    def add_covariance_ellipse(self, mean: np.ndarray, cov: np.ndarray, n_std=3.0, color="blue"):
        from matplotlib.patches import Ellipse

        w, V = np.linalg.eigh(cov)
        angle = np.degrees(np.arctan2(V[1, 1], V[0, 1]))
        self.ax.add_patch(
            Ellipse(mean, 2 * n_std * np.sqrt(w[1]), 2 * n_std * np.sqrt(w[0]),
                    angle=angle, fill=False, color=color)
        )

    def save(self, path: str):
        self.fig.savefig(path, dpi=120)
        self.plt.close(self.fig)


class Canvas3D:
    """3D scatter canvas for world points, trajectories and camera frusta
    (matplotlib)."""

    def __init__(self, x_range=None, y_range=None, z_range=None):
        self.plt = _pyplot()
        self.fig = self.plt.figure(figsize=(9, 9))
        self.ax = self.fig.add_subplot(projection="3d")
        if x_range:
            self.ax.set_xlim(x_range)
        if y_range:
            self.ax.set_ylim(y_range)
        if z_range:
            self.ax.set_zlim(z_range)

    def add_points(self, pts: np.ndarray, color="blue", size=2):
        self.ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=size)

    def add_pose(self, R: np.ndarray, t: np.ndarray, axis_length: float = 0.3):
        for axis, c in zip(range(3), ("r", "g", "b")):
            d = R[:, axis] * axis_length
            self.ax.plot([t[0], t[0] + d[0]], [t[1], t[1] + d[1]], [t[2], t[2] + d[2]], c)

    def add_camera_frustum(self, R: np.ndarray, t: np.ndarray, K: np.ndarray,
                           width: int, height: int, depth: float = 0.5, color="k"):
        Kinv = np.linalg.inv(K)
        corners_px = np.array([[0, 0, 1], [width, 0, 1], [width, height, 1], [0, height, 1]], float)
        corners_w = ((corners_px @ Kinv.T) * depth) @ R.T + t
        for c in corners_w:
            self.ax.plot([t[0], c[0]], [t[1], c[1]], [t[2], c[2]], color, linewidth=0.7)
        loop = np.vstack([corners_w, corners_w[:1]])
        self.ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], color, linewidth=0.7)

    def save(self, path: str):
        self.fig.savefig(path, dpi=120)
        self.plt.close(self.fig)
