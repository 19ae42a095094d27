"""Fixtures that the port's CPU tests and chip_smoke.py share, in numpy and
the port alone (no jax, no JAX package, no pytest).

* ``write_orbit_dataset``: a dataset in the TartanAir or PeringLab format,
  the camera orbit of tests/test_tartanair_e2e.py rendered by the port.
* ``RecordingSink``: a stand-in for the rerun module that keeps every call.
* ``free_port`` and ``run_ranks``: the ranks of a multi-process launch on
  this host, each under a hard timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np


def _orbit_frame(job):
    """Render one frame of the boxes orbit and write it as a PNG (a task of
    write_orbit_dataset's process pool)."""
    from msckf_tpu_torch.data.imageio import write_png
    from msckf_tpu_torch.data.rendered import render_scene_view

    path, R, t, K, width, height, boxes, rgb, filters = job
    img = render_scene_view(R, t, K, width, height, seed=7, boxes=boxes).astype(np.uint8)
    if rgb:
        # a tint, so that the two grey conversions of the readers differ
        img = np.stack([img, (img * 0.93).astype(np.uint8), (img * 0.85).astype(np.uint8)], -1)
    write_png(path, img, filters)


def write_orbit_dataset(root, source="tartanair", sequence="boxesmini", n_cam=45, width=160,
                        height=120, fxy=120.0, rgb=False, filters=0, workers=1) -> str:
    """A dataset in the TartanAir (or PeringLab) format under
    {root}/{source}/{sequence}, as tests/test_tartanair_e2e.py writes one:
    a camera orbiting 24 textured boxes (a smooth angular ramp from rest,
    2.5 m out, 2.3 m up, 35 degrees oblique) rendered by the port's
    renderer, each frame a PNG written by the port's encoder (greyscale, or
    an RGB tint of it with ``rgb``; ``filters`` as ``write_png`` takes
    them) on ``workers`` processes; the trajectory file in the source's
    format (TartanAir: x y z qx qy qz qw, space-separated; PeringLab:
    timestamp,x,y,z,qw,qx,qy,qz), and {root}/{source}/camera_info.csv.
    Returns the sequence directory."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    from scipy.spatial.transform import Rotation

    from msckf_tpu_torch.data.rendered import make_boxes, oblique_extrinsic

    seq_dir = Path(root) / source / sequence
    cam_dir = seq_dir / "cam"
    cam_dir.mkdir(parents=True, exist_ok=True)
    tt = np.arange(n_cam) * 0.05
    omega = 2.0 * np.pi / 16.0
    ramp = np.clip(tt / 1.0, 0.0, 1.0)
    ang = np.cumsum(omega * ramp * 0.05)
    radius, cam_h = 2.5, 2.3
    boxes = make_boxes(np.random.default_rng(7), n_boxes=24)
    K = np.array([[fxy, 0, width / 2.0], [0, fxy, height / 2.0], [0, 0, 1.0]])
    obl = oblique_extrinsic(35.0)
    R_cam = np.empty((n_cam, 3, 3))
    t_cam = np.empty((n_cam, 3))
    for i in range(n_cam):
        cz, sz = np.cos(ang[i]), np.sin(ang[i])
        yaw = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
        R_cam[i] = yaw @ obl
        t_cam[i] = [radius * np.cos(ang[i]), radius * np.sin(ang[i]), cam_h]
    jobs = [(str(cam_dir / f"{i:05d}.png"), R_cam[i], t_cam[i], K, width, height, boxes, rgb,
             filters) for i in range(n_cam)]
    if workers > 1:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            list(pool.map(_orbit_frame, jobs))
    else:
        for job in jobs:
            _orbit_frame(job)
    q = Rotation.from_matrix(R_cam).as_quat()  # x, y, z, w
    if source == "tartanair":
        np.savetxt(seq_dir / "trajectory.csv", np.concatenate([t_cam, q], axis=1),
                   header="x y z qx qy qz qw", comments="")
    else:
        np.savetxt(seq_dir / "trajectory.csv",
                   np.concatenate([tt[:, None], t_cam, q[:, 3:], q[:, :3]], axis=1),
                   delimiter=",", header="timestamp,x,y,z,qw,qx,qy,qz", comments="")
    (Path(root) / source / "camera_info.csv").write_text(
        f"fx,fy,px,py,w,h\n{fxy},{fxy},{width / 2.0},{height / 2.0},{width},{height}\n")
    return str(seq_dir)


class RecordingSink:
    """A stand-in for the rerun module in LiveRerunStream: keeps every
    ``set_time`` and ``log`` call."""

    def __init__(self):
        self.calls = []

    def set_time(self, timeline, sequence):
        self.calls.append(("set_time", timeline, sequence))

    def log(self, path, payload):
        self.calls.append(("log", path, payload))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs, env=None, timeout=180):
    """Start one process a rank with the given argument lists, all at
    once, and return their outputs; any rank that fails or outlives
    ``timeout`` fails the test, with every rank's output."""
    procs = [subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                              env={**os.environ, **(env[i] if env else {})})
             for i, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "a rank failed:\n" + "\n----\n".join(o[-3000:] for o in outs)
    return outs
