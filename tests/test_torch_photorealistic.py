"""The TartanAir and PeringLab sources (``msckf_tpu_torch/data/
photorealistic.py`` and the runner's ``--source tartanair|peringlab``)
against the JAX package's.

* Both trajectory formats read as the JAX module reads them with pandas,
  bit for bit: pandas' default float converter is not correctly rounded,
  and the port reads the raw trajectory with the same arithmetic
  (``_pandas_float``, held to pandas on 20,000 numbers in four formats). ``reframe_to_world``,
  ``upsample_poses`` and ``generate_photorealistic`` (same rng) give the JAX
  module's bits, and the four CSV files are the same bytes.
* The boxes scene renders bit for bit as the JAX package renders it.
* The runner's ``_load_sequence`` on tests/test_tartanair_e2e.py's fixture
  (the boxes orbit, 45 frames of 160 x 120, rendered by the port's renderer
  and written as greyscale PNGs by the port's encoder), against the JAX
  runner's: with ``--frontend fused`` the rasters (OpenCV's
  IMREAD_GRAYSCALE there) and the camera ticks bit for bit, the dataset
  files the same bytes; the IMU and the ground truth read correctly rounded
  (the values written). The JAX runner's pandas read keeps 17 digits,
  leading zeros included, so it stays within 4e-16 max(|x|, 1) of them.
  The host path's raster read (``load_image_grayscale``) is the JAX
  front-end's, bit for bit, on the greyscale frames and on RGB copies.
* One CPU run of the port's runner on that fixture with the JAX test's
  arguments: a finite ATE, a final ATE under 0.5 m, the files on disk.
"""

import argparse
import io
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from msckf_tpu import runner as jrunner
from msckf_tpu.data import photorealistic as jpr
from msckf_tpu.data import rendered as jrend
from msckf_tpu.models import frontend as jfe

from msckf_tpu_torch import runner as trunner
from msckf_tpu_torch.data import imageio
from msckf_tpu_torch.data import photorealistic as tpr
from msckf_tpu_torch.data import rendered as trend
from msckf_tpu_torch.models import frontend as tfe

from tests.torch_fixtures import write_orbit_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FILES = ("imu.csv", "imu_gt.csv", "transforms_gt.csv", "camera.csv")
# tests/test_tartanair_e2e.py's arguments
E2E_ARGS = ["--source", "tartanair", "--sequence", "boxesmini", "--noise_level", "low",
            "--max_frames", "1000", "--refine_subpix"]


def _bits(a, b, what=""):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


def _trajectory(rng, n):
    """A smooth camera path: positions on a loop, unit quaternions (x, y,
    z, w) of a slow rotation with noise."""
    s = np.linspace(0.0, 2.0, n)
    t = np.stack([2.0 * np.cos(s), 2.0 * np.sin(s), 1.5 + 0.1 * s], -1) + 0.01 * rng.normal(
        size=(n, 3))
    q = np.stack([0.1 * np.sin(s), 0.2 * s, 0.05 * rng.normal(size=n), np.ones(n)], -1)
    return t, q / np.linalg.norm(q, axis=1, keepdims=True)


def _write_raw(seq_dir: Path, source: str, t, q):
    seq_dir.mkdir(parents=True, exist_ok=True)
    if source == "tartanair":
        np.savetxt(seq_dir / "trajectory.csv", np.concatenate([t, q], 1),
                   header="x y z qx qy qz qw", comments="")
    else:
        ts = np.arange(len(t)) * 0.05
        np.savetxt(seq_dir / "trajectory.csv",
                   np.concatenate([ts[:, None], t, q[:, 3:], q[:, :3]], 1), delimiter=",",
                   header="timestamp,x,y,z,qw,qx,qy,qz", comments="")


def test_pandas_float_is_pandas():
    """pandas' read_csv bit for bit on 5,000 numbers in each of four
    formats: numpy's 19-digit text, shortest repr, fixed point and %g
    (magnitudes 1e-30 to 1e30)."""
    rng = np.random.default_rng(2)
    vals = rng.normal(size=5000) * 10.0 ** rng.integers(-30, 30, 5000)
    vals[:1000] = rng.normal(size=1000)
    for fmt in ("%.18e", "repr", "%.6f", "%.12g"):
        text = [repr(float(v)) if fmt == "repr" else fmt % v for v in vals]
        want = pd.read_csv(io.StringIO("x\n" + "\n".join(text) + "\n")).to_numpy(float)[:, 0]
        got = np.array([tpr._pandas_float(t) for t in text])
        _bits(got, want, fmt)
    assert (want != np.array([float(t) for t in text])).any()  # not correctly rounded


def test_boxes_render_is_the_jax_packages():
    """Views of the orbit, and close-ups low among the boxes, where some
    boxes have corners behind the camera (the port traces each box only
    over its projection's window when all its corners are in front)."""
    boxes = trend.make_boxes(np.random.default_rng(7), n_boxes=24)
    np.testing.assert_array_equal(boxes, jrend.make_boxes(np.random.default_rng(7), n_boxes=24))
    K = np.array([[120.0, 0.0, 80.0], [0.0, 120.0, 60.0], [0.0, 0.0, 1.0]])
    for a, r, h, pitch in ((0.0, 2.5, 2.3, 35.0), (0.7, 2.5, 2.3, 35.0), (2.0, 2.5, 2.3, 35.0),
                           (1.1, 0.9, 0.4, 75.0), (4.0, 1.6, 0.6, 60.0)):
        R = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                      [0.0, 0.0, 1.0]]) @ trend.oblique_extrinsic(pitch)
        t = np.array([r * np.cos(a), r * np.sin(a), h])
        _bits(trend.render_scene_view(R, t, K, 160, 120, seed=7, boxes=boxes),
              jrend.render_scene_view(R, t, K, 160, 120, seed=7, boxes=boxes), str(a))


@pytest.mark.parametrize("source", ["tartanair", "peringlab"])
def test_generator_is_the_jax_modules(source, tmp_path):
    rng = np.random.default_rng(11)
    t, q = _trajectory(rng, 23)
    roots = {}
    for pkg in ("jax", "port"):
        seq = tmp_path / pkg / source / "seq"
        _write_raw(seq, source, t, q)
        (seq / "cam").mkdir()
        for i in range(23):
            (seq / "cam" / f"{i:05d}.png").write_bytes(b"")
        roots[pkg] = seq
    path = str(roots["port"] / "trajectory.csv")
    R, tt = tpr.load_raw_trajectory(path, source)
    jR, jt = jpr.load_raw_trajectory(path, source)
    _bits(R, jR, "R")
    _bits(tt, jt, "t")
    # the positions as written, read correctly rounded, are not all pandas'
    assert (tt != t).any() and np.abs(tt - t).max() <= 4.5e-16
    R_WC = np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    for a, b in zip(tpr.reframe_to_world(R, tt, R_WC), jpr.reframe_to_world(R, tt, R_WC)):
        _bits(a, b, "reframe_to_world")
    ts = np.arange(len(tt) + 2) * 0.05
    Rw, tw = tpr.reframe_to_world(R, tt, R_WC)
    for a, b in zip(tpr.upsample_poses(Rw, tw, ts), jpr.upsample_poses(Rw, tw, ts)):
        _bits(a, b, "upsample_poses")

    kw = dict(accelerometer_noise_density=0.001, gyroscope_noise_density=0.0001,
              accelerometer_random_walk=0.0001, gyroscope_random_walk=0.00001)
    got = tpr.generate_photorealistic(source, str(roots["port"]),
                                      rng=np.random.default_rng(5), **kw)
    want = jpr.generate_photorealistic(source, str(roots["jax"]),
                                       rng=np.random.default_rng(5), **kw)
    assert got.keys() == want.keys()
    for k in want:
        _bits(got[k], want[k], k)
    for name in FILES:
        a = (roots["port"] / name).read_text()
        b = (roots["jax"] / name).read_text()
        assert a.replace(str(roots["port"]), str(roots["jax"])) == b, name


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """tests/test_tartanair_e2e.py's dataset, written once per package."""
    root = tmp_path_factory.mktemp("orbit")
    write_orbit_dataset(str(root / "port"))
    shutil.copytree(root / "port", root / "jax")
    return root


def _args(root, frontend):
    ns = argparse.Namespace(source="tartanair", sequence="boxesmini", data_root=str(root),
                            noise_level="low", frontend=frontend, gen_noise="default",
                            max_frames=1000, refine_subpix=True, xfeat_weights="")
    return ns


def test_load_sequence_is_the_jax_runners(orbit):
    """The fused front-end's inputs: rasters, camera ticks and image paths
    bit for bit, the dataset files the same bytes; IMU and ground truth the
    values written (correctly rounded), and the JAX runner's pandas read
    within 4e-16 max(|x|, 1) of them."""
    got = trunner._load_sequence(_args(orbit / "port", "fused"), "cpu")
    want = jrunner._load_sequence(_args(orbit / "jax", "fused"))
    (imu_ts, gyro, acc, cam_ticks, kps, _, _, gt_R, gt_t, paths, overrides, images) = got
    (jimu_ts, jgyro, jacc, jcam_ticks, jkps, _, _, jgt_R, jgt_t, jpaths, joverrides,
     jimages) = want
    assert kps is None and jkps is None and overrides == joverrides == {}
    _bits(images, jimages, "images")
    assert images.shape == (47, 120, 160)  # the 3-frame prefix, then 44 frames
    _bits(np.asarray(cam_ticks, np.int64), np.asarray(jcam_ticks, np.int64), "cam_ticks")
    assert [p.replace(str(orbit / "port"), "") for p in paths] == \
        [p.replace(str(orbit / "jax"), "") for p in jpaths]
    seq = Path("tartanair") / "boxesmini"
    for name in FILES:
        a = (orbit / "port" / seq / name).read_text()
        assert a.replace(str(orbit / "port"), str(orbit / "jax")) == \
            (orbit / "jax" / seq / name).read_text(), name
    imu = np.loadtxt(orbit / "port" / seq / "imu.csv", delimiter=",", skiprows=1)
    gt = np.loadtxt(orbit / "port" / seq / "transforms_gt.csv", delimiter=",", skiprows=1)
    _bits(imu_ts, imu[:, 0], "imu_ts")
    _bits(gyro, imu[:, 1:4], "gyro")
    _bits(acc, imu[:, 4:7], "acc")
    _bits(gt_t, gt[:, [4, 8, 12]], "gt_t")
    _bits(gt_R, gt[:, [1, 2, 3, 5, 6, 7, 9, 10, 11]].reshape(-1, 3, 3), "gt_R")
    off = 0
    for a, b in ((imu_ts, jimu_ts), (gyro, jgyro), (acc, jacc), (gt_R, jgt_R), (gt_t, jgt_t)):
        b = np.asarray(b, np.float64)
        assert np.all(np.abs(a - b) <= 4e-16 * np.maximum(np.abs(a), 1.0))
        off += int((a != b).sum())
    assert off > 0  # pandas' read is not correctly rounded


def test_host_path_raster_read_is_the_jax_frontends(orbit, tmp_path):
    frames = sorted((orbit / "port" / "tartanair" / "boxesmini" / "cam").iterdir())[:6]
    for p in frames:
        _bits(tfe.load_image_grayscale(str(p)), jfe.load_image_grayscale(str(p)), p.name)
        grey = imageio.imread_unchanged(str(p))
        tinted = np.stack([grey, (grey * 0.93).astype(np.uint8),
                           (grey * 0.85).astype(np.uint8)], -1)
        rgb = str(tmp_path / p.name)
        imageio.write_png(rgb, tinted, (0, 1, 2, 3, 4))
        _bits(tfe.load_image_grayscale(rgb), jfe.load_image_grayscale(rgb), rgb)
        assert (imageio.imread_grayscale(rgb) != imageio.imread_color_gray(rgb)).any()


def test_port_runner_on_the_fixture(orbit):
    root = orbit / "port"
    m = trunner.main(E2E_ARGS + ["--data_root", str(root), "--device", "cpu"])
    assert np.all(np.isfinite(m.ate))
    final_ate = float(np.linalg.norm(m.ate[-1]))
    assert final_ate < 0.5, f"tartanair-format VIO diverged: {final_ate} m"
    assert m.cfg.width == 160 and m.cfg.K[0][0] == 120.0
    for f in FILES:
        assert (root / "tartanair" / "boxesmini" / f).is_file()
