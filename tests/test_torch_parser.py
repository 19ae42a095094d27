"""The port's CSV dataset parser and writer against the JAX package's.

A circle written by the JAX ``save_sequence_csv`` is read by both parsers:
IMU, ground truth, camera timestamps and paths, per-frame measurements,
world points and ``read_camera_info``. The port reads every float back bit
for bit. pandas' default float parser (the JAX package's) is not correctly
rounded (it lands up to a few thousand ulps off on values near zero), so the
two parsers are held to each other by the JAX package's own round-trip
tolerance (``tests/test_metrics_runner.py::test_csv_roundtrip``, atol
1e-12; the per-frame files, which its native reader reads, exactly). The
port's writer produces the same bytes as the JAX writer, so the JAX parser reads
the port's files exactly as it reads its own.
"""

import filecmp

import numpy as np
import pandas as pd
import pytest

from msckf_tpu.data import parser as jpar

from msckf_tpu_torch.data import parser as tpar
from msckf_tpu_torch.data.synthetic import generate_circle_sequence

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same circle written by each package's writer (the port's under
    a second root), and the camera_info.csv of the JAX root."""
    seq = generate_circle_sequence(rng=np.random.default_rng(3), n_world_points=60)
    roots = {}
    for name, save in (("jax", jpar.save_sequence_csv), ("port", tpar.save_sequence_csv)):
        root = tmp_path_factory.mktemp(name)
        save(seq, str(root / "synthetic" / "circle"))
        roots[name] = root
    pd.DataFrame([dict(fx=181.5, fy=179.25, px=321.0, py=239.5, w=640, h=480)]).to_csv(
        roots["jax"] / "synthetic" / "camera_info.csv", index=False)
    return seq, roots


def _read(mod, root, **kw):
    """Everything a parser reads from one dataset, as numpy arrays."""
    p = mod.Parser("synthetic", "circle", base_path=str(root), gt=False, **kw)
    ts, gyro, acc = mod.imu_arrays(p.extract_imu())
    gts, R, t = mod.gt_trajectory_arrays(p.extract_gt_trajectory())
    cams = p.extract_images()
    cam_ts = np.asarray(cams["timestamp"], dtype=float)
    paths = list(cams["image_path"])
    frames = [p.extract_synthetic_camera_measurements(path) for path in paths]
    return dict(
        imu_ts=ts, gyro=gyro, acc=acc, gt_ts=gts, gt_R=R, gt_t=t, cam_ts=cam_ts,
        kp=np.concatenate([f[0] for f in frames]), desc=np.concatenate([f[1] for f in frames]),
        score=np.concatenate([f[2] for f in frames]), n_kp=[len(f[0]) for f in frames],
        world=p.extract_gt_world_points(),
    ), paths


def test_jax_written_dataset_reads_equal(written):
    seq, roots = written
    port, port_paths = _read(tpar, roots["jax"])
    jax_, jax_paths = _read(jpar, roots["jax"])
    assert port_paths == jax_paths and len(port_paths) == len(seq.cam_frame_ticks)
    assert port["n_kp"] == jax_["n_kp"] == [len(k) for k in seq.cam_keypoints]
    # the port reads back exactly what was written
    for name, want in (("imu_ts", seq.timestamps), ("gyro", seq.imu_gyro),
                       ("acc", seq.imu_acc), ("gt_R", seq.poses_R), ("gt_t", seq.poses_t),
                       ("cam_ts", seq.timestamps[seq.cam_frame_ticks]),
                       ("kp", np.concatenate(seq.cam_keypoints)),
                       ("desc", np.concatenate(seq.cam_descriptors)),
                       ("score", np.concatenate(seq.cam_scores)),
                       ("world", seq.world_points)):
        np.testing.assert_array_equal(port[name], want, err_msg=name)
    for name in port:
        if name in ("kp", "desc", "score"):
            np.testing.assert_array_equal(port[name], jax_[name], err_msg=name)
        elif name != "n_kp":
            np.testing.assert_allclose(port[name], jax_[name], rtol=0, atol=1e-12, err_msg=name)
    assert tpar.read_camera_info(str(roots["jax"]), "synthetic") == \
        jpar.read_camera_info(str(roots["jax"]), "synthetic")
    assert tpar.read_camera_info(str(roots["jax"]), "rendered") is None


def test_port_writer_matches_jax_writer(written):
    """Every file the port writes has the JAX writer's bytes (camera.csv up
    to the dataset's own root in the image paths), so the JAX parser reads
    the port's dataset to the arrays it reads from its own."""
    _, roots = written
    a, b = roots["jax"] / "synthetic" / "circle", roots["port"] / "synthetic" / "circle"
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*.csv"))
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*.csv"))
    assert len(names) > 200
    same = [n for n in names if n != "camera.csv" and filecmp.cmp(a / n, b / n, shallow=False)]
    assert len(same) == len(names) - 1
    assert (b / "camera.csv").read_text().replace(str(roots["port"]), str(roots["jax"])) == \
        (a / "camera.csv").read_text()
    port_by_jax, _ = _read(jpar, roots["port"])
    jax_by_jax, _ = _read(jpar, roots["jax"])
    for name in jax_by_jax:
        np.testing.assert_array_equal(port_by_jax[name], jax_by_jax[name], err_msg=name)


def test_window_and_imu_batch(written):
    """Timestamp windowing keeps the same rows in both parsers, and
    load_imu_batch reads each imu.csv as the parser does."""
    _, roots = written
    port, _ = _read(tpar, roots["jax"], initial_time_stamp=1.0, final_time_stamp=4.0)
    jax_, _ = _read(jpar, roots["jax"], initial_time_stamp=1.0, final_time_stamp=4.0)
    for name in ("imu_ts", "gt_ts", "cam_ts"):
        assert 0 < len(port[name]) == len(jax_[name])
        np.testing.assert_allclose(port[name], jax_[name], rtol=0, atol=1e-12, err_msg=name)
    assert port["imu_ts"].min() >= 1.0 and port["imu_ts"].max() <= 4.0
    paths = [str(r / "synthetic" / "circle" / "imu.csv") for r in (roots["jax"], roots["port"])]
    whole, _ = _read(tpar, roots["jax"])
    for ts, gyro, acc in tpar.load_imu_batch(paths, threads=2):
        np.testing.assert_array_equal(ts, whole["imu_ts"])
        np.testing.assert_array_equal(gyro, whole["gyro"])
        np.testing.assert_array_equal(acc, whole["acc"])


def test_empty_frame_file(tmp_path):
    """A frame with no keypoints is a header-only file in both writers and
    reads as empty (0, 2), (0, 10), (0,) arrays."""
    path = tmp_path / "frame.csv"
    cols = ["timestamp", "id", "x", "y", "score"] + [f"descriptor_{i}" for i in range(10)]
    tpar.write_table(str(path), {c: np.zeros(0) for c in cols})
    assert path.read_text() == pd.DataFrame({c: np.zeros(0) for c in cols}).to_csv(index=False)
    p = tpar.Parser("synthetic", "circle", base_path=str(tmp_path))
    kp, desc, score = p.extract_synthetic_camera_measurements(str(path))
    assert kp.shape == (0, 2) and desc.shape == (0, 10) and score.shape == (0,)
