"""The port's CLI (``msckf_tpu_torch/runner.py``) against the JAX package's.

``main`` over 400 ticks of the synthetic circle in float64 on the CPU
(``--device cpu``, where the runner makes no warm-up run):
* against the JAX runner with the same flags: equal diagnostics; the
  estimated trajectory's metrics (ATE, AOE, RTE) within
  tests/test_parity.py's 1e-7 and the 3-sigma bounds within its rtol 1e-4
  on the variances. ROE is the arccos of a trace near 3 divided by the
  true per-tick rotation, so rounding at 1e-16 in the trace shows there at
  about 1e-6 (4.1e-6 seen): it and its summaries are held to 1e-5;
* ``--stream_chunk 7`` equal to the monolithic run bit for bit;
* ``--batch 2`` over 200 ticks: the final errors within 1e-7 of the JAX
  runner's on one CPU device, and bitwise those of two ranks under the
  torchrun environment contract (gloo), which split the batch;
* the same circle written to disk with the port's ``save_sequence_csv`` and
  read through ``--data_root``: the in-memory run's numbers bit for bit, and
  ``--save_results`` writes results.txt;
* ``--log_images`` writes the overlays, matches drawn by ``draw_matches``;
* ``--correction_dtype compensated`` with a float32 filter over 100 ticks:
  the double-word island corrects on real updates, and the metrics and
  diagnostics equal the float64 island's (the float32 filter rounds both
  chains' results to the same state);
* the dataset sources and the live stream, which raised until they were
  ported: ``--source tartanair`` (fused front-end) and ``--source
  peringlab`` (host front-end) on small datasets of their formats, and
  ``--rerun_live`` without rerun-sdk, which prints the JAX runner's messages
  and runs, with and without ``--stream_chunk``.
"""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest

from msckf_tpu import runner as jrunner

from msckf_tpu_torch import runner as trunner
from msckf_tpu_torch.data.parser import save_sequence_csv
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.state import state_to_numpy

from tests.torch_fixtures import free_port, run_ranks, write_orbit_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGS = ["--source", "synthetic", "--max_frames", "400", "--dtype", "float64"]


def _arrays(m):
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


def _same_run(a, b):
    """Two runner results bitwise equal: diagnostics, metrics, final state."""
    assert a.diag == b.diag
    got = _arrays(a)
    for name, v in _arrays(b).items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    sa, sb = state_to_numpy(a.final), state_to_numpy(b.final)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    jm = jrunner.main(ARGS + ["--data_root", root])
    tm = trunner.main(ARGS + ["--data_root", root, "--device", "cpu"])
    return jm, tm


def test_runner_matches_jax(runs):
    jm, tm = runs
    assert tm.diag == jm.diag
    assert jm.diag["n_epipolar_rejected"] > 0 and jm.diag["n_gating_rejected"] > 0
    assert tm.cfg.f_max == jm.cfg.f_max and tm.cfg.k_max == jm.cfg.k_max
    assert tm.cfg.desc_dim == jm.cfg.desc_dim and tm.cfg.u_max == jm.cfg.u_max
    a, b = _arrays(tm), _arrays(jm)
    assert a["ate"].shape == b["ate"].shape == (400, 3)
    for name in ("ate", "aoe", "rte", "rmse_position", "mean_rte", "std_rte"):
        np.testing.assert_allclose(a[name], b[name], rtol=0, atol=1e-7, err_msg=name)
    for name in ("ate_bounds", "aoe_bounds"):
        np.testing.assert_allclose(a[name], b[name], rtol=1e-4, atol=1e-16, err_msg=name)
    for name in ("roe", "rmse_orientation", "mean_roe", "std_roe"):
        np.testing.assert_allclose(a[name], b[name], rtol=0, atol=1e-5, err_msg=name)
    # the loop's counts: one sync per frame for the prune test (assume_camera)
    assert tm.stats.frames > 30
    assert tm.stats.host_syncs == tm.stats.camera_steps + tm.stats.prunes
    assert tm.profiling["device"] == "cpu"


def test_stream_chunk_equals_monolithic(runs, tmp_path):
    _, tm = runs
    ts = trunner.main(ARGS + ["--data_root", str(tmp_path), "--device", "cpu",
                              "--stream_chunk", "7"])
    _same_run(ts, tm)
    n_chunks = -(-tm.stats.frames // 7)
    assert ts.stats.host_syncs == tm.stats.host_syncs + n_chunks


BATCH_ARGS = ["--source", "synthetic", "--max_frames", "200", "--dtype", "float64",
              "--batch", "2"]


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    return trunner.main(BATCH_ARGS + ["--data_root", str(tmp_path_factory.mktemp("batch")),
                                      "--device", "cpu"])


def test_batch_matches_jax(batch_run, tmp_path, monkeypatch):
    errs = batch_run
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jerrs = jrunner.main(BATCH_ARGS + ["--data_root", str(tmp_path)])
    assert len(errs) == len(jerrs) == 2
    np.testing.assert_allclose(errs, jerrs, rtol=0, atol=1e-7)
    assert max(errs) < 0.05
    assert errs.final.P.shape[0] == 2 and errs.cfg.f_max == 192


_RANK = """
import json
from msckf_tpu_torch import runner
errs = runner.main({argv!r})
print("ERRS " + json.dumps(list(errs)), flush=True)
"""


def test_batch_under_torchrun_two_ranks(batch_run, tmp_path):
    """``--batch 2`` under the torchrun environment contract (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK) with two ranks on the
    CPU over gloo: each filters its row, rank 0 reports on 2 devices, and
    every rank's gathered errors are bitwise the one-process run's, which
    test_batch_matches_jax holds to JAX. One PyTorch thread a rank (the
    stall that many threads met is held by test_torch_parallel.py)."""
    port = free_port()
    argv = BATCH_ARGS + ["--data_root", str(tmp_path), "--device", "cpu"]
    env = [{"RANK": str(i), "LOCAL_RANK": str(i), "WORLD_SIZE": "2",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}
           for i in range(2)]
    outs = run_ranks([["-c", _RANK.format(argv=argv)]] * 2, env=env)
    assert "batched VIO: 2 sequences on 2 device(s)" in outs[0]
    assert "batched VIO" not in outs[1]
    for out in outs:
        errs = json.loads(out.split("ERRS ")[-1])
        np.testing.assert_array_equal(errs, list(batch_run))


def test_dataset_on_disk(runs, tmp_path):
    """The runner's in-memory circle (seed 42) written to disk reads back
    through the parser to the same run bit for bit."""
    _, tm = runs
    seq = generate_circle_sequence(rng=np.random.default_rng(42))
    save_sequence_csv(seq, str(tmp_path / "synthetic" / "circle"))
    md = trunner.main(ARGS + ["--data_root", str(tmp_path), "--device", "cpu",
                              "--save_results"])
    assert md.diag == tm.diag
    got = _arrays(md)
    for name, v in _arrays(tm).items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    results = tmp_path / "synthetic" / "circle" / "mid_noise" / "results.txt"
    assert results.read_text().startswith("VIO:\n")
    assert "Consistency" in results.read_text()


def test_log_images(tmp_path):
    """--log_images writes one overlay a frame: from the second frame on,
    beside the previous frame with the matches drawn by draw_matches."""
    m = trunner.main(["--source", "synthetic", "--max_frames", "100", "--device", "cpu",
                      "--data_root", str(tmp_path), "--log_images"])
    out = sorted((tmp_path / "synthetic" / "circle" / "mid_noise" / "debug_images").glob("*.png"))
    assert len(out) == len(trunner.generate_circle_sequence().cam_frame_ticks)
    import cv2

    first, second = cv2.imread(str(out[0])), cv2.imread(str(out[1]))
    assert first.shape == (m.cfg.height, m.cfg.width, 3)
    assert second.shape == (m.cfg.height, 2 * m.cfg.width, 3)


def test_compensated_island_runs(tmp_path, monkeypatch):
    import msckf_tpu_torch.filter.update as up

    updates = []
    island = up._correction_terms_compensated
    monkeypatch.setattr(up, "_correction_terms_compensated",
                        lambda c, P, A, cc: (updates.append(bool((A != 0).any())),
                                             island(c, P, A, cc))[1])
    args = ["--source", "synthetic", "--max_frames", "100", "--dtype", "float32",
            "--device", "cpu", "--data_root", str(tmp_path)]
    mc = trunner.main(args + ["--correction_dtype", "compensated"])
    assert mc.cfg.correction_dtype == "compensated" and mc.cfg.err_dim == 207
    assert any(updates)  # one run on the CPU: a call per camera step
    assert len(updates) == mc.stats.camera_steps
    updates.clear()
    m64 = trunner.main(args + ["--correction_dtype", "float64"])
    assert not updates
    assert mc.diag == m64.diag
    got = _arrays(mc)
    for name, v in _arrays(m64).items():
        np.testing.assert_allclose(got[name], v, rtol=0, atol=1e-6, err_msg=name)
    assert np.linalg.norm(mc.ate[-1]) < 0.05


@pytest.mark.parametrize("case", ["tartanair", "peringlab", "rerun_live"])
def test_sources_and_rerun_live_run(case, tmp_path, capsys):
    """12 frames of the boxes orbit at 96 x 64 in the TartanAir and the
    PeringLab format: the runner writes the dataset's IMU and ground truth,
    takes camera_info.csv's camera (and warns without it) and ends with a
    finite trajectory; with --log_images it draws on the frames' rasters. Without rerun-sdk,
    --rerun_live prints the JAX runner's message and runs."""
    root = str(tmp_path)
    if case == "rerun_live":
        args = ["--source", "synthetic", "--max_frames", "100", "--device", "cpu",
                "--data_root", root, "--rerun_live"]
        m = trunner.main(args)
        assert "--rerun_live requires --stream_chunk (live = per fetched chunk); ignoring" \
            in capsys.readouterr().out
        ms = trunner.main(args + ["--stream_chunk", "4"])
        assert "rerun-sdk not installed; --rerun_live ignored" in capsys.readouterr().out
        _same_run(ms, m)
        return
    write_orbit_dataset(root, case, "orbit", n_cam=12, width=96, height=64, fxy=72.0)
    # the PeringLab run draws its overlays on the rasters (--log_images
    # takes the host front-end)
    extra = ["--frontend", "fused"] if case == "tartanair" else ["--log_images"]
    m = trunner.main(["--source", case, "--sequence", "orbit", "--max_frames", "1000",
                      "--noise_level", "low", "--device", "cpu", "--data_root", root] + extra)
    assert np.isfinite(m.ate).all() and np.isfinite(m.aoe).all()
    assert (m.cfg.width, m.cfg.height, m.cfg.K[0][0]) == (96, 64, 72.0)
    assert m.blocks[0] == 12  # frame blocks after the IMU prefix
    for f in ("imu.csv", "imu_gt.csv", "transforms_gt.csv", "camera.csv"):
        assert (tmp_path / case / "orbit" / f).is_file()
    if case == "tartanair":
        # without camera_info.csv the runner warns as the JAX runner does
        (tmp_path / case / "camera_info.csv").unlink()
        capsys.readouterr()
        trunner._dataset_config(argparse.Namespace(data_root=root, source=case), m.cfg,
                                [np.zeros((3, 2))], [np.zeros((3, 64))])
        assert "camera_info.csv not found; using default intrinsics" in capsys.readouterr().out
    if case == "peringlab":
        import cv2

        drawn = sorted((tmp_path / case / "orbit" / "low_noise" / "debug_images").iterdir())
        assert len(drawn) == 14  # one a camera.csv row: the 3-frame prefix, then 11
        first = cv2.imread(str(drawn[0]))
        # the frame's raster under the keypoints, not the blank canvas
        assert first.shape == (64, 96, 3) and len(np.unique(first)) > 50
