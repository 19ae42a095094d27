"""The port's CLI (``msckf_tpu_torch/runner.py``) against the JAX package's.

``main`` over 400 ticks of the synthetic circle in float64 on the CPU
(``--device cpu``), each run a warm-up and a timed run:
* against the JAX runner with the same flags: equal diagnostics; the
  estimated trajectory's metrics (ATE, AOE, RTE) within
  tests/test_parity.py's 1e-7 and the 3-sigma bounds within its rtol 1e-4
  on the variances. ROE is the arccos of a trace near 3 divided by the
  true per-tick rotation, so rounding at 1e-16 in the trace shows there at
  about 1e-6 (4.1e-6 seen): it and its summaries are held to 1e-5;
* ``--stream_chunk 7`` equal to the monolithic run bit for bit;
* ``--batch 2`` over 200 ticks: the final errors within 1e-7 of the JAX
  runner's on one CPU device;
* the same circle written to disk with the port's ``save_sequence_csv`` and
  read through ``--data_root``: the in-memory run's numbers bit for bit, and
  ``--save_results`` writes results.txt;
* ``--log_images`` writes the overlays, matches drawn by ``draw_matches``;
* ``--correction_dtype compensated`` with a float32 filter over 100 ticks:
  the double-word island corrects on real updates, and the metrics and
  diagnostics equal the float64 island's (the float32 filter rounds both
  chains' results to the same state);
* the sources and settings not ported raise ``NotImplementedError`` with
  their ROADMAP.md item.
"""

import dataclasses

import jax
import numpy as np
import pytest

from msckf_tpu import runner as jrunner

from msckf_tpu_torch import runner as trunner
from msckf_tpu_torch.data.parser import save_sequence_csv
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.state import state_to_numpy

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGS = ["--source", "synthetic", "--max_frames", "400", "--dtype", "float64"]


def _arrays(m):
    return {f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}


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
    assert ts.diag == tm.diag
    got = _arrays(ts)
    for name, v in _arrays(tm).items():
        np.testing.assert_array_equal(got[name], v, err_msg=name)
    sa, sb = state_to_numpy(ts.final), state_to_numpy(tm.final)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    n_chunks = -(-tm.stats.frames // 7)
    assert ts.stats.host_syncs == tm.stats.host_syncs + n_chunks


def test_batch_matches_jax(tmp_path, monkeypatch):
    args = ["--source", "synthetic", "--max_frames", "200", "--dtype", "float64",
            "--batch", "2", "--data_root", str(tmp_path)]
    errs = trunner.main(args + ["--device", "cpu"])
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    jerrs = jrunner.main(args)
    assert len(errs) == len(jerrs) == 2
    np.testing.assert_allclose(errs, jerrs, rtol=0, atol=1e-7)
    assert max(errs) < 0.05
    assert errs.final.P.shape[0] == 2 and errs.cfg.f_max == 192


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
    assert any(updates)  # warm-up and timed run: a call per camera step
    assert len(updates) == 2 * mc.stats.camera_steps
    updates.clear()
    m64 = trunner.main(args + ["--correction_dtype", "float64"])
    assert not updates
    assert mc.diag == m64.diag
    got = _arrays(mc)
    for name, v in _arrays(m64).items():
        np.testing.assert_allclose(got[name], v, rtol=0, atol=1e-6, err_msg=name)
    assert np.linalg.norm(mc.ate[-1]) < 0.05


@pytest.mark.parametrize("extra, item", [
    (["--source", "tartanair"], "item 11"),
    (["--source", "peringlab"], "item 11"),
    (["--rerun_live"], "item 11"),
])
def test_unported_settings_raise(extra, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        trunner.main(ARGS + ["--device", "cpu", "--data_root", str(tmp_path)] + extra)
