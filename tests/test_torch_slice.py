"""The whole sequence loop of the PyTorch port against the JAX package.

``run_sequence`` over the first 600 ticks of the synthetic circle, at
tests/test_parity.py's capacities with the plain line-intersection triage
(``use_pallas_triage=False``), on the CPU in float64: the port (its kernels'
plain versions) against the JAX package's default CPU lane. The discrete
decisions (camera and track counts per tick, rejection and overflow
counters) are exact; the trajectories are held to test_parity.py's
tolerances.
"""

import functools

import jax
import numpy as np
import pytest

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dtype="float64", f_max=512, u_max=64, k_max=512, use_pallas_triage=False)
T = 600
TICK_FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _flatten(prefix_out, frame_out):
    """Prefix and frame-block tick outputs as flat (T, ...) numpy arrays,
    padding ticks dropped."""
    pv = np.asarray(prefix_out.valid)
    fv = np.asarray(frame_out.valid).reshape(-1)
    res = {}
    for name in TICK_FIELDS:
        a = np.asarray(getattr(prefix_out, name))
        b = np.asarray(getattr(frame_out, name))
        res[name] = np.concatenate([a[pv], b.reshape((-1,) + b.shape[2:])[fv]])
    return res


def _stream(build, cfg, seq):
    return build(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                 seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)


@pytest.fixture(scope="module")
def jax_run():
    cfg = jx.reference_experiment_config(**CFG)
    st = _stream(jax_build_stream, cfg, jax_circle(rng=np.random.default_rng(0)))
    std = jax_to_device(st, cfg)
    state = jx.make_initial_state(cfg, std.R_init)
    final, pre, fr = jax.jit(functools.partial(jx.run_sequence, cfg))(state, std.prefix,
                                                                      std.frames)
    return {k: int(getattr(final.diag, k)) for k in COUNTERS}, _flatten(pre, fr)


def _port_run(assume_camera):
    cfg = mt.reference_experiment_config(**CFG)
    st = _stream(build_stream, cfg, generate_circle_sequence(rng=np.random.default_rng(0)))
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, std.R_init, device="cpu")
    stats = mt.FrameStats()
    final, pre, fr = mt.run_sequence(cfg, state, std.prefix, std.frames,
                                     assume_camera=assume_camera, device="cpu", stats=stats)
    return {k: int(getattr(final.diag, k)) for k in COUNTERS}, _flatten(pre, fr), stats


@pytest.fixture(scope="module")
def port_run():
    return _port_run(assume_camera=False)


def test_sequence_matches_jax(jax_run, port_run):
    jc, jo = jax_run
    pc, po, _ = port_run
    assert po["p_WI"].shape[0] == jo["p_WI"].shape[0] == T
    assert pc == jc
    assert jc["n_epipolar_rejected"] > 0 and jc["n_gating_rejected"] > 0
    np.testing.assert_array_equal(po["n_cams"], jo["n_cams"])
    np.testing.assert_array_equal(po["n_tracks"], jo["n_tracks"])
    for name in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(po[name], jo[name], atol=1e-7, err_msg=name)
    for name in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(po[name], jo[name], rtol=1e-4, atol=1e-16, err_msg=name)


def test_assume_camera_drops_a_sync_and_changes_nothing(port_run):
    """Every frame block of the stream carries a camera, so
    ``assume_camera=True`` gives the same trajectory bitwise, with one host
    sync per frame fewer (the prune test stays)."""
    pc, po, stats = port_run
    qc, qo, qstats = _port_run(assume_camera=True)
    assert qc == pc
    for name in TICK_FIELDS:
        np.testing.assert_array_equal(qo[name], po[name], err_msg=name)
    assert qstats.frames == stats.frames > 50
    assert stats.host_syncs - qstats.host_syncs == stats.frames
    assert qstats.host_syncs == qstats.camera_steps + qstats.prunes
