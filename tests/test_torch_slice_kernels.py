"""The whole sequence loop of the PyTorch port against the JAX package, in
the two configurations that run the triage and fused update-terms kernels.

``run_sequence`` over the first 600 ticks of the synthetic circle, on the
CPU in float64, at tests/test_torch_modules.py's small capacities (a window
of six cameras, so the prune and its triage run often): the JAX package's
default configuration (triage kernel, hybrid update terms with the gating
kernel) and ``update_kernel="fused"``. The JAX side runs in the interpret
lane (``MSCKF_TPU_PALLAS_INTERPRET=1``), which is the path those
configurations select: its XLA triage differs from the triage kernel
(ROADMAP §3). The port runs its kernels' plain versions. Counters and
per-tick camera and track counts are exact; the trajectories are held to
tests/test_torch_slice.py's tolerances.
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
from msckf_tpu_torch.ops import kernels as K

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=256, u_max=16, k_max=128, m_max=8, n_cam_slots=8,
            max_camera_states=6, desc_dim=10)
T = 600
TICK_FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")
CONFIGS = {"default": {}, "fused": {"update_kernel": "fused"}}


def _flatten(prefix_out, frame_out):
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


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    """(JAX counters, JAX ticks), (port counters, port ticks, port stats,
    port plain-kernel calls) for one configuration."""
    overrides = {**CAPS, **CONFIGS[request.param]}
    jcfg = jx.reference_experiment_config(**overrides)
    st = _stream(jax_build_stream, jcfg, jax_circle(rng=np.random.default_rng(0)))
    std = jax_to_device(st, jcfg)
    state = jx.make_initial_state(jcfg, std.R_init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSCKF_TPU_PALLAS_INTERPRET", "1")
        final, pre, fr = jax.jit(functools.partial(jx.run_sequence, jcfg))(
            state, std.prefix, std.frames)
        jax.block_until_ready(final)
    jres = {k: int(getattr(final.diag, k)) for k in COUNTERS}, _flatten(pre, fr)

    cfg = mt.reference_experiment_config(**overrides)
    st = _stream(build_stream, cfg, generate_circle_sequence(rng=np.random.default_rng(0)))
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, std.R_init, device="cpu")
    stats = mt.FrameStats()
    calls = {}
    plain = {name: getattr(K, name) for name in ("triage_refresh_fused_plain",
                                                  "update_terms_fused_plain")}

    def counting(name):
        def f(*args):
            calls[name] = calls.get(name, 0) + 1
            return plain[name](*args)
        return f

    with pytest.MonkeyPatch.context() as mp:
        for name in plain:
            mp.setattr(K, name, counting(name))
        final, pre, fr = mt.run_sequence(cfg, state, std.prefix, std.frames,
                                         assume_camera=True, device="cpu", stats=stats)
    pres = ({k: int(getattr(final.diag, k)) for k in COUNTERS}, _flatten(pre, fr),
            stats, calls)
    return request.param, jres, pres


def test_sequence_matches_jax_interpret_lane(runs):
    name, (jc, jo), (pc, po, stats, calls) = runs
    assert po["p_WI"].shape[0] == jo["p_WI"].shape[0] == T
    assert pc == jc
    assert jc["n_epipolar_rejected"] > 0 and jc["n_gating_rejected"] > 0
    np.testing.assert_array_equal(po["n_cams"], jo["n_cams"])
    np.testing.assert_array_equal(po["n_tracks"], jo["n_tracks"])
    for f in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(po[f], jo[f], atol=1e-7, err_msg=f)
    for f in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(po[f], jo[f], rtol=1e-4, atol=1e-16, err_msg=f)
    # the port went through the kernels' plain versions: the triage on every
    # camera step and every prune, the fused terms on every update
    assert stats.prunes > 0
    assert calls["triage_refresh_fused_plain"] == stats.camera_steps + stats.prunes
    want_fused = stats.camera_steps + stats.prune_updates if name == "fused" else 0
    assert calls.get("update_terms_fused_plain", 0) == want_fused
