"""Chunked, double-buffered streaming of the PyTorch port
(``msckf_tpu_torch/filter/streamed.py``).

400 ticks of the circle in float64 at tests/test_streamed.py's capacities,
on the CPU:
* ``run_sequence_streamed`` at chunk_frames 7, 1 and 10 000 bitwise equal to
  the port's monolithic ``run_sequence`` (outputs and final state), with one
  host sync per chunk more than the monolithic loop;
* against the JAX package's ``run_sequence_streamed``: exact counters and
  per-tick counts, trajectories within tests/test_parity.py's tolerances;
* ``on_prefix`` and ``on_chunk`` fire once each, in order, with the chunks'
  start frames, and the chunks put together are the result;
* ``run_batched_streamed`` over two seeds at chunk_frames=5 bitwise equal to
  ``batched_run_sequence``.
"""

import numpy as np
import pytest
import torch

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.filter.streamed import run_sequence_streamed as jax_streamed

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, circle_streams, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.state import state_to_numpy
from msckf_tpu_torch.filter.streamed import run_batched_streamed, run_sequence_streamed

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dtype="float64", f_max=192, u_max=32, k_max=256, desc_dim=16)
T = 400
FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks", "valid")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _stream(build, cfg, seq):
    return build(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                 seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)


@pytest.fixture(scope="module")
def prepared():
    cfg = mt.reference_experiment_config(**CFG)
    st = _stream(build_stream, cfg, generate_circle_sequence(rng=np.random.default_rng(0)))
    return cfg, st


@pytest.fixture(scope="module")
def monolithic(prepared):
    cfg, st = prepared
    std = to_device(st, cfg, device="cpu")
    stats = mt.FrameStats()
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    final, pre, out = mt.run_sequence(cfg, state, std.prefix, std.frames, device="cpu",
                                      stats=stats)
    return final, pre, out, stats


def _streamed(prepared, chunk, **kw):
    cfg, st = prepared
    stats = mt.FrameStats()
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    final, pre, out = run_sequence_streamed(cfg, state, st.prefix, st.frames,
                                            chunk_frames=chunk, device="cpu", stats=stats,
                                            **kw)
    return final, pre, out, stats


def _assert_same(a_out, b_out):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a_out, name)),
                                      np.asarray(getattr(b_out, name)), err_msg=name)


def _assert_same_state(a, b):
    sa, sb = state_to_numpy(a), state_to_numpy(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.parametrize("chunk", [7, 1, 10_000])
def test_streamed_matches_monolithic(prepared, monolithic, chunk):
    final_m, pre_m, out_m, stats_m = monolithic
    final_s, pre_s, out_s, stats_s = _streamed(prepared, chunk)
    C = out_m.p_WI.shape[0]
    assert C >= 30 and out_s.p_WI.shape == tuple(out_m.p_WI.shape)
    assert isinstance(out_s.p_WI, np.ndarray) and isinstance(pre_s.p_WI, np.ndarray)
    _assert_same(out_s, out_m)
    _assert_same(pre_s, pre_m)
    _assert_same_state(final_s, final_m)
    assert int(final_s.diag.n_track_overflow) == 0
    n_chunks = -(-C // chunk)
    assert stats_s.frames == stats_m.frames == C
    assert stats_s.host_syncs == stats_m.host_syncs + n_chunks


def test_streamed_matches_jax(prepared):
    cfg, _ = prepared
    jcfg = jx.reference_experiment_config(**CFG)
    jst = _stream(jax_build_stream, jcfg, jax_circle(rng=np.random.default_rng(0)))
    jfinal, jpre, jout = jax_streamed(jcfg, jx.make_initial_state(jcfg, jst.R_init),
                                      jst.prefix, jst.frames, chunk_frames=7)
    final, pre, out, _ = _streamed(prepared, 7)
    for k in COUNTERS:
        assert int(getattr(final.diag, k)) == int(getattr(jfinal.diag, k)), k
    assert int(jfinal.diag.n_epipolar_rejected) > 0
    for a, b in ((pre, jpre), (out, jout)):
        for name in ("n_cams", "n_tracks", "valid"):
            np.testing.assert_array_equal(getattr(a, name), np.asarray(getattr(b, name)))
        for name in ("p_WI", "v_WI", "R_WI"):
            np.testing.assert_allclose(getattr(a, name), np.asarray(getattr(b, name)),
                                       atol=1e-7, err_msg=name)
        for name in ("sigma_pos", "sigma_rot"):
            np.testing.assert_allclose(getattr(a, name), np.asarray(getattr(b, name)),
                                       rtol=1e-4, atol=1e-16, err_msg=name)


def test_callbacks_fire_in_order(prepared, monolithic):
    _, pre_m, out_m, _ = monolithic
    calls = []
    _, pre, out, _ = _streamed(
        prepared, 9,
        on_prefix=lambda p: calls.append(("prefix", p)),
        on_chunk=lambda start, o: calls.append((start, o)),
    )
    C = out.p_WI.shape[0]
    assert [c[0] for c in calls] == ["prefix"] + list(range(0, C, 9))
    _assert_same(calls[0][1], pre)
    chunks = [c[1] for c in calls[1:]]
    assert [ch.p_WI.shape[0] for ch in chunks] == [min(9, C - a) for a in range(0, C, 9)]
    joined = type(out)(*(np.concatenate(x) for x in zip(*chunks)))
    _assert_same(joined, out)
    _assert_same(joined, out_m)


def test_batched_streamed_matches_batched():
    cfg = mt.reference_experiment_config(**CFG)
    st = circle_streams(cfg, [0, 1], max_ticks=300)
    std = to_device(st, cfg, device="cpu")
    states = mt.batched_initial_state(cfg, 2, st.R_init, device="cpu")
    final_m, pre_m, out_m = mt.batched_run_sequence(cfg, states, std.prefix, std.frames,
                                                    device="cpu")
    final_s, pre_s, out_s = run_batched_streamed(cfg, states, st.prefix, st.frames,
                                                 chunk_frames=5, device="cpu")
    assert out_s.p_WI.shape == tuple(out_m.p_WI.shape)  # (2, C, B, 3)
    assert not np.allclose(out_s.p_WI[0], out_s.p_WI[1])
    _assert_same(out_s, out_m)
    _assert_same(pre_s, pre_m)
    _assert_same_state(final_s, final_m)


def test_streamed_rejects_bad_input(prepared):
    cfg, st = prepared
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        run_sequence_streamed(cfg, state, st.prefix, st.frames, chunk_frames=0, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        run_sequence_streamed(cfg, state, st.prefix, {k: v[:0] for k, v in st.frames.items()},
                              device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        run_sequence_streamed(cfg, state, st.prefix, st.frames, device="meta")
    assert torch.isfinite(state.P).all()
