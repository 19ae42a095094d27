"""Checkpoint and resume of the PyTorch port (``msckf_tpu_torch/utils/
checkpoint.py``), in the JAX package's ``.npz`` format.

400 ticks of the circle in float64 on the CPU:
* the port's save -> load -> continue equals the uninterrupted port run bit
  for bit;
* a JAX checkpoint taken at half the sequence resumes in the port, against
  the JAX run continued from the same state: exact counters and per-tick
  counts, trajectories within tests/test_parity.py's tolerances;
* a port checkpoint loads in the JAX package with equal leaves;
* a checkpoint of another configuration's shapes raises ValueError;
* the leaf order: the port's flattening of the state names the JAX
  pytree's leaves in the JAX order, with equal shapes and kinds of dtype;
* the directory pair on ``torch.distributed.checkpoint``
  (``save_state_dcp`` / ``load_state_dcp``, the counterpart of the JAX
  package's Orbax pair): it round-trips bit for bit and resumes mid-sequence
  bit for bit; a state written by the JAX package's ``save_state`` and read
  by the port goes through it unchanged; another configuration's shapes
  raise ValueError.
"""

import functools

import jax
import numpy as np
import pytest

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.filter.msckf import propagate_prefix as jax_prefix
from msckf_tpu.filter.msckf import run_filter as jax_run_filter
from msckf_tpu.filter.state import init_state as jax_init_state
from msckf_tpu.utils import checkpoint as jck

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.msckf import propagate_prefix, run_filter
from msckf_tpu_torch.filter.state import _flatten, state_to_numpy
from msckf_tpu_torch.utils import checkpoint as tck

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(dtype="float64", f_max=192, u_max=32, k_max=256, desc_dim=16)
T = 400
FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _stream(build, cfg, seq):
    return build(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                 seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)


def _halves(frames, half):
    return ({k: v[:half] for k, v in frames.items()}, {k: v[half:] for k, v in frames.items()})


@pytest.fixture(scope="module")
def port():
    cfg = mt.reference_experiment_config(**CFG)
    st = _stream(build_stream, cfg, generate_circle_sequence(rng=np.random.default_rng(0)))
    return cfg, to_device(st, cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX filter over the prefix and the first half, its state there,
    and the second half continued in JAX (one compile: equal halves)."""
    cfg = jx.reference_experiment_config(**CFG)
    std = jax_to_device(_stream(jax_build_stream, cfg, jax_circle(rng=np.random.default_rng(0))),
                        cfg)
    C = std.frames["imu_ts"].shape[0]
    first, second = _halves(std.frames, C // 2)
    assert C % 2 == 0, C  # equal halves: one compile of run_filter
    run = jax.jit(functools.partial(jax_run_filter, cfg))
    state, _ = jax.jit(functools.partial(jax_prefix, cfg))(
        jx.make_initial_state(cfg, std.R_init), std.prefix)
    half_state, _ = run(state, first)
    final, out = run(half_state, second)
    return cfg, C // 2, half_state, final, out


def _port_halves(cfg, std, half):
    state = mt.make_initial_state(cfg, std.R_init, device="cpu")
    state, _ = propagate_prefix(cfg, state, std.prefix)
    first, second = _halves(std.frames, half)
    state, _ = run_filter(cfg, state, first)
    return state, second


def _assert_same_state(a, b):
    sa, sb = state_to_numpy(a), state_to_numpy(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.fixture(scope="module")
def uninterrupted(port):
    cfg, std = port
    final, _, out = mt.run_sequence(cfg, mt.make_initial_state(cfg, std.R_init, device="cpu"),
                                    std.prefix, std.frames, device="cpu")
    return final, out


def test_port_resume_bit_exact(port, uninterrupted, tmp_path):
    cfg, std = port
    final_u, out_u = uninterrupted
    half = std.frames["imu_ts"].shape[0] // 2
    state, second = _port_halves(cfg, std, half)
    path = str(tmp_path / "ckpt.npz")
    tck.save_state(path, state)
    restored = tck.load_state(path, cfg, device="cpu")
    _assert_same_state(restored, state)
    final_r, out_r = run_filter(cfg, restored, second)
    _assert_same_state(final_r, final_u)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(out_r, name).numpy(),
                                      getattr(out_u, name)[half:].numpy(), err_msg=name)


def test_jax_checkpoint_resumes_in_port(port, jax_run, tmp_path):
    cfg, std = port
    _, half, jhalf, jfinal, jout = jax_run
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, jhalf)
    state = tck.load_state(path, cfg, device="cpu")
    assert state.imu.step_id.dtype == state.next_track_id.dtype == mt.init_state(
        cfg, device="cpu").imu.step_id.dtype
    leaves = jax.tree.leaves(jhalf)
    for (k, v), leaf in zip(state_to_numpy(state).items(), leaves):
        np.testing.assert_array_equal(v, np.asarray(leaf), err_msg=k)
    final, out = run_filter(cfg, state, _halves(std.frames, half)[1])
    for k in COUNTERS:
        assert int(getattr(final.diag, k)) == int(getattr(jfinal.diag, k)), k
    for name in ("n_cams", "n_tracks"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)))
    for name in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=1e-7, err_msg=name)
    for name in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-16, err_msg=name)


def test_port_checkpoint_loads_in_jax(port, jax_run, tmp_path):
    cfg, std = port
    jcfg, half = jax_run[:2]
    state, _ = _port_halves(cfg, std, half)
    path = str(tmp_path / "port.npz")
    tck.save_state(path, state)
    loaded = jck.load_state(path, jcfg)
    ours = state_to_numpy(state)
    leaves = jax.tree.leaves(loaded)
    assert len(leaves) == len(ours) == 30
    for (k, v), leaf in zip(ours.items(), leaves):
        np.testing.assert_array_equal(np.asarray(leaf), v, err_msg=k)


def test_wrong_shape_checkpoint_raises(port, tmp_path):
    cfg, _ = port
    path = str(tmp_path / "small.npz")
    tck.save_state(path, mt.init_state(cfg, device="cpu"))
    other = mt.reference_experiment_config(**dict(CFG, f_max=256))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state(path, other, device="cpu")


def test_leaf_order_matches_jax(port):
    """The checkpoint's leaf_i is the same field in both packages: the JAX
    pytree's key paths, in order, are the port's field paths, with equal
    shapes and the same kind of dtype (float, integer, bool)."""
    cfg, _ = port
    jpaths, _ = jax.tree_util.tree_flatten_with_path(jax_init_state(jx.reference_experiment_config(**CFG)))
    ours = _flatten(mt.init_state(cfg, device="cpu"), "", {})
    assert [jax.tree_util.keystr(p).lstrip(".") for p, _ in jpaths] == list(ours)
    for (p, leaf), (k, v) in zip(jpaths, ours.items()):
        assert tuple(leaf.shape) == tuple(v.shape), k
        assert np.asarray(leaf).dtype.kind == v.numpy().dtype.kind, k


def test_dcp_pair_round_trips_and_resumes_bit_exact(port, uninterrupted, tmp_path):
    cfg, std = port
    final_u, out_u = uninterrupted
    half = std.frames["imu_ts"].shape[0] // 2
    state, second = _port_halves(cfg, std, half)
    path = str(tmp_path / "dcp")
    tck.save_state_dcp(path, state)
    restored = tck.load_state_dcp(path, cfg, device="cpu")
    _assert_same_state(restored, state)
    for (k, a), b in zip(_flatten(restored, "", {}).items(), _flatten(state, "", {}).values()):
        assert a.dtype == b.dtype and a.device.type == "cpu", k
    final_r, out_r = run_filter(cfg, restored, second)
    _assert_same_state(final_r, final_u)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(out_r, name).numpy(),
                                      getattr(out_u, name)[half:].numpy(), err_msg=name)


def test_jax_state_goes_through_the_dcp_pair(port, jax_run, tmp_path):
    cfg, _ = port
    jhalf = jax_run[2]
    jck.save_state(str(tmp_path / "jax.npz"), jhalf)
    state = tck.load_state(str(tmp_path / "jax.npz"), cfg, device="cpu")
    tck.save_state_dcp(str(tmp_path / "dcp"), state)
    back = tck.load_state_dcp(str(tmp_path / "dcp"), cfg, device="cpu")
    for (k, v), leaf in zip(state_to_numpy(back).items(), jax.tree.leaves(jhalf)):
        np.testing.assert_array_equal(v, np.asarray(leaf), err_msg=k)


def test_dcp_wrong_shape_raises(port, tmp_path):
    cfg, _ = port
    path = str(tmp_path / "dcp")
    tck.save_state_dcp(path, mt.init_state(cfg, device="cpu"))
    other = mt.reference_experiment_config(**dict(CFG, f_max=256))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state_dcp(path, other, device="cpu")
