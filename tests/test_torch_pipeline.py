"""The port's image-in pipeline against the JAX package's.

* ``data/rendered.py`` renders the same sequence bit for bit (a 160 x 128
  circle, 200 ticks);
* ``fused_frame_step`` on one random-texture frame, at
  tests/test_pipeline_fused.py's small capacities;
* ``run_sequence_images`` over the rendered sequence with a float64 filter
  (the CNN in float32), the whole-stack CNN and ``cnn_chunk=4``: equal
  detections per frame, exact discrete counts, trajectories within
  tests/test_torch_slice.py's tolerances.

The JAX side loads the committed weights with its own ``load_npz_params``;
the port gets them through ``state_dict_from_flax``. One JAX compile per
function.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_tpu as jx
from msckf_tpu.data.rendered import generate_rendered_circle as jax_rendered_circle
from msckf_tpu.data.stream import build_image_stream as jax_build_image_stream
from msckf_tpu.data.stream import suggest_capacities as jax_suggest_capacities
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.models.selfsup import random_texture
from msckf_tpu.models.train_xfeat import load_npz_params
from msckf_tpu.models.xfeat import detect_and_compute as jax_detect_and_compute
from msckf_tpu.pipeline import fused_frame_step as jax_fused_frame_step
from msckf_tpu.pipeline import run_sequence_images as jax_run_sequence_images

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.rendered import generate_rendered_circle
from msckf_tpu_torch.data.stream import build_image_stream, suggest_capacities, to_device
from msckf_tpu_torch.models.xfeat import XFeatModel, state_dict_from_flax

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "xfeat_selfsup.npz"
RENDER = dict(n_ticks=200, width=160, height=128, fxy=90.0)
TOP_K = 48
TICK_FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _small(pkg, **kw):
    """tests/test_pipeline_fused.py's capacities, float64 filter."""
    base = dict(dtype="float64", desc_dim=64, f_max=96, u_max=16, k_max=64,
                max_camera_states=6, n_cam_slots=7, m_max=7)
    return pkg.reference_experiment_config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_params():
    return load_npz_params(str(WEIGHTS))


@pytest.fixture(scope="module")
def model(jax_params):
    m = XFeatModel()
    m.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, jax_params)))
    return m.eval()


@pytest.fixture(scope="module")
def seqs():
    return (jax_rendered_circle(rng=np.random.default_rng(0), **RENDER),
            generate_rendered_circle(rng=np.random.default_rng(0), **RENDER))


def test_rendered_sequence_is_bit_identical(seqs):
    ref, got = seqs
    assert got.images.shape == (20, 128, 160) and got.images.dtype == np.float32
    assert got.images.std() > 10.0
    for f in ("timestamps", "poses_R", "poses_t", "imu_gyro", "imu_acc", "cam_frame_ticks",
              "images", "R_WC_extrinsic"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)


def test_suggest_capacities_matches_jax():
    for n in ((0,), (10, 300), (129, 5), (1000,)):
        kps = [np.zeros((k, 2)) for k in n]
        assert suggest_capacities(kps, 12) == jax_suggest_capacities(kps, 12)


def _imu_block(t0, n=3):
    ts = t0 + 0.005 * (1 + np.arange(n))
    return dict(imu_ts=ts, imu_gyro=np.tile([0.01, -0.02, 0.005], (n, 1)),
                imu_acc=np.tile([0.05, 0.0, 9.81], (n, 1)), imu_valid=np.ones(n, bool))


def test_fused_frame_step_matches_jax(jax_params, model):
    img = random_texture(np.random.default_rng(0), 96)
    blk = _imu_block(0.0)
    jcfg, tcfg = _small(jx), _small(mt)
    jstate, jout = jax.jit(lambda s, im, b: jax_fused_frame_step(
        jcfg, jax_params, s, im, b, top_k=TOP_K))(
        jx.make_initial_state(jcfg, R_init=np.eye(3)), jnp.asarray(img),
        {k: jnp.asarray(v) for k, v in blk.items()})
    stats = mt.FrameStats()
    tstate, tout = mt.fused_frame_step(
        tcfg, model, mt.make_initial_state(tcfg, R_init=np.eye(3), device="cpu"),
        torch.as_tensor(img), {k: torch.as_tensor(v) for k, v in blk.items()},
        top_k=TOP_K, device="cpu", stats=stats)
    assert stats.frames == stats.camera_steps == 1
    assert int(jstate.tracks.valid.sum()) > 10
    np.testing.assert_array_equal(tstate.tracks.valid.numpy(), np.asarray(jstate.tracks.valid))
    np.testing.assert_array_equal(tstate.tracks.track_id.numpy(),
                                  np.asarray(jstate.tracks.track_id))
    np.testing.assert_allclose(tstate.tracks.obs.numpy(), np.asarray(jstate.tracks.obs),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tstate.imu.p_WI.numpy(), np.asarray(jstate.imu.p_WI),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tstate.P.numpy(), np.asarray(jstate.P), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(tout.p_WI.numpy(), np.asarray(jout.p_WI), rtol=0, atol=1e-12)


def _flatten(pre, fr):
    pv = np.asarray(pre.valid)
    fv = np.asarray(fr.valid).reshape(-1)
    out = {}
    for name in TICK_FIELDS:
        a, b = np.asarray(getattr(pre, name)), np.asarray(getattr(fr, name))
        out[name] = np.concatenate([a[pv], b.reshape((-1,) + b.shape[2:])[fv]])
    return out


def _seq_cfg(pkg, seq):
    H, W = seq.images.shape[1:]
    return _small(pkg, f_max=128, R_WC=tuple(map(tuple, seq.R_WC_extrinsic.tolist())),
                  K=((RENDER["fxy"], 0.0, W / 2.0), (0.0, RENDER["fxy"], H / 2.0),
                     (0.0, 0.0, 1.0)), width=W, height=H)


@pytest.fixture(scope="module")
def jax_sequence(seqs, jax_params):
    seq = seqs[0]
    cfg = _seq_cfg(jx, seq)
    st = jax_build_image_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc,
                                seq.cam_frame_ticks)
    std = jax_to_device(st, cfg)
    images = jnp.asarray(seq.images[st.proc_cam_idx])
    final, pre, fr = jax.jit(lambda s, p, f, im: jax_run_sequence_images(
        cfg, jax_params, s, p, f, im, top_k=TOP_K))(
        jx.make_initial_state(cfg, std.R_init), std.prefix, std.frames, images)
    detections = jax.device_get(jax.jit(jax.vmap(
        lambda im: jax_detect_and_compute(jax_params, im, top_k=TOP_K)))(images))
    return ({k: int(getattr(final.diag, k)) for k in COUNTERS}, _flatten(pre, fr),
            detections, st.proc_cam_idx)


@pytest.mark.parametrize("cnn_chunk", [None, 4])
def test_run_sequence_images_matches_jax(seqs, model, jax_sequence, cnn_chunk):
    jc, jo, jdet, jidx = jax_sequence
    seq = seqs[1]
    cfg = _seq_cfg(mt, seq)
    st = build_image_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc,
                            seq.cam_frame_ticks)
    np.testing.assert_array_equal(st.proc_cam_idx, jidx)
    assert set(st.frames) == {"imu_ts", "imu_gyro", "imu_acc", "imu_valid"}
    std = to_device(st, cfg, device="cpu")
    images = torch.as_tensor(seq.images[st.proc_cam_idx])
    C = images.shape[0]
    assert C == 18 and C % 4 != 0  # the last chunk is padded

    # the detections of every frame, as the CNN stage computes them
    kp, desc, score, valid = mt.detect_and_compute(model, images, top_k=TOP_K)
    np.testing.assert_array_equal(valid.numpy(), jdet[3])
    np.testing.assert_array_equal(kp.numpy(), jdet[0])
    np.testing.assert_allclose(score.numpy(), jdet[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(desc.numpy(), jdet[1], rtol=0, atol=1e-4)
    assert valid.sum(dim=1).min() > 10

    stats = mt.FrameStats()
    final, pre, fr = mt.run_sequence_images(
        cfg, model, mt.make_initial_state(cfg, std.R_init, device="cpu"), std.prefix,
        std.frames, images, top_k=TOP_K, cnn_chunk=cnn_chunk, device="cpu", stats=stats)
    assert stats.frames == stats.camera_steps == C
    assert {k: int(getattr(final.diag, k)) for k in COUNTERS} == jc
    po = _flatten(pre, fr)
    assert po["p_WI"].shape[0] == jo["p_WI"].shape[0] == 200
    assert jo["n_tracks"].max() > 10
    np.testing.assert_array_equal(po["n_cams"], jo["n_cams"])
    np.testing.assert_array_equal(po["n_tracks"], jo["n_tracks"])
    for name in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(po[name], jo[name], atol=1e-7, err_msg=name)
    for name in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(po[name], jo[name], rtol=1e-4, atol=1e-16, err_msg=name)


def test_desc_dim_must_be_64(model):
    cfg = _small(mt, desc_dim=10)
    state = mt.make_initial_state(cfg, R_init=np.eye(3), device="cpu")
    img = torch.zeros(64, 64)
    blk = {k: torch.as_tensor(v) for k, v in _imu_block(0.0).items()}
    with pytest.raises(ValueError, match="64-d"):
        mt.fused_frame_step(cfg, model, state, img, blk, device="cpu")
    with pytest.raises(ValueError, match="64-d"):
        mt.run_sequence_images(cfg, model, state, {}, {k: v[None] for k, v in blk.items()},
                               img[None], device="cpu")
