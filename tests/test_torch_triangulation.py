"""The port's Gauss-Newton triangulation (``triangulation="gn"``), camera
slot resolution and XLA-form verification (``use_pallas=False``) against
the JAX package, on the CPU in float64.

* ``refine_inverse_depth_gn`` over 16 bundles of 8 observations with ragged
  masks (one row all false), batched, against ``jax.vmap`` of the JAX
  function;
* ``resolve_cam_slots`` exactly, with repeated, missing and -1 ids;
* ``verify_matches`` with ``use_pallas=False`` against the JAX package's
  CPU lane (its XLA form): accept masks and rejection counters exact;
* ``triage_features`` with ``triangulation="gn"`` on a mid-sequence state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_tpu.config import reference_experiment_config as jax_config
from msckf_tpu.filter.tracks import resolve_cam_slots as jax_resolve_cam_slots
from msckf_tpu.filter.update import triage_features as jax_triage_features
from msckf_tpu.filter.verification import verify_matches as jax_verify_matches
from msckf_tpu.ops.triangulation import refine_inverse_depth_gn as jax_refine

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.augmentation import state_augmentation
from msckf_tpu_torch.filter.matching import fused_descriptors, mutual_match
from msckf_tpu_torch.filter.msckf import add_camera_measurements
from msckf_tpu_torch.filter.state import device_consts
from msckf_tpu_torch.filter.tracks import gather_cam_poses, resolve_cam_slots, select_rows
from msckf_tpu_torch.filter.update import triage_features
from msckf_tpu_torch.filter.verification import _scores_xla, verify_matches
from msckf_tpu_torch.ops import kernels as K
from msckf_tpu_torch.ops.triangulation import refine_inverse_depth_gn

from tests.test_torch_modules import jax_state_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=256, u_max=16, k_max=128, m_max=8, n_cam_slots=8,
            max_camera_states=6, desc_dim=10, use_pallas_triage=False)



def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _rot(rng, scale):
    """A random rotation of angle up to ``scale`` rad (Rodrigues)."""
    w = rng.normal(size=3)
    w *= scale * rng.uniform() / np.linalg.norm(w)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _bundles(rng, n=16, M=8):
    """n anchored points seen by M cameras each (camera z forward), noisy
    normalized observations, seeds off by a few degrees and 20 % in depth,
    ragged masks with row 3 all false."""
    base = np.zeros((n, 3))
    m0 = np.zeros((n, 3))
    rho0 = np.zeros(n)
    R = np.zeros((n, M, 3, 3))
    t = np.zeros((n, M, 3))
    z = np.zeros((n, M, 2))
    for i in range(n):
        X = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(3, 8)])
        for j in range(M):
            R[i, j] = _rot(rng, 0.1)
            t[i, j] = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-0.5, 0.5)])
            pc = R[i, j].T @ (X - t[i, j])
            z[i, j] = pc[:2] / pc[2] + rng.normal(size=2) * 1e-3
        base[i] = t[i, 0]
        d = X - base[i]
        m_true = d / np.linalg.norm(d)
        m0[i] = _rot(rng, 0.05) @ m_true
        rho0[i] = 1.2 / np.linalg.norm(d)
    mask = rng.uniform(size=(n, M)) < 0.7
    mask[:, :2] = True
    mask[3] = False
    return base, m0, rho0, R, t, z, mask


def test_refine_inverse_depth_gn_matches_jax():
    args = _bundles(np.random.default_rng(0))
    m, rho = refine_inverse_depth_gn(*(torch.as_tensor(a) for a in args), iters=5)
    jm, jrho = jax.jit(jax.vmap(lambda *a: jax_refine(*a, iters=5)))(*map(jnp.asarray, args))
    _close(m.numpy(), np.asarray(jm))
    _close(rho.numpy(), np.asarray(jrho))
    # the refinement moved every seeded bundle toward its point; the
    # all-false row keeps its seed
    rho0 = args[2]
    assert not np.allclose(rho.numpy(), rho0)
    _close(rho.numpy()[3], rho0[3])
    assert np.isfinite(m.numpy()).all() and (rho.numpy() >= 1e-8).all()


def test_resolve_cam_slots_matches_jax():
    rng = np.random.default_rng(1)
    cam_ids = np.array([7, -1, 3, 12, -1, 5, 3, 9])  # a repeated id, two free slots
    obs = rng.choice(np.array([7, 3, 12, 5, 9, 4, -1, 100]), size=(32, 6))
    slots, found = resolve_cam_slots(torch.as_tensor(obs), torch.as_tensor(cam_ids))
    js, jf = jax_resolve_cam_slots(jnp.asarray(obs), jnp.asarray(cam_ids))
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jf))
    assert found.any() and not found.all()
    assert (slots[obs == 3] == 2).all()  # the first slot of a repeated id


# --- on a mid-sequence state ----------------------------------------------


@pytest.fixture(scope="module")
def mid():
    """The state after 12 frames of the circle, augmented with the next
    frame's camera, and that frame's inputs."""
    cfg = mt.reference_experiment_config(**CAPS)
    seq = generate_circle_sequence(rng=np.random.default_rng(0))
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=160)
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    state, _, _ = mt.run_sequence(cfg, state, std.prefix,
                                  {k: v[:12] for k, v in std.frames.items()},
                                  assume_camera=True, device="cpu")
    nxt = {k: v[12] for k, v in std.frames.items()}
    assert int(state.cams.n) >= 4 and int(state.tracks.valid.sum()) > 20
    return state_augmentation(cfg, state), nxt


def _matches(cfg, s, nxt):
    m = mutual_match(fused_descriptors(s.tracks), s.tracks.valid, nxt["desc"], nxt["kp_valid"],
                     cfg.min_cosine_similarity)
    return m, select_rows(m.track_to_kp, True, nxt["kp"])


@pytest.mark.parametrize("short_baseline", [False, True], ids=["real", "short-baseline"])
def test_verify_matches_xla_form_matches_jax(mid, short_baseline):
    """``use_pallas=False``: the port's XLA form against the JAX package's
    (its CPU lane runs no kernel). ``short-baseline`` puts the current
    camera by the previous one, so observations take the homography
    branch. The kernel's wrapper is not called."""
    s, nxt = mid
    cfg = mt.reference_experiment_config(**CAPS, use_pallas=False)
    jcfg = jax_config(**CAPS, use_pallas=False)
    n = int(s.cams.n)
    cam_R, cam_t = s.cams.R[n - 1], s.cams.t[n - 1]
    if short_baseline:
        cam_t = s.cams.t[n - 2] + 0.001
    m, kp2 = _matches(cfg, s, nxt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "verification_scores", None)
        got = verify_matches(cfg, s.tracks, s.cams, m.track_matched, kp2, cam_R, cam_t)
    js = jax_state_from_numpy(jcfg, mt.state_to_numpy(s))
    want = jax.jit(lambda tr, cams, c, k, R, t: jax_verify_matches(jcfg, tr, cams, c, k, R, t))(
        js.tracks, js.cams, *(jnp.asarray(x.numpy()) for x in (m.track_matched, kp2, cam_R, cam_t)))
    assert int(m.track_matched.sum()) > 20
    np.testing.assert_array_equal(got.accept.numpy(), np.asarray(want.accept))
    assert int(got.n_homo_rejected) == int(want.n_homo_rejected)
    assert int(got.n_epi_rejected) == int(want.n_epi_rejected)
    if short_baseline:
        assert int(got.n_homo_rejected) + int((got.accept & m.track_matched).sum()) > 0
    else:
        assert int(got.n_epi_rejected) > 0


def test_xla_scores_match_the_kernels_plain_version(mid):
    """The XLA form and the kernel's plain version compute the same three
    scores with the same |z| guard, by different orders of products."""
    s, nxt = mid
    cfg = mt.reference_experiment_config(**CAPS)
    consts = device_consts(cfg, torch.device("cpu"))
    R1, t1, _ = gather_cam_poses(s.tracks.obs_cam_id, s.cams)
    n = int(s.cams.n)
    _, kp2 = _matches(cfg, s, nxt)
    args = (R1, t1, s.tracks.kp, kp2, s.cams.R[n - 1], s.cams.t[n - 1], consts.K, consts.Kinv)
    live = s.tracks.obs_valid.numpy()
    for got, want in zip(_scores_xla(*args), K.verification_scores_plain(*args)):
        _close(got.numpy()[live], want.numpy()[live], rtol=1e-9)


def test_triage_features_gn_matches_jax(mid):
    """``triangulation="gn"``: the plain line intersection seeds the
    Gauss-Newton refinement, written wherever the track is valid. The
    valid tracks (up to three) get their line bases moved 1 km behind their
    anchor camera, so the intersection does not refresh them: their seed
    is their own point, and the refinement is still written."""
    s, nxt = mid
    cfg = mt.reference_experiment_config(**CAPS, triangulation="gn")
    jcfg = jax_config(**CAPS, triangulation="gn")
    lines_cfg = mt.reference_experiment_config(**CAPS)
    s = add_camera_measurements(cfg, s, nxt["kp"], nxt["desc"], nxt["score"], nxt["kp_valid"])
    moved = torch.nonzero(triage_features(lines_cfg, s, s.tracks.valid).valid)[:3, 0]
    R_a, _, _ = gather_cam_poses(s.tracks.obs_cam_id[moved, 0], s.cams)
    obs = s.tracks.obs.clone()
    obs[moved, :, 3:6] -= 1e3 * R_a[:, None, :, 2]  # line_base, minus the camera's z axis
    s = s.replace(tracks=s.tracks.replace(obs=obs))

    got = triage_features(cfg, s, s.tracks.valid)
    js = jax_state_from_numpy(jcfg, mt.state_to_numpy(s))
    want = jax.jit(lambda st, sub: jax_triage_features(jcfg, st, sub))(
        js, jnp.asarray(s.tracks.valid.numpy()))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.lost.numpy(), np.asarray(want.lost))
    assert len(moved) > 0 and got.valid[moved].all()
    _close(got.tracks.idp_m.numpy(), np.asarray(want.tracks.idp_m))
    _close(got.tracks.idp_rho.numpy(), np.asarray(want.tracks.idp_rho))
    lines = triage_features(lines_cfg, s, s.tracks.valid)
    rho0, rho_lines = s.tracks.idp_rho.numpy(), lines.tracks.idp_rho.numpy()
    moved = moved.numpy()
    np.testing.assert_array_equal(rho_lines[moved], rho0[moved])  # no refresh
    assert (got.tracks.idp_rho.numpy()[moved] != rho0[moved]).all()  # refined all the same
    assert not np.array_equal(got.tracks.idp_rho.numpy(), rho_lines)
