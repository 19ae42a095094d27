"""Filter modules of the PyTorch port against the JAX package, on the CPU in
float64, with the JAX side in the interpret lane (``MSCKF_TPU_PALLAS_
INTERPRET=1``: every Pallas call site runs its kernel in interpret mode, as
the TPU would run it, and the port runs the kernels' plain versions).

Both sides start from the same mid-sequence state of the circle, carried
across as a flat dict of numpy arrays (``state_to_numpy`` /
``state_from_numpy`` on the port's side). Masks and counts must be equal;
floats agree to round-off (rtol 1e-10 with an absolute floor of 1e-10 times
each array's scale, for its entries at or near zero).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_tpu.filter.state as jstate
from msckf_tpu.config import reference_experiment_config as jax_config
from msckf_tpu.filter.propagation import propagate_block as jax_propagate_block
from msckf_tpu.filter.update import build_update_terms as jax_build_update_terms
from msckf_tpu.filter.update import triage_features as jax_triage_features
from msckf_tpu.filter.verification import verify_matches as jax_verify_matches

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.augmentation import state_augmentation
from msckf_tpu_torch.filter.matching import fused_descriptors, mutual_match
from msckf_tpu_torch.filter.msckf import add_camera_measurements
from msckf_tpu_torch.filter.propagation import propagate_block
from msckf_tpu_torch.filter.tracks import select_rows
from msckf_tpu_torch.filter.update import build_update_terms, triage_features
from msckf_tpu_torch.filter.verification import verify_matches
from msckf_tpu_torch.ops import kernels as K

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=256, u_max=16, k_max=128, m_max=8, n_cam_slots=8,
            max_camera_states=6, desc_dim=10, use_pallas_triage=False)
RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


# --- carrying state between the two packages ------------------------------


def jax_state_to_numpy(obj, prefix="", out=None):
    out = {} if out is None else out
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            jax_state_to_numpy(v, f"{prefix}{f.name}.", out)
        else:
            out[f"{prefix}{f.name}"] = np.asarray(v)
    return out


def jax_state_from_numpy(cfg, d):
    """A JAX FilterState with the dtypes of ``init_state`` and the values of
    the flat dict ``d``."""

    def fill(obj, prefix):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}{f.name}"
            kw[f.name] = fill(v, key + ".") if dataclasses.is_dataclass(v) else (
                jnp.asarray(d[key], dtype=v.dtype)
            )
        return obj.replace(**kw)

    return fill(jstate.init_state(cfg), "")


def test_state_round_trip(mid):
    cfg, jcfg, d, _ = mid
    back = jax_state_to_numpy(jax_state_from_numpy(jcfg, d))
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    d2 = mt.state_to_numpy(mt.state_from_numpy(d, device="cpu"))
    for k in d:
        np.testing.assert_array_equal(d2[k], d[k], err_msg=k)


# --- a mid-sequence state of the circle -----------------------------------


@pytest.fixture(scope="module")
def mid():
    """The port's state after 12 frames of the circle (six cameras in the
    window, live tracks), and the next frame's inputs."""
    cfg = mt.reference_experiment_config(**CAPS)
    seq = generate_circle_sequence(rng=np.random.default_rng(0))
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=160)
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    frames = {k: v[:12] for k, v in std.frames.items()}
    state, _, _ = mt.run_sequence(cfg, state, std.prefix, frames, assume_camera=True,
                                  device="cpu")
    nxt = {k: v[12] for k, v in std.frames.items()}
    assert int(state.cams.n) >= 4 and int(state.tracks.valid.sum()) > 20
    return cfg, jax_config(**CAPS), mt.state_to_numpy(state), nxt


@pytest.fixture
def interpret_lane(monkeypatch):
    monkeypatch.setenv("MSCKF_TPU_PALLAS_INTERPRET", "1")


# --- propagate_block: all three dispatch branches -------------------------


@pytest.mark.parametrize("B,pad", [(1, 0), (9, 2), (100, 3)],
                         ids=["B1-fused", "B9-p15", "B100-scan"])
def test_propagate_block_matches_jax(mid, interpret_lane, B, pad):
    cfg, jcfg, d, _ = mid
    rng = np.random.default_rng(B)
    ts = float(d["imu.timestamp"]) + 0.005 * np.arange(1, B + 1)
    gyro = rng.normal(size=(B, 3)) * 0.2
    acc = rng.normal(size=(B, 3)) + np.array([0.0, 0.0, 9.8])
    valid = np.ones(B, bool)
    if pad:
        valid[-pad:] = False
        ts[-pad:] = 0.0

    js, jouts = jax.jit(lambda s: jax_propagate_block(jcfg, s, *map(jnp.asarray, (ts, gyro, acc, valid))))(
        jax_state_from_numpy(jcfg, d))
    ts_, gy_, ac_, va_ = (torch.as_tensor(x) for x in (ts, gyro, acc, valid))
    ps, pouts = propagate_block(cfg, mt.state_from_numpy(d, device="cpu"), ts_, gy_, ac_, va_)

    jd, pd = jax_state_to_numpy(js), mt.state_to_numpy(ps)
    for k in ("imu.R_WI", "imu.p_WI", "imu.v_WI", "imu.timestamp", "P"):
        _close(pd[k], jd[k])
    for k in ("imu.step_id", "imu.prop_count"):
        assert int(pd[k]) == int(jd[k])
    for a, b in zip(pouts[:5], jouts[:5]):
        _close(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pouts[5].numpy(), np.asarray(jouts[5]))


# --- verification ---------------------------------------------------------


@pytest.mark.parametrize("short_baseline", [False, True], ids=["real", "short-baseline"])
def test_verify_matches_matches_jax(mid, interpret_lane, short_baseline):
    """Matches of the next frame against the window. ``short-baseline``
    puts the current camera at the previous camera's position, so its
    observations take the homography branch."""
    cfg, jcfg, d, nxt = mid
    s = state_augmentation(cfg, mt.state_from_numpy(d, device="cpu"))
    n = int(s.cams.n)
    cam_R, cam_t = s.cams.R[n - 1], s.cams.t[n - 1]
    if short_baseline:
        cam_t = s.cams.t[n - 2] + 0.001
    keep = nxt["kp_valid"]
    m = mutual_match(fused_descriptors(s.tracks), s.tracks.valid, nxt["desc"], keep,
                     cfg.min_cosine_similarity)
    kp2 = select_rows(m.track_to_kp, True, nxt["kp"])
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


# --- triage and the update terms ------------------------------------------


@pytest.fixture(scope="module")
def pre_update(mid):
    """The state where the camera step calls the EKF update: after
    augmentation and the next frame's measurements, with the triage's
    ``valid`` mask."""
    cfg, jcfg, d, nxt = mid
    s = state_augmentation(cfg, mt.state_from_numpy(d, device="cpu"))
    s = add_camera_measurements(cfg, s, nxt["kp"], nxt["desc"], nxt["score"], nxt["kp_valid"])
    tri = triage_features(cfg, s, s.tracks.valid)
    return s, tri


def test_triage_features_matches_jax(mid, pre_update, interpret_lane):
    cfg, jcfg, _, _ = mid
    s, tri = pre_update
    js = jax_state_from_numpy(jcfg, mt.state_to_numpy(s))
    want = jax.jit(lambda st, sub: jax_triage_features(jcfg, st, sub))(
        js, jnp.asarray(s.tracks.valid.numpy()))
    np.testing.assert_array_equal(tri.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(tri.lost.numpy(), np.asarray(want.lost))
    assert int(tri.valid.sum()) > 0
    _close(tri.tracks.idp_m.numpy(), np.asarray(want.tracks.idp_m))
    _close(tri.tracks.idp_rho.numpy(), np.asarray(want.tracks.idp_rho))


def _jax_terms(jcfg, d, valid):
    fn = jax.jit(lambda st, v: jax_build_update_terms(jcfg, st, v))
    return fn(jax_state_from_numpy(jcfg, d), jnp.asarray(valid))


@pytest.mark.parametrize("which", ["triage-valid", "all-tracks"])
def test_build_update_terms_matches_jax(mid, pre_update, interpret_lane, which):
    """With the triage's mask, and with every live track (more than
    u_max = 16 of them, single-observation tracks with dof 0 among them)."""
    cfg, jcfg, _, _ = mid
    s, tri = pre_update
    s = s.replace(tracks=tri.tracks)
    valid = tri.valid if which == "triage-valid" else s.tracks.valid
    got = build_update_terms(cfg, s, valid)
    want = _jax_terms(jcfg, mt.state_to_numpy(s), valid.numpy())
    assert int(got.n_gate_rejected) == int(want.n_gate_rejected)
    assert int(got.n_overflow) == int(want.n_overflow)
    assert bool(got.any_pass) == bool(want.any_pass)
    if which == "all-tracks":
        assert int(got.n_overflow) > 0 and int(got.n_gate_rejected) > 0
    _close(got.A.numpy(), np.asarray(want.A))
    _close(got.c.numpy(), np.asarray(want.c))


def test_update_terms_mask_kc_of_rejected_tracks(mid, pre_update, interpret_lane):
    """The T_wk repair: one crafted track whose projection lands at z = 0
    with a huge x makes its Jacobian inf/NaN. It fails the gate in both
    packages, but the JAX package's unmasked Kc turns A non-finite; the
    port's A is finite and equals the JAX package's A computed without the
    crafted track."""
    cfg, jcfg, _, _ = mid
    s, tri = pre_update
    s = s.replace(tracks=tri.tracks)
    # eight live tracks with 3+ observations (no overflow, so dropping one
    # leaves the others' rows as they were)
    idx = torch.nonzero(s.tracks.valid & (s.tracks.n_obs >= 3))[:8, 0]
    assert len(idx) == 8
    valid = torch.zeros_like(tri.valid)
    valid[idx] = True
    f0 = int(idx[0])
    # a copy: the arrays of state_to_numpy share memory with the fixture's tensors
    d = {k: v.copy() for k, v in mt.state_to_numpy(s).items()}
    # every observation of f0 from a camera in a free slot, with an identity
    # rotation and an id no other track observes, and a point at
    # (1e150, 0, 0) in that camera: z = 0. The other tracks are untouched.
    slot = int(d["cams.n"])
    assert slot < cfg.n_cam_slots and d["cams.cam_id"][slot] == -1
    cam_id = 10**6
    d["cams.cam_id"][slot] = cam_id
    d["cams.R"][slot] = np.eye(3)
    d["cams.t"][slot] = 0.0
    d["tracks.obs"][f0, : d["tracks.n_obs"][f0], 9] = cam_id
    d["tracks.idp_rho"][f0] = 0.0
    d["tracks.idp_m"][f0] = [1e150, 0.0, 0.0]

    got = build_update_terms(cfg, mt.state_from_numpy(d, device="cpu"), valid)
    want = _jax_terms(jcfg, d, valid.numpy())
    assert not np.isfinite(np.asarray(want.A)).all()
    assert np.isfinite(got.A.numpy()).all() and np.isfinite(got.c.numpy()).all()
    assert int(got.n_gate_rejected) == int(want.n_gate_rejected) >= 1

    without = valid.clone()
    without[f0] = False
    ref = _jax_terms(jcfg, d, without.numpy())
    assert np.isfinite(np.asarray(ref.A)).all()
    _close(got.A.numpy(), np.asarray(ref.A))
    _close(got.c.numpy(), np.asarray(ref.c))


# --- the triage and update-terms kernels, and the batched-Cholesky gate --


def test_triage_kernel_matches_jax(mid, pre_update, interpret_lane, monkeypatch):
    """``use_pallas_triage=True`` (the default): the triage kernel's plain
    version in the port, the Pallas kernel in interpret mode in the JAX
    package, on the same state."""
    s, _ = pre_update
    caps = {**CAPS, "use_pallas_triage": True}
    cfg, jcfg = mt.reference_experiment_config(**caps), jax_config(**caps)
    calls = []
    plain = K.triage_refresh_fused_plain
    monkeypatch.setattr(K, "triage_refresh_fused_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tri = triage_features(cfg, s, s.tracks.valid)
    js = jax_state_from_numpy(jcfg, mt.state_to_numpy(s))
    want = jax.jit(lambda st, sub: jax_triage_features(jcfg, st, sub))(
        js, jnp.asarray(s.tracks.valid.numpy()))
    assert len(calls) == 1
    np.testing.assert_array_equal(tri.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(tri.lost.numpy(), np.asarray(want.lost))
    assert int(tri.valid.sum()) > 0
    assert bool((tri.tracks.idp_rho != s.tracks.idp_rho).any())  # some tracks refreshed
    _close(tri.tracks.idp_m.numpy(), np.asarray(want.tracks.idp_m))
    _close(tri.tracks.idp_rho.numpy(), np.asarray(want.tracks.idp_rho))


@pytest.mark.parametrize("which", ["triage-valid", "all-tracks"])
@pytest.mark.parametrize("overrides", [
    {"update_kernel": "fused"}, {"update_kernel": "xla"}, {"gating_solver": "xla"},
    {"gating_solver": "ns", "gating_ns_iters": 12},
], ids=["fused", "xla", "xla-gate", "ns-gate"])
def test_build_update_terms_variants_match_jax(mid, pre_update, interpret_lane, overrides,
                                               which):
    """The fused update-terms kernel (its plain version against the Pallas
    kernel in interpret mode) and the hybrid terms with the batched-Cholesky
    gate or the Newton-Schulz gate, on the masks of
    test_build_update_terms_matches_jax: the same gate decisions (A and c
    sum over the tracks that pass)."""
    s, tri = pre_update
    s = s.replace(tracks=tri.tracks)
    caps = {**CAPS, **overrides}
    cfg, jcfg = mt.reference_experiment_config(**caps), jax_config(**caps)
    valid = tri.valid if which == "triage-valid" else s.tracks.valid
    got = build_update_terms(cfg, s, valid)
    want = _jax_terms(jcfg, mt.state_to_numpy(s), valid.numpy())
    assert int(got.n_gate_rejected) == int(want.n_gate_rejected)
    assert int(got.n_overflow) == int(want.n_overflow)
    assert bool(got.any_pass) == bool(want.any_pass)
    if which == "all-tracks":
        assert int(got.n_overflow) > 0 and int(got.n_gate_rejected) > 0
    _close(got.A.numpy(), np.asarray(want.A))
    _close(got.c.numpy(), np.asarray(want.c))
