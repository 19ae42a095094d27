"""The port's batched multi-sequence path (``parallel/batched.py``), its
Newton-Schulz gate and its masked prune against the JAX package, on the
CPU in float64.

Small capacities (a window of three cameras, so the prune runs on most
frames) and 200 ticks of the circle for three seeds (which differ in noise,
world points and keypoints): ``batched_run_sequence`` against the JAX
package's (``jax.vmap`` of its sequence scan, default dispatch: the NS gate,
no triage kernel), and each sequence against the port's single
``run_sequence`` under the dispatched configuration. Counters and per-tick
camera and track counts are exact; trajectories are held to
tests/test_parity.py's tolerances against JAX and to 1e-9 against the
port's own single run (the same arithmetic on batched tensors).
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.ops.solve import _ns_inverse as jax_ns_inverse
from msckf_tpu.parallel import batched as jbatched

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import to_device
from msckf_tpu_torch.filter.update import _cholesky_gamma, _ns_gamma
from msckf_tpu_torch.ops import kernels as K

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=128, u_max=16, k_max=128, m_max=6, n_cam_slots=6,
            max_camera_states=3, min_parallax_deg=20.0, desc_dim=10)
SEEDS = (0, 1, 2)
N_POINTS = 100
T = 200
TICK_FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _flatten(prefix_out, frame_out):
    pv = np.asarray(prefix_out.valid)
    fv = np.asarray(frame_out.valid).reshape(-1)
    res = {}
    for name in TICK_FIELDS:
        a = np.asarray(getattr(prefix_out, name))
        b = np.asarray(getattr(frame_out, name))
        res[name] = np.concatenate([a[pv], b.reshape((-1,) + b.shape[2:])[fv]])
    return res


def _seq_b(out, b):
    return type(out)(*(x[b] for x in out))


def _counters(final, b=None):
    return {k: int(getattr(final.diag, k) if b is None else getattr(final.diag, k)[b])
            for k in COUNTERS}


def _assert_same_run(got, want, atol, rtol_sigma):
    (gc, go), (wc, wo) = got, want
    assert gc == wc
    np.testing.assert_array_equal(go["n_cams"], wo["n_cams"])
    np.testing.assert_array_equal(go["n_tracks"], wo["n_tracks"])
    for f in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(go[f], wo[f], atol=atol, err_msg=f)
    for f in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(go[f], wo[f], rtol=rtol_sigma, atol=1e-16, err_msg=f)


# --- batched_dispatch -----------------------------------------------------


@pytest.mark.parametrize("overrides", [
    {}, {"update_kernel": "fused"}, {"gating_solver": "xla", "use_pallas_triage": False},
    {"dtype": "float32", "correction_dtype": "compensated"},
], ids=["default", "fused", "xla-gate", "compensated"])
def test_batched_dispatch_matches_jax(overrides):
    got = mt.batched_dispatch(mt.reference_experiment_config(**overrides))
    want = jbatched.batched_dispatch(jx.reference_experiment_config(**overrides))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_batched_dispatch_keeps_a_set_gating_ns_iters():
    """The JAX package writes 12 over any ``gating_ns_iters`` (ROADMAP §3);
    the port only over the default, and agrees on every other field."""
    got = mt.batched_dispatch(mt.reference_experiment_config(gating_ns_iters=20))
    want = jbatched.batched_dispatch(jx.reference_experiment_config(gating_ns_iters=20))
    assert got.gating_solver == want.gating_solver == "ns"
    assert (got.gating_ns_iters, want.gating_ns_iters) == (20, 12)
    for f in dataclasses.fields(got):
        if f.name != "gating_ns_iters":
            assert getattr(got, f.name) == getattr(want, f.name), f.name


# --- the Newton-Schulz gate -----------------------------------------------


def _jax_ns_gamma(S, r, iters):
    """The JAX package's NS gate, msckf_tpu/filter/update.py:377-386."""
    d_inv = jax.lax.rsqrt(jnp.diagonal(S, axis1=-2, axis2=-1))
    Sh = S * (d_inv[..., :, None] * d_inv[..., None, :])
    rh = r * d_inv
    Xs = jax_ns_inverse(Sh, iters=iters, lowp_storage=True)
    x = jnp.einsum("urs,us->ur", Xs, rh)
    for _ in range(2):
        x = x + jnp.einsum("urs,us->ur", Xs, rh - jnp.einsum("urs,us->ur", Sh, x))
    return jnp.sum(rh * x, axis=-1)


def _gate_systems(rng, U=24, n=12, sigma2=0.01):
    """S = sigma^2 I + H P H^T with per-row scales over two decades (the
    observation depths the Jacobi scaling removes) and a few padding rows,
    and residuals around the chi-square threshold."""
    from scipy.stats import chi2

    S = np.zeros((U, n, n))
    r = np.zeros((U, n))
    k = rng.integers(4, n + 1, U)
    for u in range(U):
        H = rng.normal(size=(k[u], 3 * k[u])) * np.logspace(0, 2, k[u])[:, None]
        S[u, :k[u], :k[u]] = H @ H.T * 1e-3
        r[u, :k[u]] = rng.normal(size=k[u]) * np.sqrt(np.diag(S[u])[:k[u]] + sigma2) \
            * rng.uniform(0.6, 1.6)
    S += sigma2 * np.eye(n)
    return S, r, chi2.ppf(0.95, np.maximum(k - 3, 1)), sigma2


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9), ("float32", 2e-3)])
def test_ns_gate_matches_jax(dtype, rtol):
    """gamma by the port's NS gate against the JAX package's (12 iterations,
    bf16 storage in the early ones) and against a Cholesky solve: in float64
    the two float steps and two polish steps put gamma at the float64 floor
    whatever the bf16 rounding; in float32 the packages' bf16 and float32
    roundings differ, so gamma is held to 2e-3 and the decisions must be
    equal on these systems (none lies that close to its threshold)."""
    S, r, crit, sigma2 = _gate_systems(np.random.default_rng(0))
    jd = jnp.float64 if dtype == "float64" else jnp.float32
    want = np.asarray(_jax_ns_gamma(jnp.asarray(S, jd), jnp.asarray(r, jd), 12))
    St, rt = (torch.as_tensor(x, dtype=getattr(torch, dtype)) for x in (S, r))
    got = _ns_gamma(St, rt, 12, sigma2).numpy()
    chol = _cholesky_gamma(St.double(), rt.double()).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol)
    np.testing.assert_allclose(got, chol, rtol=rtol)
    np.testing.assert_array_equal(got <= crit, want <= crit)
    assert 0 < (got <= crit).sum() < len(crit)


def test_ns_gate_clamps_the_diagonal():
    """diag(S) is clamped at sigma^2 before the rsqrt (ROADMAP §3). The
    Jacobi scaling is exact for any positive diagonal, so where the clamp
    acts on an SPD S gamma does not move; and a padding row whose diagonal
    came out slightly negative (round-off), with a zero residual, no longer
    makes gamma NaN, as it does in the JAX package: gamma is the live
    rows' gamma."""
    S, r, _, sigma2 = _gate_systems(np.random.default_rng(1), U=4)
    S[:, -1, :] = S[:, :, -1] = 0.0
    r[:, -1] = 0.0
    S[:, -1, -1] = 0.5 * sigma2  # below sigma^2, still SPD
    St, rt = torch.as_tensor(S), torch.as_tensor(r)
    live = _cholesky_gamma(St[:, :-1, :-1], rt[:, :-1]).numpy()
    np.testing.assert_allclose(_ns_gamma(St, rt, 12, sigma2).numpy(), live, rtol=1e-9)
    S[:, -1, -1] = -1e-9 * sigma2
    assert np.isnan(np.asarray(_jax_ns_gamma(jnp.asarray(S), jnp.asarray(r), 12))).all()
    np.testing.assert_allclose(_ns_gamma(torch.as_tensor(S), rt, 12, sigma2).numpy(), live,
                               rtol=1e-9)


# --- the masked prune ------------------------------------------------------


def _jax_single(caps, seed):
    cfg = jx.reference_experiment_config(**caps)
    seq = jax_circle(rng=np.random.default_rng(seed), n_world_points=N_POINTS)
    std = jax_to_device(jax_build_stream(
        cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
        seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T), cfg)
    final, pre, fr = jax.jit(functools.partial(jx.run_sequence, cfg))(
        jx.make_initial_state(cfg, std.R_init), std.prefix, std.frames)
    return (_counters(final), _flatten(pre, fr)), final


def _port_single(cfg, std, b, assume_camera=False, stats=None):
    state = mt.make_initial_state(cfg, std.R_init[b], device="cpu")
    final, pre, fr = mt.run_sequence(
        cfg, state, {k: v[b] for k, v in std.prefix.items()},
        {k: v[b] for k, v in std.frames.items()}, assume_camera=assume_camera,
        device="cpu", stats=stats)
    return (_counters(final), _flatten(pre, fr)), final


def test_masked_prune_matches_jax():
    """``prune_path="masked"`` against the JAX package's over a saturating
    sequence, and against the port's cond form, as tests/test_prune_masked.py
    holds the JAX package's two forms: counts exact, p and P to 1e-9. With
    ``assume_camera`` the masked loop reads nothing on the host."""
    caps = {**CAPS, "prune_path": "masked"}
    cfg = mt.reference_experiment_config(**caps)
    std = to_device(mt.circle_streams(cfg, (1,), max_ticks=T, n_world_points=N_POINTS),
                    cfg, device="cpu")
    stats = mt.FrameStats()
    got, gfinal = _port_single(cfg, std, 0, assume_camera=True, stats=stats)
    want, wfinal = _jax_single(caps, 1)
    cond, cfinal = _port_single(mt.reference_experiment_config(**CAPS), std, 0)
    assert int(np.max(want[1]["n_cams"])) >= cfg.max_camera_states
    assert stats.host_syncs == 0 and int(stats.prunes) > 0 and int(stats.prune_updates) > 0
    for other, ofinal in ((want, wfinal), (cond, cfinal)):
        _assert_same_run(got, other, atol=1e-9, rtol_sigma=1e-9)
        np.testing.assert_allclose(gfinal.P.numpy(), np.asarray(ofinal.P), atol=1e-9)


# --- batched_run_sequence ---------------------------------------------------


def _port_batched(cfg, std, **kw):
    """The port's batched run, with each kernel op's plain version counted:
    its vmap rule runs it once per batched call."""
    calls = {}
    names = [f"{n}_plain" for n in K.LAUNCHES]
    originals = {n: getattr(K, n) for n in names}

    def counting(name):
        def f(*args):
            calls[name] = calls.get(name, 0) + 1
            return originals[name](*args)
        return f

    states = mt.batched_initial_state(cfg, len(SEEDS), std.R_init, device="cpu")
    stats = mt.FrameStats()
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("error")  # functorch warns where it loops per sequence
        for n in names:
            mp.setattr(K, n, counting(n))
        final, pre, fr = mt.batched_run_sequence(cfg, states, std.prefix, std.frames,
                                                 device="cpu", stats=stats, **kw)
    return final, pre, fr, stats, calls


@pytest.fixture(scope="module")
def default_runs():
    jcfg = jx.reference_experiment_config(**CAPS)
    sts = []
    for seed in SEEDS:
        seq = jax_circle(rng=np.random.default_rng(seed), n_world_points=N_POINTS)
        sts.append(jax_to_device(jax_build_stream(
            jcfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
            seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T), jcfg))
    prefix = {k: jnp.stack([s.prefix[k] for s in sts]) for k in sts[0].prefix}
    frames = {k: jnp.stack([s.frames[k] for s in sts]) for k in sts[0].frames}
    states = jbatched.batched_initial_state(jcfg, len(SEEDS), jnp.stack([s.R_init for s in sts]))
    jfinal, jpre, jfr = jax.jit(lambda s, p, f: jbatched.batched_run_sequence(jcfg, s, p, f))(
        states, prefix, frames)

    cfg = mt.reference_experiment_config(**CAPS)
    std = to_device(mt.circle_streams(cfg, SEEDS, max_ticks=T, n_world_points=N_POINTS),
                    cfg, device="cpu")
    return (jfinal, jpre, jfr), _port_batched(cfg, std), (cfg, std)


def test_batched_run_matches_jax(default_runs):
    (jfinal, jpre, jfr), (final, pre, fr, stats, calls), (cfg, std) = default_runs
    C = std.frames["imu_ts"].shape[1]
    for b in range(len(SEEDS)):
        got = (_counters(final, b), _flatten(_seq_b(pre, b), _seq_b(fr, b)))
        want = (_counters(jfinal, b), _flatten(_seq_b(jpre, b), _seq_b(jfr, b)))
        assert got[1]["p_WI"].shape[0] == T
        _assert_same_run(got, want, atol=1e-7, rtol_sigma=1e-4)
    assert sum(int(jfinal.diag.n_gating_rejected[b]) for b in range(len(SEEDS))) > 0
    # no host sync; per-sequence counts as device tensors
    assert stats.host_syncs == 0 and stats.frames == C
    assert stats.camera_steps.tolist() == [C] * len(SEEDS)
    assert (stats.prunes > 0).all() and int(stats.prune_updates.sum()) > 0
    # the dispatch's path: no triage kernel, the NS gate; each kernel op's
    # vmap rule ran its plain version once per batched call
    assert calls == {"verification_scores_plain": C, "propagate_block_fused_plain": C,
                     "p15_recurrence_fused_plain": C + 1}


def test_batched_run_matches_single_runs(default_runs):
    _, (final, pre, fr, _, _), (cfg, std) = default_runs
    dcfg = mt.batched_dispatch(cfg)
    for b in range(len(SEEDS)):
        want, _ = _port_single(dcfg, std, b)
        got = (_counters(final, b), _flatten(_seq_b(pre, b), _seq_b(fr, b)))
        _assert_same_run(got, want, atol=1e-9, rtol_sigma=1e-9)


@pytest.mark.parametrize("overrides", [{}, {"update_kernel": "fused"}],
                         ids=["triage-and-gating-kernels", "fused"])
def test_batched_kernel_paths_match_single_runs(overrides):
    """``dispatch_auto=False``: the triage kernel and the gating kernel (or
    the fused update terms) in the loop. Under vmap every branch runs, so
    per frame the triage runs twice (camera step and prune) and so does the
    update; each op's rule runs its plain version once per call for the
    whole batch, and each sequence equals the port's single run."""
    cfg = mt.reference_experiment_config(**CAPS, **overrides)
    std = to_device(mt.circle_streams(cfg, SEEDS, max_ticks=100, n_world_points=N_POINTS),
                    cfg, device="cpu")
    C = std.frames["imu_ts"].shape[1]
    final, pre, fr, stats, calls = _port_batched(cfg, std, dispatch_auto=False,
                                                 assume_camera=True)
    want = {"verification_scores_plain": C, "propagate_block_fused_plain": C,
            "p15_recurrence_fused_plain": C + 1, "triage_refresh_fused_plain": 2 * C,
            "batched_gating_gamma_plain": 2 * C}  # the fused plain version gates by it too
    if overrides:
        want["update_terms_fused_plain"] = 2 * C
    assert calls == want
    assert stats.host_syncs == 0 and (stats.prunes > 0).all()
    for b in range(len(SEEDS)):
        want, _ = _port_single(cfg, std, b, assume_camera=True)
        got = (_counters(final, b), _flatten(_seq_b(pre, b), _seq_b(fr, b)))
        _assert_same_run(got, want, atol=1e-9, rtol_sigma=1e-9)


def test_batched_frame_step_matches_frame_step():
    """One frame block for a batch of identical filters equals the single
    frame step (the JAX package's test_batched_matches_single)."""
    cfg = mt.reference_experiment_config(**CAPS)
    std = to_device(mt.circle_streams(cfg, (0,), max_ticks=60, n_world_points=N_POINTS),
                    cfg, device="cpu")
    state = mt.make_initial_state(cfg, std.R_init[0], device="cpu")
    frame = {k: v[0, 0] for k, v in std.frames.items()}
    single, out = mt.frame_step(cfg, state, frame)
    states = mt.batched_initial_state(cfg, 4, std.R_init[0], device="cpu")
    frames = {k: v.expand(4, *v.shape) for k, v in frame.items()}
    batched, bout = mt.batched_frame_step(cfg, states, frames, dispatch_auto=False,
                                          device="cpu")
    for b in range(4):
        np.testing.assert_allclose(batched.imu.p_WI[b].numpy(), single.imu.p_WI.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(batched.P[b].numpy(), single.P.numpy(), atol=1e-12)
        np.testing.assert_array_equal(bout.n_tracks[b].numpy(), out.n_tracks.numpy())
