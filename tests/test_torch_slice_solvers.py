"""The sequence loop of the PyTorch port under the gain solvers, the
Gauss-Newton triangulation and the XLA-only forms, against the JAX package.

``run_sequence`` over the first 450 ticks of the synthetic circle at
tests/test_gain_solver.py's capacities, on the CPU in float64, for
``gain_solver`` "ns" and "chol", ``triangulation="gn"`` and
``use_pallas=False``: the port against the JAX package's CPU lane (which
runs no Pallas kernel, so the port runs the plain triage where the JAX
lane does). Rejection and overflow counters and the per-tick camera and
track counts are exact; p, v and R are held to 1e-7 and sigma to rtol
1e-4, tests/test_parity.py's tolerances.

Then the batched float32 chain: ``batched_run_sequence`` over two seeds,
300 ticks, ``dtype="float32"`` with ``correction_dtype="float32"``, with
``batched_solver`` "ns" (the Newton-Schulz rule of ``gain_solve``) and
"lu". The two packages' bf16 products round differently on the CPU, so the
port's ns-to-lu gap is held to the JAX package's own gap between the same
two runs.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.parallel import batched as jbatched

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(f_max=192, u_max=32, k_max=256, desc_dim=16)
T = 450
TICK_FIELDS = ("R_WI", "p_WI", "v_WI", "sigma_rot", "sigma_pos", "n_cams", "n_tracks")
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")
# the JAX package's CPU lane runs no Pallas kernel: its triage is the plain
# line intersection, which the port then runs too (ROADMAP §3: the two
# triage paths differ); "gn" and use_pallas=False turn the triage kernel off
VARIANTS = {
    "ns": dict(gain_solver="ns", use_pallas_triage=False),
    "chol": dict(gain_solver="chol", use_pallas_triage=False),
    "gn": dict(triangulation="gn"),
    "xla": dict(use_pallas=False),
}



def _flatten(prefix_out, frame_out):
    pv = np.asarray(prefix_out.valid)
    fv = np.asarray(frame_out.valid).reshape(-1)
    res = {}
    for name in TICK_FIELDS:
        a = np.asarray(getattr(prefix_out, name))
        b = np.asarray(getattr(frame_out, name))
        res[name] = np.concatenate([a[pv], b.reshape((-1,) + b.shape[2:])[fv]])
    return res


def _counters(final, b=None):
    return {k: int(getattr(final.diag, k) if b is None else getattr(final.diag, k)[b])
            for k in COUNTERS}


def _seq_b(out, b):
    return type(out)(*(x[b] for x in out))


def _stream(build, cfg, seq, T):
    return build(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                 seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)


def _jax_run(overrides):
    cfg = jx.reference_experiment_config(dtype="float64", correction_dtype="", **CAPS,
                                         **overrides)
    std = jax_to_device(_stream(jax_build_stream, cfg, jax_circle(rng=np.random.default_rng(0)),
                                T), cfg)
    final, pre, fr = jax.jit(functools.partial(jx.run_sequence, cfg))(
        jx.make_initial_state(cfg, std.R_init), std.prefix, std.frames)
    return _counters(final), _flatten(pre, fr)


def _port_run(overrides, stats=None):
    cfg = mt.reference_experiment_config(dtype="float64", correction_dtype="", **CAPS,
                                         **overrides)
    std = to_device(_stream(build_stream, cfg,
                            generate_circle_sequence(rng=np.random.default_rng(0)), T),
                    cfg, device="cpu")
    final, pre, fr = mt.run_sequence(cfg, mt.make_initial_state(cfg, std.R_init, device="cpu"),
                                     std.prefix, std.frames, device="cpu", stats=stats)
    return _counters(final), _flatten(pre, fr)


@pytest.fixture(scope="module")
def runs():
    """One JAX run and one port run per variant (and the port's LU run for
    the host-sync count), computed once for the module."""
    out = {}
    for name, overrides in VARIANTS.items():
        stats = mt.FrameStats()
        out[name] = (_jax_run({k: v for k, v in overrides.items()
                               if k != "use_pallas_triage"}),
                     _port_run(overrides, stats), stats)
    stats = mt.FrameStats()
    _port_run(VARIANTS["ns"] | {"gain_solver": "lu"}, stats)
    out["lu"] = (None, None, stats)
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sequence_matches_jax(runs, variant):
    (jc, jo), (pc, po), _ = runs[variant]
    assert po["p_WI"].shape[0] == jo["p_WI"].shape[0] == T
    assert pc == jc
    assert jc["n_epipolar_rejected"] > 0 and jc["n_gating_rejected"] > 0
    np.testing.assert_array_equal(po["n_cams"], jo["n_cams"])
    np.testing.assert_array_equal(po["n_tracks"], jo["n_tracks"])
    for name in ("p_WI", "v_WI", "R_WI"):
        np.testing.assert_allclose(po[name], jo[name], atol=1e-7, err_msg=name)
    for name in ("sigma_pos", "sigma_rot"):
        np.testing.assert_allclose(po[name], jo[name], rtol=1e-4, atol=1e-16, err_msg=name)


def test_solvers_add_no_host_sync(runs):
    """The residual gates are selects: lu, ns and chol read the host
    equally often, once per counted branch of the loop."""
    counts = {name: (runs[name][2].host_syncs, runs[name][2].frames)
              for name in ("lu", "ns", "chol")}
    assert len(set(counts.values())) == 1, counts
    st = runs["lu"][2]
    assert st.host_syncs == st.frames + st.camera_steps + st.prunes


# --- the batched float32 chain ----------------------------------------------

SEEDS = (0, 1)
TB = 300
BCAPS = dict(CAPS, dtype="float32", correction_dtype="float32")


def _jax_batched(solver):
    cfg = jx.reference_experiment_config(**BCAPS, batched_solver=solver)
    sts = [jax_to_device(_stream(jax_build_stream, cfg, jax_circle(rng=np.random.default_rng(s)),
                                 TB), cfg) for s in SEEDS]
    prefix = {k: jnp.stack([s.prefix[k] for s in sts]) for k in sts[0].prefix}
    frames = {k: jnp.stack([s.frames[k] for s in sts]) for k in sts[0].frames}
    states = jbatched.batched_initial_state(cfg, len(SEEDS), jnp.stack([s.R_init for s in sts]))
    final, pre, fr = jax.jit(lambda s, p, f: jbatched.batched_run_sequence(cfg, s, p, f))(
        states, prefix, frames)
    return [(_counters(final, b), _flatten(_seq_b(pre, b), _seq_b(fr, b)))
            for b in range(len(SEEDS))]


def _port_batched(solver):
    cfg = mt.reference_experiment_config(**BCAPS, batched_solver=solver)
    std = to_device(mt.circle_streams(cfg, SEEDS, max_ticks=TB), cfg, device="cpu")
    stats = mt.FrameStats()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # functorch warns where it loops per sequence
        final, pre, fr = mt.batched_run_sequence(
            cfg, mt.batched_initial_state(cfg, len(SEEDS), std.R_init, device="cpu"),
            std.prefix, std.frames, device="cpu", stats=stats)
    assert stats.host_syncs == 0
    return [(_counters(final, b), _flatten(_seq_b(pre, b), _seq_b(fr, b)))
            for b in range(len(SEEDS))]


def test_batched_float32_chain_ns_against_lu():
    """Per sequence, the port's position gap between its ns and lu runs is
    at most twice the JAX package's gap between its own two (or 1e-5 m),
    and the port's two runs take the same discrete decisions wherever the
    JAX package's two do. The rule keeps its Newton-Schulz answer on these
    systems (batch residual ~1e-7), so the two runs are not the same bits."""
    jns, jlu = _jax_batched("ns"), _jax_batched("lu")
    pns, plu = _port_batched("ns"), _port_batched("lu")
    for b in range(len(SEEDS)):
        assert pns[b][1]["p_WI"].shape[0] == TB
        jgap = np.abs(jns[b][1]["p_WI"] - jlu[b][1]["p_WI"]).max()
        pgap = np.abs(pns[b][1]["p_WI"] - plu[b][1]["p_WI"]).max()
        assert pgap <= max(2 * jgap, 1e-5), (b, pgap, jgap)
        if jns[b][0] == jlu[b][0]:
            assert pns[b][0] == plu[b][0]
        for name in ("n_cams", "n_tracks"):
            agree = jns[b][1][name] == jlu[b][1][name]
            np.testing.assert_array_equal(pns[b][1][name][agree], plu[b][1][name][agree])
        assert np.isfinite(pns[b][1]["p_WI"]).all()
    assert any(not np.array_equal(pns[b][1][f], plu[b][1][f])
               for b in range(len(SEEDS)) for f in TICK_FIELDS)
