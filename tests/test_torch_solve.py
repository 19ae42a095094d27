"""The port's gain solves (``msckf_tpu_torch/ops/solve.py``) and their
wiring into ``_correction_terms`` against the JAX package's
(``msckf_tpu/ops/solve.py``), on the CPU.

Mirrors tests/test_gain_solver.py (``ns_solve_direct``, ``chol_gain_solve``,
``gain_solver`` in the correction chain) and tests/test_solve.py
(``gain_solve`` unbatched and under vmap), on the same seeded systems. The
residual gates are built to lie well inside or well outside their 1e-4
tolerance, so both packages take the same branch. In float64 the two
float iterations and the polish step put every Newton-Schulz answer at the
float64 floor whatever the bf16 rounding, so the port is held to JAX at
1e-12; in float32 the packages' bf16 and float32 products round
differently on the CPU, and the port is held to the float64 truth at the
JAX tests' own bounds and to JAX at 1e-5 of the answer's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_tpu.config import reference_experiment_config as jax_config
from msckf_tpu.filter.update import _correction_terms as jax_correction_terms
from msckf_tpu.ops import solve as js

import msckf_tpu_torch as mt
from msckf_tpu_torch.filter.update import _correction_terms
from msckf_tpu_torch.ops import solve as ts

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(f_max=32, u_max=8, k_max=32, desc_dim=8, m_max=6, n_cam_slots=6,
             max_camera_states=3)



def _system(rng, D=64, cond=1e3, rank=40):
    """tests/test_gain_solver.py's system: P SPD of the given condition,
    A = H^T H PSD (float64 numpy)."""
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    eigs = np.logspace(0, -np.log10(cond), D)
    P = (Q * eigs) @ Q.T
    H = rng.standard_normal((rank, D)) / np.sqrt(rank)
    return P, H.T @ H


def _filter_system(rng, D, gain_scale):
    """tests/test_solve.py's system: Bt = sigma^2 I + s P A, float32."""
    H = rng.standard_normal((40, D)).astype(np.float32)
    A = (H.T @ H).astype(np.float32)
    P = rng.standard_normal((D, D)).astype(np.float32)
    P = (P @ P.T + np.eye(D)).astype(np.float32)
    sigma2 = 0.01
    s = gain_scale * sigma2 / np.abs(P @ A).max()
    Bt = (sigma2 * np.eye(D) + s * (P @ A)).astype(np.float32)
    return Bt, P


def _hard_systems(rng, D=87, B=3):
    """tests/test_solve.py's hopeless systems, cond(Bt) > 1e5."""
    A = rng.standard_normal((B, D, D)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    P = rng.standard_normal((B, D, D)).astype(np.float32)
    P = P @ np.swapaxes(P, 1, 2)
    Bt = (1e-4 * np.eye(D) + P @ A).astype(np.float32)
    assert np.linalg.cond(Bt.astype(np.float64)).min() > 1e5
    return Bt, P


def _np_dtype(name):
    return np.float64 if name == "float64" else np.float32


def _lu(Bt, P):
    return torch.linalg.solve_ex(Bt, P, check_errors=False).result


# --- ns_solve_direct and chol_gain_solve (tests/test_gain_solver.py) --------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ns_solve_direct_matches_jax(dtype):
    P, A = _system(np.random.default_rng(0), cond=1e3)
    nd = _np_dtype(dtype)
    P, A = P.astype(nd), A.astype(nd)
    Bt = (1.5 * np.eye(P.shape[0]) + P @ A).astype(nd)
    got = ts.ns_solve_direct(torch.as_tensor(Bt), torch.as_tensor(P), iters=12).numpy()
    want = np.asarray(jax.jit(js.ns_solve_direct, static_argnames="iters")(
        jnp.asarray(Bt), jnp.asarray(P), iters=12))
    truth = np.linalg.solve(Bt.astype(np.float64), P.astype(np.float64))
    scale = np.abs(truth).max()
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    else:
        assert np.abs(got - truth).max() / scale < 1e-5
        assert np.abs(got - want).max() / scale < 1e-5
    # the Newton-Schulz answer, not the fallback: it differs from the LU
    assert not np.array_equal(got, _lu(torch.as_tensor(Bt), torch.as_tensor(P)).numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chol_gain_solve_matches_jax(dtype):
    P, A = _system(np.random.default_rng(0), cond=1e3)
    nd = _np_dtype(dtype)
    P, A = P.astype(nd), A.astype(nd)
    got = ts.chol_gain_solve(torch.as_tensor(P), torch.as_tensor(A), 1.5).numpy()
    want = np.asarray(jax.jit(js.chol_gain_solve)(jnp.asarray(P), jnp.asarray(A),
                                                  jnp.asarray(1.5, nd)))
    P64, A64 = P.astype(np.float64), A.astype(np.float64)
    truth = P64 @ np.linalg.inv(1.5 * np.eye(P.shape[0]) + A64 @ P64)
    scale = np.abs(truth).max()
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-11 * scale)
    else:
        # through M = P B, cond ~5e3: forward error ~ eps cond(M) ~ 6e-4
        assert np.abs(got - truth).max() / scale < 2e-3
        assert np.abs(got - want).max() / scale < 2e-3


def test_ns_residual_gate_falls_back_to_lu():
    """One Newton-Schulz step on a cond-1e3 system cannot meet the 1e-4
    gate, so the answer is the LU's, bit for bit (in both packages)."""
    P, A = _system(np.random.default_rng(1), cond=1e3)
    P, A = P.astype(np.float32), A.astype(np.float32)
    Bt = (np.float32(1e-3) * np.eye(P.shape[0], dtype=np.float32) + P @ A).astype(np.float32)
    Btt, Pt = torch.as_tensor(Bt), torch.as_tensor(P)
    np.testing.assert_array_equal(ts.ns_solve_direct(Btt, Pt, iters=1).numpy(),
                                  _lu(Btt, Pt).numpy())
    np.testing.assert_array_equal(np.asarray(js.ns_solve_direct(jnp.asarray(Bt), jnp.asarray(P),
                                                                iters=1)),
                                  np.asarray(jnp.linalg.solve(jnp.asarray(Bt), jnp.asarray(P))))


def test_chol_gate_keeps_ill_conditioned_finite():
    """cond(P) ~ 1e8 puts M = sigma^2 P + P A P at the float32 limit of
    positive definiteness: the answer is finite and agrees with the LU
    through the gate (its own or the fallback)."""
    P, A = _system(np.random.default_rng(2), cond=1e8)
    P, A = P.astype(np.float32), A.astype(np.float32)
    Pt, At = torch.as_tensor(P), torch.as_tensor(A)
    got = ts.chol_gain_solve(Pt, At, 1.5).numpy()
    Bt = 1.5 * torch.eye(P.shape[0]) + Pt @ At
    lu = _lu(Bt, Pt).numpy().T
    assert np.isfinite(got).all()
    assert np.abs(got - lu).max() / np.abs(lu).max() < 1e-2


def test_chol_not_positive_definite_takes_the_lu():
    """A factor that fails (info != 0) makes the candidate NaN, so the gate
    takes the LU, bit for bit, as the JAX package's NaN factor does. P has
    a negative eigenvalue and A is small, so M = sigma^2 P + P A P is
    indefinite while B^T = sigma^2 I + P A is well conditioned."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((24, 24)))
    P = (Q * np.linspace(1.0, -0.5, 24)) @ Q.T
    H = rng.standard_normal((10, 24)) * 1e-3
    A = H.T @ H
    Pt, At = torch.as_tensor(P), torch.as_tensor(A)
    assert int(torch.linalg.cholesky_ex(1.5 * Pt + Pt @ At @ Pt).info) != 0
    got = ts.chol_gain_solve(Pt, At, 1.5).numpy()
    lu = _lu(1.5 * torch.eye(24, dtype=torch.float64) + Pt @ At, Pt).numpy().T
    np.testing.assert_array_equal(got, lu)
    want = np.asarray(js.chol_gain_solve(jnp.asarray(P), jnp.asarray(A), 1.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# --- gain_solve (tests/test_solve.py) ---------------------------------------


def test_unbatched_gain_solve_is_lu():
    Bt, P = _filter_system(np.random.default_rng(0), 63, 0.3)
    Btt, Pt = torch.as_tensor(Bt), torch.as_tensor(P)
    np.testing.assert_array_equal(ts.gain_solve(Btt, Pt).numpy(), _lu(Btt, Pt).numpy())
    want = np.asarray(jax.jit(js.gain_solve)(jnp.asarray(Bt), jnp.asarray(P)))
    np.testing.assert_allclose(ts.gain_solve(Btt, Pt).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_vmap_gain_solve_matches_jax_on_realistic_systems():
    rng = np.random.default_rng(1)
    systems = [_filter_system(rng, 87, s) for s in (0.1, 0.5, 2.0)]
    Bt = np.stack([b for b, _ in systems])
    P = np.stack([p for _, p in systems])
    Btt, Pt = torch.as_tensor(Bt), torch.as_tensor(P)
    got = torch.func.vmap(ts.gain_solve)(Btt, Pt).numpy()
    want = np.asarray(jax.jit(jax.vmap(js.gain_solve))(jnp.asarray(Bt), jnp.asarray(P)))
    truth = np.linalg.solve(Bt.astype(np.float64), P.astype(np.float64))
    scale = np.abs(truth).max()
    assert np.abs(got - truth).max() / scale < 1e-5
    assert np.abs(got - want).max() / scale < 1e-5
    # the rule's Newton-Schulz answer, not the batched LU
    assert not np.array_equal(got, _lu(Btt, Pt).numpy())


def test_vmap_gain_solve_with_one_hard_system_is_the_batched_lu():
    """One residual for the whole batch: a single hopeless system sends
    every system of the batch to the batched LU, bit for bit."""
    rng = np.random.default_rng(2)
    easy = [_filter_system(rng, 87, s) for s in (0.1, 0.5)]
    hard_Bt, hard_P = _hard_systems(rng, B=1)
    Bt = np.concatenate([np.stack([b for b, _ in easy]), hard_Bt])
    P = np.concatenate([np.stack([p for _, p in easy]), hard_P])
    Btt, Pt = torch.as_tensor(Bt), torch.as_tensor(P)
    got = torch.func.vmap(ts.gain_solve)(Btt, Pt).numpy()
    np.testing.assert_array_equal(got, _lu(Btt, Pt).numpy())
    want = np.asarray(jax.jit(jax.vmap(js.gain_solve))(jnp.asarray(Bt), jnp.asarray(P)))
    np.testing.assert_array_equal(want, np.asarray(jnp.linalg.solve(jnp.asarray(Bt),
                                                                    jnp.asarray(P))))
    # the two packages' LUs agree to ~eps cond(Bt): compare the easy systems
    for b in range(len(easy)):
        np.testing.assert_allclose(got[b], want[b], rtol=0, atol=1e-5 * np.abs(want[b]).max())


def test_vmap_gain_solve_broadcasts_an_unbatched_argument():
    """An unbatched right-hand side is broadcast to the batch (JAX :112-115)."""
    rng = np.random.default_rng(4)
    systems = [_filter_system(rng, 40, s) for s in (0.1, 0.3)]
    Bt = torch.as_tensor(np.stack([b for b, _ in systems]))
    P = torch.as_tensor(systems[0][1])
    got = torch.func.vmap(ts.gain_solve, in_dims=(0, None))(Bt, P)
    want = np.asarray(jax.vmap(js.gain_solve, in_axes=(0, None))(jnp.asarray(Bt.numpy()),
                                                                 jnp.asarray(P.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_vmap_ns_solve_direct_gates_each_system():
    """Under vmap the residual gate of ``ns_solve_direct`` is a select per
    system, as jax.vmap makes of its cond: the hard system takes the LU,
    the realistic one keeps its Newton-Schulz answer."""
    rng = np.random.default_rng(5)
    eBt, eP = _filter_system(rng, 87, 0.5)
    hBt, hP = _hard_systems(rng, B=1)
    Bt = torch.as_tensor(np.stack([eBt, hBt[0]]))
    P = torch.as_tensor(np.stack([eP, hP[0]]))
    got = torch.func.vmap(ts.ns_solve_direct)(Bt, P).numpy()
    lu = _lu(Bt, P).numpy()
    np.testing.assert_array_equal(got[1], lu[1])
    assert not np.array_equal(got[0], lu[0])
    want = np.asarray(jax.vmap(js.ns_solve_direct)(jnp.asarray(Bt.numpy()),
                                                   jnp.asarray(P.numpy())))
    np.testing.assert_array_equal(want[1], np.asarray(jnp.linalg.solve(jnp.asarray(hBt[0]),
                                                                       jnp.asarray(hP[0]))))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5 * np.abs(want[0]).max())


# --- the correction chain ----------------------------------------------------


def _chain_inputs(rng, D, B=None, dtype=np.float64):
    shape = (B,) if B else ()
    H = rng.standard_normal(shape + (30, D)) * 0.5
    A = np.einsum("...ri,...rj->...ij", H, H)
    P = rng.standard_normal(shape + (D, D)) * 0.05
    P = P @ np.swapaxes(P, -1, -2) + 0.01 * np.eye(D)
    c = rng.standard_normal(shape + (D,))
    return P.astype(dtype), A.astype(dtype), c.astype(dtype)


@pytest.mark.parametrize("solver", ["ns", "chol"])
def test_correction_terms_match_jax(solver):
    """``_correction_terms`` with ``gain_solver`` ns or chol, float64
    filter and plain chain (tests/test_gain_solver.py's ``correction_dtype=""``)."""
    caps = dict(SMALL, dtype="float64", correction_dtype="", gain_solver=solver)
    cfg, jcfg = mt.reference_experiment_config(**caps), jax_config(**caps)
    P, A, c = _chain_inputs(np.random.default_rng(6), cfg.err_dim)
    d, Pn = _correction_terms(cfg, *(torch.as_tensor(x) for x in (P, A, c)))
    jd, jPn = jax.jit(lambda p, a, cc: jax_correction_terms(jcfg, p, a, cc))(P, A, c)
    lu_d, lu_P = _correction_terms(mt.reference_experiment_config(**{**caps, "gain_solver": "lu"}),
                                   *(torch.as_tensor(x) for x in (P, A, c)))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Pn.numpy(), np.asarray(jPn), rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(d.numpy(), lu_d.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Pn.numpy(), lu_P.numpy(), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("a_scale", [0.5, 1e-3], ids=["fallback", "newton-schulz"])
def test_correction_terms_ns_matches_lu_under_vmap(a_scale):
    """tests/test_solve.py:68-92 in the port: the vmapped float32 chain with
    ``batched_solver`` ns (the rule) against lu, to float32 working
    accuracy. With that test's systems (H scaled by 0.5) B^T is too badly
    conditioned for 12 iterations and both packages fall back to the LU;
    with H scaled by 1e-3 both keep the Newton-Schulz answer, and the port
    is held to the JAX package's chain."""
    base = dict(dtype="float32", correction_dtype="none", f_max=32, u_max=8, k_max=32,
                desc_dim=8)
    cfg_ns = mt.reference_experiment_config(batched_solver="ns", **base)
    cfg_lu = mt.reference_experiment_config(batched_solver="lu", **base)
    D = cfg_ns.err_dim
    rng = np.random.default_rng(3)
    B = 4
    H = rng.standard_normal((B, 30, D)).astype(np.float32) * np.float32(a_scale)
    A = np.einsum("bri,brj->bij", H, H)
    P = rng.standard_normal((B, D, D)).astype(np.float32) * 0.05
    P = P @ np.swapaxes(P, 1, 2) + 0.01 * np.eye(D, dtype=np.float32)
    c = rng.standard_normal((B, D)).astype(np.float32)
    args = [torch.as_tensor(x) for x in (P, A, c)]
    d_ns, P_ns = torch.func.vmap(lambda p, a, cc: _correction_terms(cfg_ns, p, a, cc))(*args)
    d_lu, P_lu = torch.func.vmap(lambda p, a, cc: _correction_terms(cfg_lu, p, a, cc))(*args)
    np.testing.assert_allclose(d_ns.numpy(), d_lu.numpy(), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(P_ns.numpy(), P_lu.numpy(), rtol=2e-4, atol=1e-7)

    def jax_chain(solver):
        jcfg = jax_config(batched_solver=solver, **base)
        return jax.jit(jax.vmap(lambda p, a, cc: jax_correction_terms(jcfg, p, a, cc)))(P, A, c)

    (jd, jP), (jd_lu, _) = jax_chain("ns"), jax_chain("lu")
    # the same branch in both packages
    fell_back = np.array_equal(d_ns.numpy(), d_lu.numpy())
    assert fell_back == np.array_equal(np.asarray(jd), np.asarray(jd_lu)) == (a_scale == 0.5)
    if not fell_back:
        np.testing.assert_allclose(d_ns.numpy(), np.asarray(jd), rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(P_ns.numpy(), np.asarray(jP), rtol=2e-4, atol=1e-7)


def test_correction_dtype_none_is_the_plain_chain_and_compensated_raises():
    """Any ``correction_dtype`` but "float64" and "compensated" is the plain
    chain in the filter's type (the JAX package's tests pass "" and "none");
    "compensated" still raises, naming its ROADMAP item."""
    P, A, c = _chain_inputs(np.random.default_rng(7), 15 + 6 * SMALL["n_cam_slots"],
                            dtype=np.float32)
    args = [torch.as_tensor(x) for x in (P, A, c)]
    outs = {}
    for cd in ("none", "", "float32"):
        cfg = mt.reference_experiment_config(**SMALL, dtype="float32", correction_dtype=cd)
        outs[cd] = _correction_terms(cfg, *args)
        assert outs[cd][1].dtype == torch.float32
    for cd in ("", "float32"):
        for got, want in zip(outs[cd], outs["none"]):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    bad = mt.reference_experiment_config(**SMALL, correction_dtype="compensated")
    with pytest.raises(NotImplementedError, match="item 9"):
        _correction_terms(bad, *args)
