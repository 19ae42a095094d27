"""The port's double-word correction island (``msckf_tpu_torch/ops/
compensated.py`` and ``filter/update.py::_correction_terms_compensated``)
against float64 and against the JAX package's (``msckf_tpu/ops/
compensated.py``), on the CPU in float32.

Mirrors tests/test_compensated.py on the same seeded inputs, with its
bounds against float64:
* ``two_sum`` and ``two_prod``: hi + lo equal to the float64 sum and
  product exactly;
* ``_exact_pow2`` exact over [-126, 127];
* ``df_chunk``'s byte budget, and ``df_matmul``'s chunk under vmap;
* ``df_matmul`` and ``ozaki_matmul``: the JAX tests' bounds against float64
  (1e-11 and 1e-12 of the product's scale), and within 1e-11 of
  rowmax(A) * colmax(B) of the JAX functions' hi + lo (the dropped-term
  bound K 2^-46 is about 3e-12 at K = 207; the port sums the exact slice
  products in another order than the JAX package);
* ``refined_solve``, "lu" and "ns": under 1e-8 of float64 on both
  conditioning cases, "ns" the LU's solve bit for bit, under
  ``torch.func.vmap``, against the JAX package's (5e-11 of the answer's
  scale), the JAX package's order of residual products, and the divergence
  safeguard (never worse than 8x the plain float32 LU);
* the Ozaki slices on their grid, the zero-head case;
* the "ns" island where the JAX package's Newton-Schulz inverse diverges:
  the "lu" island's answer (ROADMAP.md §3);
* the correction chain at D = 207: within 1e-6 relative of the JAX island,
  within 1e-6 of the float64 chain and under 0.05x plain float32's error;
* 400 ticks of the circle with the small window (D = 87): within 5e-3 m of
  the port's own float64 island, and within 1e-4 m of the JAX package's
  compensated run at every tick, with equal counters (the two packages'
  float32 filters round differently outside the island: 6.1e-6 m seen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.filter.update import _correction_terms_compensated as jax_island
from msckf_tpu.ops import compensated as jdw
from msckf_tpu.ops.solve import _ns_inverse as jax_ns_inverse

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.update import _correction_terms, _correction_terms_compensated
from msckf_tpu_torch.ops import compensated as dw

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def _f64(r):
    """hi + lo of a port or JAX DF pair, in float64."""
    return np.asarray(r.hi, np.float64) + np.asarray(r.lo, np.float64)


def _scale(A, B):
    """rowmax(|A|) * colmax(|B|), the scheme's error scale."""
    return np.abs(A).max(axis=1)[:, None] * np.abs(B).max(axis=0)[None, :]


# jitted: one compile a signature beats eager JAX's one a primitive
_jax_ozaki = jax.jit(jdw.ozaki_matmul)
_jax_df_matmul = jax.jit(jdw.df_matmul)


def _against_jax(got, A, B, **lo):
    """Max of |port - JAX| / (rowmax * colmax) for ozaki_matmul."""
    want = _f64(_jax_ozaki(A, B, **lo))
    return float((np.abs(_f64(got) - want) / _scale(A, B)).max())


def test_two_sum_two_prod_exact():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096)).astype(np.float32)
    b = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096)).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(_f64(dw.two_sum(_t(a), _t(b))), a64 + b64)
    np.testing.assert_array_equal(_f64(dw.two_prod(_t(a), _t(b))), a64 * b64)


def test_exact_pow2_is_exact():
    e = torch.arange(-126, 128, dtype=torch.int32)
    got = dw._exact_pow2(e)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.double().numpy(), 2.0 ** np.arange(-126, 128.0))
    # integer-valued float exponents, as floor / round of log2 give them
    np.testing.assert_array_equal(dw._exact_pow2(e.float()).numpy(), got.numpy())
    # exponents read exactly at and around every power of two
    m = torch.tensor(2.0 ** np.arange(-126, 128.0), dtype=torch.float32)
    np.testing.assert_array_equal(dw._floor_log2(m).numpy(), np.arange(-126, 128))
    below = torch.nextafter(m[1:], torch.zeros_like(m[1:]))
    np.testing.assert_array_equal(dw._floor_log2(below).numpy(), np.arange(-126, 127))


def test_df_matmul_beats_f32_by_orders():
    rng = np.random.default_rng(1)
    n = 150
    A = rng.normal(size=(n, n)).astype(np.float32)
    B = rng.normal(size=(n, n)).astype(np.float32)
    want = A.astype(np.float64) @ B.astype(np.float64)
    got = dw.df_matmul(_t(A), _t(B))
    err_dw = np.abs(_f64(got) - want).max()
    err_f32 = np.abs((A @ B).astype(np.float64) - want).max()
    assert err_dw < 1e-11 * np.abs(want).max(), err_dw / np.abs(want).max()
    assert err_dw < 1e-4 * max(err_f32, 1e-30)
    jax_got = _f64(_jax_df_matmul(A, B))
    assert (np.abs(_f64(got) - jax_got) / _scale(A, B)).max() < 1e-11


def test_df_matmul_low_words_and_batch_axes():
    """Double-word operands and a leading batch axis: each batch member as
    its own call, and within the JAX test bound of the float64 product."""
    rng = np.random.default_rng(2)
    A64 = rng.normal(size=(3, 40, 70))
    B64 = rng.normal(size=(3, 70, 20))
    Ahi, Bhi = A64.astype(np.float32), B64.astype(np.float32)
    Alo, Blo = (A64 - Ahi).astype(np.float32), (B64 - Bhi).astype(np.float32)
    got = dw.df_matmul(_t(Ahi), _t(Bhi), A_lo=_t(Alo), B_lo=_t(Blo), chunk=32)
    want = A64 @ B64
    assert np.abs(_f64(got) - want).max() < 1e-11 * np.abs(want).max()
    for b in range(3):
        one = dw.df_matmul(_t(Ahi[b]), _t(Bhi[b]), A_lo=_t(Alo[b]), B_lo=_t(Blo[b]), chunk=32)
        np.testing.assert_array_equal(one.hi.numpy(), got.hi[b].numpy())
        np.testing.assert_array_equal(one.lo.numpy(), got.lo[b].numpy())


@pytest.mark.parametrize("batch, m, chunk", [
    ((), 207, 256),      # one filter-sized product: 44 MB of partial products
    ((2,), 207, 128),
    ((32,), 207, 64),    # the batched loop: the JAX package's chunk
    ((256,), 207, 64),   # never below 64
    ((32,), 1, 256),     # df_matvec
])
def test_df_chunk_fits_the_budget(batch, m, chunk):
    A, B = torch.zeros(*batch, 207, 207), torch.zeros(207, m)
    assert dw.df_chunk(A, B) == chunk
    assert chunk == 64 or np.prod(batch, dtype=int) * 207 * m * 4 * chunk <= dw.DF_CHUNK_BYTES


def test_df_matmul_chunk_under_vmap():
    """Under torch.func.vmap df_matmul picks its chunk for the whole batch
    (msckf::df_matmul's vmap rule): each member is the batched call's bit
    for bit, with a batched and a shared operand, and within 1e-13 of the
    product's scale of its own unbatched call (another chunk, so another
    order of the same exact adds)."""
    rng = np.random.default_rng(5)
    A64 = rng.normal(size=(3, 100, 207))
    B = _t(rng.normal(size=(207, 90)))
    Ahi = _t(A64)
    Alo = _t(A64 - A64.astype(np.float32))
    got = torch.func.vmap(lambda a, al: dw.df_matmul(a, B, A_lo=al))(Ahi, Alo)
    batched = dw.df_matmul(Ahi, B, A_lo=Alo)
    np.testing.assert_array_equal(got.hi.numpy(), batched.hi.numpy())
    np.testing.assert_array_equal(got.lo.numpy(), batched.lo.numpy())
    assert dw.df_chunk(Ahi, B) == 256 and dw.df_chunk(Ahi[0], B) == 256
    got = torch.func.vmap(lambda a, al: dw.df_matmul(a, B, A_lo=al, chunk=64))(Ahi, Alo)
    for b in range(3):
        one = _f64(dw.df_matmul(Ahi[b], B, A_lo=Alo[b]))
        assert np.abs(_f64(got)[b] - one).max() < 1e-13 * np.abs(one).max()


def test_ozaki_matmul_matches_df_accuracy():
    rng = np.random.default_rng(7)

    def err(r, want):
        return np.abs(_f64(r) - want).max() / np.abs(want).max()

    # plain float32, well-scaled
    A = rng.normal(size=(207, 207)).astype(np.float32)
    B = rng.normal(size=(207, 207)).astype(np.float32)
    got = dw.ozaki_matmul(_t(A), _t(B))
    assert err(got, A.astype(np.float64) @ B.astype(np.float64)) < 1e-12
    assert _against_jax(got, A, B) < 1e-11

    # scale-heterogeneous rows / columns (the filter-covariance kind)
    d1 = 10.0 ** rng.uniform(-6, 0, size=207)
    d2 = 10.0 ** rng.uniform(-6, 0, size=207)
    As = (A * d1[:, None]).astype(np.float32)
    Bs = (B * d2[None, :]).astype(np.float32)
    got = dw.ozaki_matmul(_t(As), _t(Bs))
    assert err(got, As.astype(np.float64) @ Bs.astype(np.float64)) < 1e-12
    assert _against_jax(got, As, Bs) < 1e-11

    # double-word operands (float64 split into hi / lo pairs)
    A64 = rng.normal(size=(200, 200))
    B64 = rng.normal(size=(200, 200))
    Ahi, Bhi = A64.astype(np.float32), B64.astype(np.float32)
    Alo, Blo = (A64 - Ahi).astype(np.float32), (B64 - Bhi).astype(np.float32)
    got = dw.ozaki_matmul(_t(Ahi), _t(Bhi), A_lo=_t(Alo), B_lo=_t(Blo))
    assert err(got, A64 @ B64) < 1e-12
    assert _against_jax(got, Ahi, Bhi, A_lo=Alo, B_lo=Blo) < 1e-11

    # K > 256 must refuse rather than lose the accumulation's exactness
    with pytest.raises(ValueError, match="K <= 256"):
        dw.ozaki_matmul(torch.zeros(4, 300), torch.zeros(300, 4))


def test_ozaki_zero_head_against_large_scale():
    """An information matrix with an all-zero 15-column IMU head against a
    1e18-scale covariance: the zero columns must not set the slicing grid."""
    rng = np.random.default_rng(5)
    D = 100
    G = rng.standard_normal((D, D))
    P = ((G @ G.T) * 1e18).astype(np.float32)
    H = rng.standard_normal((40, D))
    H[:, :15] = 0.0
    A = (H.T @ H).astype(np.float32)
    want = A.astype(np.float64) @ P.astype(np.float64)
    got = dw.ozaki_matmul(_t(A), _t(P))
    assert np.max(np.abs(_f64(got) - want)) / np.max(np.abs(want)) < 1e-10


def test_slices8_grid():
    """Each slice lies on its level's grid step_l = 2^(-6-8l), holds at most
    8 significant bits (bfloat16-exact), slice 1 is not empty, and the
    slices sum to the input within 2^-52."""
    rng = np.random.default_rng(3)
    x = _t(rng.uniform(-2, 2, (256,)))
    sl = dw._slices8(x, None, 6)
    for lvl, s in enumerate(sl):
        step = 2.0 ** (-6 - 8 * lvl)
        s64 = s.double().numpy()
        assert np.all(np.round(s64 / step) * step == s64), f"slice {lvl} off-grid"
        assert np.all(np.abs(s64) <= 256 * step), f"slice {lvl} past 8 bits"
        assert torch.equal(s.to(torch.bfloat16).float(), s), f"slice {lvl} not bf16-exact"
    assert torch.any(sl[1] != 0), "slice 1 empty: slicing collapsed"
    resid = x.double().numpy() - sum(s.double().numpy() for s in sl)
    assert np.max(np.abs(resid)) < 2.0 ** -52


def _solve_case(Bd, rng, solver, iters=3):
    X_true = rng.normal(size=(Bd.shape[0], 4))
    C = (Bd @ X_true).astype(np.float32)
    B32 = Bd.astype(np.float32)
    B = dw.DF(_t(B32), _t(Bd - B32))
    got = _f64(dw.refined_solve(B, _t(C), iters=iters, solver=solver))
    want = np.linalg.solve(Bd, C.astype(np.float64))
    rel = np.abs(got - want).max() / np.abs(want).max()
    x32 = np.linalg.solve(B32, C)
    rel32 = np.abs(x32.astype(np.float64) - want).max() / np.abs(want).max()
    return rel, rel32


@pytest.mark.parametrize("solver", ["lu", "ns"])
def test_refined_solve_scaling_ill_conditioned(solver):
    """Scale-heterogeneity conditioning (raw cond up to ~1e14): power-of-2
    equilibration makes the refined solve essentially exact."""
    rng = np.random.default_rng(2)
    n = 100
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    core = (Q * np.logspace(0, -2, n)) @ Q.T
    d = 10.0 ** rng.uniform(-6, 0, size=n)
    rel, rel32 = _solve_case(d[:, None] * core * d[None, :], rng, solver)
    assert rel < 1e-8, rel
    assert rel < 1e-3 * max(rel32, 1e-30)


@pytest.mark.parametrize("solver", ["lu", "ns"])
def test_refined_solve_genuine_ill_conditioned(solver):
    """Rotation-mixed conditioning ~3e4: three steps reach the floor."""
    rng = np.random.default_rng(4)
    n = 100
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    rel, rel32 = _solve_case((Q * np.logspace(0, -4.5, n)) @ Q.T, rng, solver)
    assert rel < 1e-8, rel
    assert rel < 1e-2 * max(rel32, 1e-30)


def test_refined_solve_ns_matches_lu():
    rng = np.random.default_rng(11)
    n = 120
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    core = (Q * np.logspace(0, -3, n)) @ Q.T
    d = 10.0 ** rng.uniform(-4, 0, size=n)
    Bd = d[:, None] * core * d[None, :]
    C = (Bd @ rng.normal(size=(n, 6))).astype(np.float32)
    B32 = Bd.astype(np.float32)
    B = dw.DF(_t(B32), _t(Bd - B32))
    want = np.linalg.solve(Bd, C.astype(np.float64))
    got = {}
    for solver in ("lu", "ns"):
        got[solver] = _f64(dw.refined_solve(B, _t(C), iters=3, solver=solver))
        rel = np.abs(got[solver] - want).max() / np.abs(want).max()
        assert rel < 1e-8, (solver, rel)
    # the port solves by the LU for either setting
    np.testing.assert_array_equal(got["ns"], got["lu"])


def test_refined_solve_ns_under_vmap():
    """The Newton-Schulz island path under torch.func.vmap: per-system
    accuracy, and each system's answer that of its own unbatched call."""
    rng = np.random.default_rng(13)
    n, batch = 60, 4
    Bs, Cs, wants = [], [], []
    for b in range(batch):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        Bd = (Q * np.logspace(0, -3 - b * 0.4, n)) @ Q.T
        C = (Bd @ rng.normal(size=(n, 3))).astype(np.float32)
        Bs.append(Bd)
        Cs.append(C)
        wants.append(np.linalg.solve(Bd, C.astype(np.float64)))
    hi = _t(np.stack([b.astype(np.float32) for b in Bs]))
    lo = _t(np.stack([b - b.astype(np.float32) for b in Bs]))
    C = _t(np.stack(Cs))
    X = torch.func.vmap(
        lambda h, l, c: dw.refined_solve(dw.DF(h, l), c, iters=3, solver="ns"))(hi, lo, C)
    got = _f64(X)
    for b in range(batch):
        rel = np.abs(got[b] - wants[b]).max() / np.abs(wants[b]).max()
        assert rel < 1e-8, (b, rel)
        one = _f64(dw.refined_solve(dw.DF(hi[b], lo[b]), C[b], iters=3, solver="ns"))
        assert np.abs(one - got[b]).max() / np.abs(wants[b]).max() < 1e-12


def test_refined_solve_divergence_safeguard():
    """Past the float32 preconditioner's range (genuine cond > ~1/eps_f32)
    refinement expands; the safeguard keeps the last healthy iterate: finite,
    never meaningfully worse than the plain float32 LU."""
    rng = np.random.default_rng(7)
    n = 80
    for cond in (1e8, 1e10, 1e12):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        Bd = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
        C = rng.normal(size=(n, 4))
        B32 = Bd.astype(np.float32)
        B = dw.DF(_t(B32), _t(Bd - B32))
        want = np.linalg.solve(Bd, C)
        got = _f64(dw.refined_solve(B, _t(C), iters=5))
        assert np.all(np.isfinite(got)), cond
        rel = np.abs(got - want).max() / np.abs(want).max()
        x32 = np.linalg.solve(B32, C.astype(np.float32))
        rel32 = np.abs(x32 - want).max() / np.abs(want).max()
        assert rel < 8.0 * max(rel32, 1e-7), (cond, rel, rel32)


def test_refined_solve_residual_products(monkeypatch):
    """The residual products in the JAX package's order: ozaki_matmul for
    every iterate but the last refinement step's, which takes the exact
    df_matmul, and ozaki_matmul again for the final iterate's selection
    residual (ROADMAP.md §3)."""
    calls = []
    for name in ("df_matmul", "ozaki_matmul"):
        orig = getattr(dw, name)
        monkeypatch.setattr(dw, name, lambda *a, _n=name, _f=orig, **k: (calls.append(_n),
                                                                          _f(*a, **k))[1])
    rng = np.random.default_rng(4)
    n = 40
    Bd = rng.normal(size=(n, n)) + n * np.eye(n)
    B32 = Bd.astype(np.float32)
    dw.refined_solve(dw.DF(_t(B32), _t(Bd - B32)), _t(rng.normal(size=(n, 2))), iters=5)
    assert calls == ["ozaki_matmul"] * 4 + ["df_matmul", "ozaki_matmul"]


@pytest.mark.parametrize("solver", ["lu", "ns"])
def test_refined_solve_matches_jax(solver):
    """The port's refined_solve against the JAX package's on the same
    double-word system (rows and columns scaled over two decades, core cond
    1e3, cond 7e5), to 5e-11 of the answer's scale: both reach the
    double-word floor (1.2e-11 apart seen), the JAX "ns" from its
    Newton-Schulz preconditioner and the port's from the LU."""
    rng = np.random.default_rng(12)
    n = 40
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    d = 10.0 ** rng.uniform(-2, 0, size=n)
    Bd = d[:, None] * ((Q * np.logspace(0, -3, n)) @ Q.T) * d[None, :]
    C = (Bd @ rng.normal(size=(n, 3))).astype(np.float32)
    B32 = Bd.astype(np.float32)
    lo = (Bd - B32).astype(np.float32)
    got = _f64(dw.refined_solve(dw.DF(_t(B32), _t(lo)), _t(C), iters=3, solver=solver))
    want = _f64(jax.jit(lambda h, l, c: jdw.refined_solve(jdw.DF(h, l), c, iters=3,
                                                          solver=solver))(B32, lo, C))
    assert np.abs(got - want).max() < 5e-11 * np.abs(want).max()


def _realistic_terms(rng, D):
    """tests/test_compensated.py's A, c, P shaped like a mid-sequence state."""
    G = rng.normal(size=(D, D)) * (10.0 ** rng.uniform(-3, 0, size=(D, 1)))
    P = G @ G.T * 1e-4
    H = rng.normal(size=(40, D)) * 100.0
    A = H.T @ H
    c = H.T @ (rng.normal(size=40) * 1e-2)
    return (P.astype(np.float32), A.astype(np.float32), c.astype(np.float32))


def test_correction_chain_matches_f64_island_and_jax():
    cfg = mt.reference_experiment_config(dtype="float32")
    jcfg = jx.reference_experiment_config(dtype="float32")
    cfg64 = dataclasses.replace(cfg, correction_dtype="float64")
    cfg32 = dataclasses.replace(cfg, correction_dtype="float32")
    island = jax.jit(lambda p, a, cc: jax_island(jcfg, p, a, cc))
    rng = np.random.default_rng(3)
    for trial in range(3):
        P, A, c = _realistic_terms(rng, cfg.err_dim)
        args = [_t(x) for x in (P, A, c)]
        dcw, Pcw = (x.numpy() for x in _correction_terms_compensated(cfg, *args))
        d64, P64 = (x.numpy() for x in _correction_terms(cfg64, *args))
        d32, P32 = (x.numpy() for x in _correction_terms(cfg32, *args))
        dj, Pj = (np.asarray(x) for x in island(P, A, c))
        for name, got, f64, f32, jax_got in (("delta", dcw, d64, d32, dj),
                                             ("P", Pcw, P64, P32, Pj)):
            scale = np.abs(f64).max() + 1e-30
            e_cw = np.abs(got - f64).max() / scale
            e_32 = np.abs(f32 - f64).max() / scale
            assert e_cw < 1e-6, (trial, name, e_cw)
            assert e_cw < 0.05 * max(e_32, 1e-30), (trial, name, e_cw, e_32)
            assert np.abs(got - jax_got).max() / scale < 1e-6, (trial, name)


def test_island_ns_solves_by_the_lu():
    """On _realistic_terms at D = 51 the equilibrated B^T has no
    right-half-plane spectrum, and the JAX package's Newton-Schulz inverse
    diverges there (its "ns" island returns NaN, ROADMAP.md §3). The port's
    "ns" island solves by the LU: its answer is the "lu" island's bit for
    bit, within 1e-6 of the float64 chain."""
    cfg = mt.reference_experiment_config(dtype="float32", n_cam_slots=6, m_max=6,
                                         max_camera_states=5)
    P, A, c = _realistic_terms(np.random.default_rng(3), cfg.err_dim)
    args = [_t(x) for x in (P, A, c)]
    sigma2 = torch.full((), cfg.sigma_image**2)
    B = dw.df_add(dw.df_from(sigma2 * torch.eye(cfg.err_dim)), dw.ozaki_matmul(args[1], args[0]))
    r, cs = dw._pow2_equilibration(B.hi.mT)
    Bs = (B.hi.mT * r[:, None]) * cs[None, :]
    assert not np.isfinite(np.asarray(jax_ns_inverse(jnp.asarray(Bs.numpy()), iters=30))).all()
    ns = _correction_terms_compensated(dataclasses.replace(cfg, island_solver="ns"), *args)
    lu = _correction_terms_compensated(cfg, *args)
    d64, _ = _correction_terms(dataclasses.replace(cfg, correction_dtype="float64"), *args)
    for got, want in zip(ns, lu):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert np.abs(ns[0].numpy() - d64.numpy()).max() < 1e-6 * np.abs(d64.numpy()).max()


SMALL_WINDOW = dict(dtype="float32", f_max=128, u_max=16, k_max=256, desc_dim=16,
                    max_camera_states=10, n_cam_slots=12, m_max=12)
T = 400
COUNTERS = ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow")


def _port_run(kind):
    cfg = mt.reference_experiment_config(**SMALL_WINDOW, correction_dtype=kind)
    seq = generate_circle_sequence(rng=np.random.default_rng(0))
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, std.R_init, device="cpu")
    final, pre, fr = mt.run_sequence(cfg, state, std.prefix, std.frames, assume_camera=True,
                                     device="cpu")
    return final, pre, fr


def _positions(pre, fr):
    pv = np.asarray(pre.valid)
    fv = np.asarray(fr.valid).reshape(-1)
    p = np.asarray(fr.p_WI, np.float64)
    return np.concatenate([np.asarray(pre.p_WI, np.float64)[pv], p.reshape(-1, 3)[fv]])


def test_compensated_filter_tracks_f64_island_and_jax():
    """400 ticks with the small window (D = 87): the island's trajectory
    within float32 round-off of the float64 island's, and of the JAX
    package's compensated run."""
    runs = {kind: _port_run(kind) for kind in ("float64", "compensated")}
    finals = {k: v[0].imu.p_WI.double().numpy() for k, v in runs.items()}
    assert np.linalg.norm(finals["compensated"] - finals["float64"]) < 5e-3

    jcfg = jx.reference_experiment_config(**SMALL_WINDOW, correction_dtype="compensated")
    seq = jax_circle(rng=np.random.default_rng(0))
    st = jax_build_stream(jcfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                          seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=T)
    std = jax_to_device(st, jcfg)
    state = jx.make_initial_state(jcfg, std.R_init)
    jfinal, jpre, jfr = jax.jit(
        lambda s, p, f: jx.run_sequence(jcfg, s, p, f, assume_camera=True)
    )(state, std.prefix, std.frames)
    final, pre, fr = runs["compensated"]
    assert {k: int(getattr(final.diag, k)) for k in COUNTERS} == \
        {k: int(getattr(jfinal.diag, k)) for k in COUNTERS}
    got, want = _positions(pre, fr), _positions(jpre, jfr)
    assert got.shape == want.shape == (T, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
