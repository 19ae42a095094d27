"""The batched forms of the port's six kernel ops (their vmap rules, on the
CPU the plain versions with a leading batch axis) against ``jax.vmap`` of
the JAX package's Pallas kernels in interpret mode (their custom_vmap
rules), at tests/test_pallas_batched.py's shapes, in float64.

Each case also holds every sequence of the batched call against a single
call of the op on that sequence, and checks that the op's vmap rule ran
the plain version once for the whole batch, not once per sequence. The
CUDA kernels' batched launches are held against B single launches, bit
for bit, and against these plain versions by chip_smoke.py on the card.
RTOL is test_torch_kernels.py's: the plain versions repeat the TPU
kernels' arithmetic.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msckf_tpu.ops import pallas_kernels as pk
from msckf_tpu_torch.ops import kernels as K

from tests.test_torch_kernels import (
    _prop_inputs, _spd, _triage_inputs, _update_terms_inputs, _verification_inputs,
)

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 3
RTOL = 1e-10
K_ = np.array([[180.0, 0, 320], [0, 180, 240], [0, 0, 1]])


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _stack(make, n=B):
    """B draws of ``make()`` (a sequence of arrays), stacked per argument."""
    draws = [[np.asarray(a) for a in make()] for _ in range(n)]
    return [np.stack([d[i] for d in draws]) for i in range(len(draws[0]))]


def _check(name, plain_name, torch_op, jax_op, batched, shared, scalars, monkeypatch):
    """vmap of the op (batched args mapped, shared args not) against
    jax.vmap of the Pallas kernel and against per-sequence single calls;
    the plain version runs once for the batch."""
    calls = []
    plain = getattr(K, plain_name)
    monkeypatch.setattr(K, plain_name, lambda *a: calls.append(1) or plain(*a))
    tb = [torch.as_tensor(x) for x in batched]
    ts = [torch.as_tensor(x) for x in shared]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a per-example fallback warns
        got = torch.func.vmap(lambda *a: torch_op(*a, *ts, *scalars))(*tb)
    assert len(calls) == 1, f"{name}: plain version ran {len(calls)} times for one batch"
    got = got if isinstance(got, tuple) else (got,)
    want = jax.vmap(lambda *a: jax_op(*a, *map(jnp.asarray, shared), *scalars))(
        *map(jnp.asarray, batched))
    want = want if isinstance(want, tuple) else (want,)
    return got, want, tb, ts


def test_gating_vmap_matches_pallas(monkeypatch):
    rng = np.random.default_rng(1)
    S, r = _stack(lambda: _spd(rng, 12, 16, 10))
    got, want, tb, _ = _check(
        "gating", "batched_gating_gamma_plain", K.batched_gating_gamma,
        lambda *a: pk.batched_gating_gamma(*a, interpret=True), (S, r), (), (), monkeypatch)
    _close(got[0].numpy(), np.asarray(want[0]))
    for b in range(B):
        np.testing.assert_array_equal(got[0][b].numpy(),
                                      K.batched_gating_gamma(tb[0][b], tb[1][b]).numpy())


def test_verification_vmap_matches_pallas(monkeypatch):
    rng = np.random.default_rng(2)
    R1, t1, kp1, kp2, camR, camt, _, _ = _stack(lambda: _verification_inputs(rng, 16, 8, 0.2))
    got, want, tb, ts = _check(
        "verification", "verification_scores_plain", K.verification_scores,
        lambda *a: pk.verification_scores(*a, interpret=True),
        (R1, t1, kp1, kp2, camR, camt), (K_, np.linalg.inv(K_)), (), monkeypatch)
    for name, g, w in zip(("homo", "epi", "base"), got, want):
        _close(g.numpy(), np.asarray(w))
    for b in range(B):
        one = K.verification_scores(*(x[b] for x in tb), *ts)
        for g, w in zip(got, one):
            _close(g[b].numpy(), w.numpy())


def test_triage_vmap_matches_pallas(monkeypatch):
    rng = np.random.default_rng(3)
    base, dirs, w, Ra, ta, _, _ = _stack(lambda: _triage_inputs(rng, 16, 8))
    scal = (1e-12, 640.0, 480.0)
    got, want, tb, ts = _check(
        "triage", "triage_refresh_fused_plain", K.triage_refresh_fused,
        lambda *a: pk.triage_refresh_fused(*a, interpret=True),
        (base, dirs, w, Ra, ta), (K_, np.linalg.inv(K_)), scal, monkeypatch)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() > B * 8
    _close(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), np.asarray(want[1]))
    for b in range(B):
        one = K.triage_refresh_fused(*(x[b] for x in tb), *ts, *scal)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[b].numpy(), o.numpy())


def test_update_terms_vmap_matches_pallas(monkeypatch):
    rng = np.random.default_rng(4)
    args = _stack(lambda: _update_terms_inputs(rng, 12, R2=16, D=63))
    scal = (0.01, 1e-12)
    got, want, tb, _ = _check(
        "update terms", "update_terms_fused_plain", K.update_terms_fused,
        lambda *a: pk.update_terms_fused(*a, interpret=True), args, (), scal, monkeypatch)
    A, c, passed = got
    np.testing.assert_array_equal(passed.numpy(), np.asarray(want[2]))
    assert not passed[:, [1, 2, 3, 11]].any() and passed.sum() >= B * 7
    assert np.isfinite(A.numpy()).all()
    _close(A.numpy(), np.asarray(want[0]))
    _close(c.numpy(), np.asarray(want[1]))
    for b in range(B):
        one = K.update_terms_fused(*(x[b] for x in tb), *scal)
        np.testing.assert_array_equal(passed[b].numpy(), one[2].numpy())
        _close(A[b].numpy(), one[0].numpy())
        _close(c[b].numpy(), one[1].numpy())


def test_p15_vmap_matches_pallas(monkeypatch):
    rng = np.random.default_rng(5)

    def draw():
        L = rng.normal(size=(15, 15)) * 0.01
        Phi = np.eye(15) + rng.normal(size=(6, 15, 15)) * 0.05
        Lq = rng.normal(size=(6, 15, 15)) * 1e-3
        return L @ L.T, Phi, Lq @ Lq.transpose(0, 2, 1)

    got, want, tb, _ = _check(
        "p15", "p15_recurrence_fused_plain", K.p15_recurrence_fused,
        lambda *a: pk.p15_recurrence_fused(*a, interpret=True), _stack(draw), (), (),
        monkeypatch)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    for b in range(B):
        for g, o in zip(got, K.p15_recurrence_fused(*(x[b] for x in tb))):
            _close(g[b].numpy(), o.numpy())


def test_propagate_block_vmap_matches_pallas(monkeypatch):
    """nt = 6 ticks, the last one padding, the first sequence on its very
    first propagation step (the identity null state)."""
    rng = np.random.default_rng(6)
    counts = iter((0, 5, 9))

    def draw():
        return list(_prop_inputs(rng, 6, next(counts), 1).values())

    args = _stack(draw)
    jargs = list(args)
    jargs[6] = args[6].astype(np.int32)
    calls = []
    plain = K.propagate_block_fused_plain
    monkeypatch.setattr(K, "propagate_block_fused_plain",
                        lambda *a: calls.append(1) or plain(*a))
    tb = [torch.as_tensor(x) for x in args]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = torch.func.vmap(K.propagate_block_fused)(*tb)
    assert len(calls) == 1
    R, pv, meta, P15, acc, oR, op, ov, osig = jax.vmap(
        lambda *a: pk.propagate_block_fused(*a, interpret=True))(*map(jnp.asarray, jargs))
    gR, gp, gv, glts, gpc, gP15, gacc, goR, gop, gov, gosig = got
    for g, w in ((gR, R), (gp, pv[:, 0]), (gv, pv[:, 1]), (gP15, P15), (gacc, acc),
                 (goR, oR), (gop, op), (gov, ov), (gosig, osig)):
        _close(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(glts.numpy(), np.asarray(meta)[:, 0, 0])
    np.testing.assert_array_equal(gpc.numpy(), [5, 10, 14])
    for b in range(B):
        for g, o in zip(got, K.propagate_block_fused(*(x[b] for x in tb))):
            _close(g[b].numpy(), o.numpy())


def test_propagate_block_vmap_shares_constants():
    """qc and gravity left unmapped (in_dims None), as the batched loop's
    constants are, give bitwise the call with them stacked."""
    rng = np.random.default_rng(8)
    tb = [torch.as_tensor(x) for x in _stack(lambda: list(_prop_inputs(rng, 2, 5, 1).values()))]
    qc, g = tb[11][0], tb[12][0]
    tb[11], tb[12] = qc.expand(B, 12).clone(), g.expand(B, 3).clone()
    stacked = torch.func.vmap(K.propagate_block_fused)(*tb)
    in_dims = (0,) * 11 + (None, None, 0)
    shared = torch.func.vmap(K.propagate_block_fused, in_dims=in_dims)(
        *tb[:11], qc, g, tb[13])
    for s, w in zip(shared, stacked):
        assert torch.equal(s, w)


def test_vmap_rule_broadcasts_unbatched_arguments():
    """An argument the vmap does not map (the shared P of the update terms
    here) is broadcast to the batch, as the JAX rule's
    ``_broadcast_unbatched`` does."""
    rng = np.random.default_rng(7)
    H, Hf, r, P, crit, sel = _stack(lambda: _update_terms_inputs(rng, 6))
    tb = [torch.as_tensor(x) for x in (H, Hf, r, crit, sel)]
    P0 = torch.as_tensor(P[0])
    got = torch.func.vmap(lambda h, hf, rr, c, s: K.update_terms_fused(h, hf, rr, P0, c, s,
                                                                       0.01, 1e-12))(*tb)
    for b in range(B):
        one = K.update_terms_fused(tb[0][b], tb[1][b], tb[2][b], P0, tb[3][b], tb[4][b],
                                   0.01, 1e-12)
        np.testing.assert_array_equal(got[2][b].numpy(), one[2].numpy())
        _close(got[0][b].numpy(), one[0].numpy())
