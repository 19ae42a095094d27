"""The port's plain kernel versions (msckf_tpu_torch/ops/kernels.py) against
the JAX package's Pallas kernels in interpret mode, on the CPU in float64.

Each plain version repeats its TPU kernel's arithmetic, so the two agree to
round-off: rtol 1e-10 (an absolute floor of 1e-10 times the output's scale
covers entries at or near zero, such as the signed epipolar residual and
the structural zeros of Phi_acc). The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from msckf_tpu.ops import pallas_kernels as pk
from msckf_tpu_torch.ops import kernels as K

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-10


def _close(got, want, rtol=RTOL, floor=True):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = np.abs(want[np.isfinite(want)]).max() if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale if floor else 0.0)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _spd(rng, U, n, k=None):
    """sigma^2-regularized SPD systems with k live rows (the rest padding)."""
    k = n if k is None else k
    S = np.zeros((U, n, n))
    A = rng.normal(size=(U, k, 2 * k)) * 0.3
    S[:, :k, :k] = A @ A.transpose(0, 2, 1)
    S += 0.01 * np.eye(n)
    r = np.zeros((U, n))
    r[:, :k] = rng.normal(size=(U, k))
    return S, r


@pytest.mark.parametrize("U,n,k", [(16, 16, 16), (8, 24, 10), (5, 16, 6), (3, 72, 72)])
def test_gating_plain_matches_pallas(U, n, k):
    rng = np.random.default_rng(U * 100 + n)
    S, r = _spd(rng, U, n, k)
    want = np.asarray(pk.batched_gating_gamma(jnp.asarray(S), jnp.asarray(r), interpret=True))
    got = K.batched_gating_gamma(_t(S), _t(r)).numpy()
    _close(got, want, floor=False)


def test_gating_plain_nonpositive_pivot_fails_gate():
    """A non-positive pivot makes gamma non-finite in both, and the gate
    ``gamma <= crit`` fails there; the other systems are unaffected."""
    rng = np.random.default_rng(3)
    S, r = _spd(rng, 6, 16)
    S[2, 5, 5] = -1.0  # negative pivot
    S[4] = 0.0  # zero pivot at column 0
    want = np.asarray(pk.batched_gating_gamma(jnp.asarray(S), jnp.asarray(r), interpret=True))
    got = K.batched_gating_gamma(_t(S), _t(r)).numpy()
    bad = np.zeros(6, bool)
    bad[[2, 4]] = True
    assert not np.isfinite(got[bad]).any() and not np.isfinite(want[bad]).any()
    crit = np.full(6, 30.0)
    np.testing.assert_array_equal(got <= crit, want <= crit)
    assert not (got[bad] <= crit[bad]).any()
    _close(got[~bad], want[~bad], floor=False)


def test_gating_plain_reads_the_pivot_row():
    """S that is not bitwise symmetric: the plain version factors the rows,
    as the TPU kernel does, and stays within round-off of the Cholesky
    solve of the symmetrized matrix."""
    rng = np.random.default_rng(5)
    S, r = _spd(rng, 4, 16)
    S = S + np.triu(rng.normal(size=(4, 16, 16)) * 1e-9, 1)
    want = np.asarray(pk.batched_gating_gamma(jnp.asarray(S), jnp.asarray(r), interpret=True))
    got = K.batched_gating_gamma(_t(S), _t(r)).numpy()
    _close(got, want, floor=False)


def _verification_inputs(rng, F, M, spread):
    camR = Rotation.random(1, random_state=int(rng.integers(1 << 16))).as_matrix()[0]
    camt = rng.normal(size=3)
    R1 = camR[None] @ Rotation.from_rotvec(rng.normal(size=(F * M, 3)) * spread).as_matrix()
    t1 = camt + rng.normal(size=(F * M, 3)) * np.where(rng.random((F * M, 1)) < 0.3, 0.003, 0.5)
    kp1 = rng.uniform(0, 640, size=(F, M, 2))
    kp2 = rng.uniform(0, 640, size=(F, 2))
    K_ = np.array([[180.0, 0, 320], [0, 180, 240], [0, 0, 1]])
    return (R1.reshape(F, M, 3, 3), t1.reshape(F, M, 3), kp1, kp2, camR, camt, K_,
            np.linalg.inv(K_))


@pytest.mark.parametrize("F,M,spread", [(16, 8, 0.2), (32, 16, 0.2), (8, 4, 3.0)])
def test_verification_plain_matches_pallas(F, M, spread):
    rng = np.random.default_rng(F + M)
    args = _verification_inputs(rng, F, M, spread)
    want = pk.verification_scores(*map(jnp.asarray, args), interpret=True)
    got = K.verification_scores(*map(_t, args))
    for name, g, w in zip(("homo", "epi", "base"), got, want):
        _close(g.numpy(), np.asarray(w), floor=name == "epi")


def test_verification_plain_keeps_the_z_guard():
    """A projection at z == 0 is guarded (1e-30), as in the TPU kernel: the
    scores stay finite and equal to the Pallas kernel's."""
    rng = np.random.default_rng(9)
    R1, t1, kp1, kp2, _, camt, _, _ = _verification_inputs(rng, 4, 4, 0.2)
    # with K = I and camR = I, H = R12 = R1^T exactly; this R1 sends
    # x1 = (0, v, 1) and x2 = (0, v', 1) to z = 0 in both directions
    camR = np.eye(3)
    K_ = np.eye(3)
    R1[0, 0] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    kp1[0, 0] = [0.0, 5.0]
    kp2[0] = [0.0, 7.0]
    args = (R1, t1, kp1, kp2, camR, camt, K_, K_)
    want = pk.verification_scores(*map(jnp.asarray, args), interpret=True)
    got = K.verification_scores(*map(_t, args))
    for name, g, w in zip(("homo", "epi", "base"), got, want):
        assert np.isfinite(g.numpy()).all()
        _close(g.numpy(), np.asarray(w), floor=name == "epi")


@pytest.mark.parametrize("F,M", [(768, 32), (13, 1), (5, 7), (37, 40), (769, 32), (1, 1)])
def test_verification_plan_covers_every_pair_once(F, M):
    """Blocks of whole warps, one lane a pair: every pair of a sequence in
    exactly one block, only the last block ragged."""
    threads, blocks = K.verification_plan(F, M)
    assert threads % 32 == 0 and 32 <= threads <= 256
    seen = []
    for b in range(blocks):
        p0 = b * threads
        n = min(threads, F * M - p0)
        assert n == threads or b == blocks - 1
        seen += range(p0, p0 + n)
    assert seen == list(range(F * M))
    if (F, M) == (768, 32):  # the main path: 192 blocks over the 132 SMs
        assert (threads, blocks) == (128, 192)


@pytest.mark.parametrize("F,M", [(0, 4), (4, 0)])
def test_verification_plan_rejects_empty_shapes(F, M):
    with pytest.raises(ValueError, match="F and M"):
        K.verification_plan(F, M)


def test_verification_launcher_passes_its_plan(monkeypatch):
    """The launcher hands the C entry point the eight inputs as they are
    (the camera pose, K and K^-1 each by its own pointer, no concatenated
    copy), each constant's stride a sequence (0 where the sequences share
    it), the three outputs with the batch axis, and the plan of its shapes.
    The launch is recorded, not made: the tests run on the CPU."""
    calls = []
    monkeypatch.setattr(K, "_launch", lambda name, dt, *args: calls.append((name, dt, args)))
    monkeypatch.setattr(torch, "cat", None)
    rng = np.random.default_rng(3)
    for B, F, M, dtype, shared in ((1, 37, 40, torch.float64, False),
                                   (3, 5, 7, torch.float32, False),
                                   (3, 13, 1, torch.float32, True)):
        args = [_t(np.stack([a] * B)).to(dtype) for a in _verification_inputs(rng, F, M, 0.2)]
        if shared:  # K and K^-1 shared by the sequences, as on the batched loop
            args[6], args[7] = args[6][0], args[7][0]
        out = K._verification_launch(*args)
        assert all(o.shape == (B, F, M) and o.dtype == dtype for o in out)
        name, dt, a = calls[-1]
        assert name == "msckf_verification" and dt == dtype
        assert a[:8] == tuple(x.data_ptr() for x in args)
        assert a[8:12] == ((9, 3, 0, 0) if shared else (9, 3, 9, 9))
        assert a[12:15] == tuple(x.data_ptr() for x in out)
        assert a[15:] == (F, M, B, K.verification_plan(F, M)[0])
    assert len(calls) == 3


@pytest.mark.parametrize("B", [1, 2, 9, 64])
def test_p15_plain_matches_pallas(B):
    rng = np.random.default_rng(B)
    L = rng.normal(size=(15, 15)) * 0.01
    P0 = L @ L.T
    Phi = np.eye(15) + rng.normal(size=(B, 15, 15)) * 0.05
    Lq = rng.normal(size=(B, 15, 15)) * 1e-3
    Qd = Lq @ Lq.transpose(0, 2, 1)
    want = pk.p15_recurrence_fused(jnp.asarray(P0), jnp.asarray(Phi), jnp.asarray(Qd),
                                   interpret=True)
    got = K.p15_recurrence_fused(_t(P0), _t(Phi), _t(Qd))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def _prop_inputs(rng, B, prop_count, pad):
    ts = 1.0 + 0.005 * np.arange(1, B + 1)
    valid = np.ones(B, bool)
    if pad:
        valid[-pad:] = False
        ts[-pad:] = 0.0
    L = rng.normal(size=(15, 15)) * 0.01
    qc = np.repeat([1e-8, 1e-12, 1e-6, 1e-10], 3)
    return dict(
        R0=Rotation.random(1, random_state=int(rng.integers(1 << 16))).as_matrix()[0],
        p0=rng.normal(size=3), v0=rng.normal(size=3),
        bg=rng.normal(size=3) * 0.01, ba=rng.normal(size=3) * 0.01,
        last_ts=np.float64(1.0), prop_count=prop_count,
        ts=ts, gyro=rng.normal(size=(B, 3)) * 0.2,
        acc=rng.normal(size=(B, 3)) + np.array([0, 0, 9.8]), valid=valid,
        qc=qc, gravity=np.array([0.0, 0.0, -9.81]), P15=L @ L.T,
    )


@pytest.mark.parametrize(
    "B,prop_count,pad",
    [(1, 10, 0), (2, 10, 1), (9, 10, 2), (1, 0, 0), (9, 0, 0)],
    ids=["B1", "B2-padding-tick", "B9-padding", "B1-first-step", "B9-first-step"],
)
def test_propagate_block_plain_matches_pallas(B, prop_count, pad):
    rng = np.random.default_rng(B * 10 + prop_count + pad)
    a = _prop_inputs(rng, B, prop_count, pad)
    jargs = [jnp.asarray(v) for v in a.values()]
    jargs[6] = jnp.asarray(prop_count, jnp.int32)
    (R, pv, meta, P15, acc, oR, op, ov, osig) = pk.propagate_block_fused(*jargs, interpret=True)
    targs = {k: _t(v) for k, v in a.items()}
    targs["prop_count"] = torch.tensor(prop_count, dtype=torch.int64)
    got = K.propagate_block_fused(*targs.values())
    (gR, gp, gv, glts, gpc, gP15, gacc, goR, gop, gov, gosig) = got
    for g, w in ((gR, R), (gp, pv[0]), (gv, pv[1]), (gP15, P15), (gacc, acc),
                 (goR, oR), (gop, op), (gov, ov), (gosig, osig)):
        _close(g.numpy(), np.asarray(w))
    assert float(glts) == float(meta[0, 0])
    assert int(gpc) == int(meta[0, 1]) == prop_count + B - pad


def _prop_tensors(rng, B, nt, dtype=torch.float64):
    """B draws of _prop_inputs stacked per argument, as torch tensors."""
    draws = [_prop_inputs(rng, nt, 5, 0) for _ in range(B)]
    out = [torch.as_tensor(np.stack([np.asarray(d[k]) for d in draws])) for k in draws[0]]
    return [x.to(dtype) if x.dtype.is_floating_point else x for x in out]


def test_propagate_check_takes_shared_or_stacked_constants():
    """qc and gravity come with the batch axis, or without it when the
    sequences share them; any other shape is refused."""
    args = _prop_tensors(np.random.default_rng(11), 3, 2)
    assert K._propagate_check(*args) == (torch.float64, 3, 2)
    shared = list(args)
    shared[11], shared[12] = args[11][0], args[12][0]
    assert K._propagate_check(*shared) == (torch.float64, 3, 2)
    bad_qc = list(args)
    bad_qc[11] = args[11][:, :11]
    with pytest.raises(ValueError, match="qc has shape"):
        K._propagate_check(*bad_qc)
    bad_g = list(args)
    bad_g[12] = args[12][:2]
    with pytest.raises(ValueError, match="gravity has shape"):
        K._propagate_check(*bad_g)


def test_propagate_launcher_passes_constant_strides(monkeypatch):
    """The launcher hands the C entry point qc's and gravity's strides a
    sequence: 12 and 3 when they come stacked, 0 when the sequences share
    them. The launch is recorded, not made: the tests run on the CPU."""
    calls = []
    monkeypatch.setattr(K, "_launch", lambda name, dt, *args: calls.append((name, dt, args)))
    args = _prop_tensors(np.random.default_rng(12), 3, 2, torch.float32)
    for shared in (False, True):
        a = list(args)
        if shared:
            a[11], a[12] = args[11][0], args[12][0]
        out = K._propagate_launch(*a)
        assert out[7].shape == (3, 2, 3, 3) and out[5].dtype == torch.float32
        name, dt, got = calls[-1]
        assert name == "msckf_propagate_block" and dt == torch.float32
        assert got[:14] == tuple(x.data_ptr() for x in a)
        assert got[14:25] == tuple(x.data_ptr() for x in out)
        assert got[25:] == ((0, 0) if shared else (12, 3)) + (2, 3)


def _triage_inputs(rng, F, M):
    """Consistent geometry as in tests/test_triage_fused.py: each track's
    point is seen along noisy lines from M camera centres, the first of
    them the anchor, whose rotation is near the identity so that most
    points project into the 640 x 480 image. Track 1 lies behind its
    anchor, track 2 outside the image, and track 3 has all weights zero."""
    t_a = rng.normal(size=(F, 3))
    R_a = Rotation.from_rotvec(rng.normal(size=(F, 3)) * 0.1).as_matrix()
    Ci = np.concatenate([rng.uniform(-1.0, 1.0, size=(F, 2)), rng.uniform(3, 8, (F, 1))], 1)
    Ci[1] = [0.1, 0.1, -5.0]
    Ci[2] = [15.0, 0.0, 5.0]
    wp = t_a + np.einsum("fij,fj->fi", R_a, Ci)
    bases = t_a[:, None, :] + rng.normal(size=(F, M, 3))
    bases[:, 0] = t_a
    dirs = wp[:, None, :] - bases + rng.normal(size=(F, M, 3)) * 0.01
    weights = np.where(rng.random((F, M)) > 0.2, rng.uniform(0.5, 1.0, (F, M)), 0.0)
    weights[:, 0] = rng.uniform(0.5, 1.0, F)
    weights[3] = 0.0
    K_ = np.array([[180.0, 0, 320], [0, 180, 240], [0, 0, 1]])
    return bases, dirs, weights, R_a, t_a, K_, np.linalg.inv(K_)


@pytest.mark.parametrize("F,M", [(10, 6), (64, 32), (33, 8), (37, 40)])
def test_triage_plain_matches_pallas(F, M):
    rng = np.random.default_rng(F * 100 + M)
    args = _triage_inputs(rng, F, M)
    rcond = 1e-12
    want = pk.triage_refresh_fused(*map(jnp.asarray, args), rcond, 640, 480, interpret=True)
    got = K.triage_refresh_fused(*map(_t, args), rcond, 640, 480)
    ok = got[2].numpy()
    np.testing.assert_array_equal(ok, np.asarray(want[2]))
    assert not ok[1] and not ok[2] and ok.sum() > F // 2
    _close(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("F,M,B", [(768, 32, 1), (768, 32, 32), (1, 1, 1), (769, 40, 1),
                                   (13, 1, 1), (5, 7, 3), (37, 40, 2), (3, 300, 2)])
def test_triage_plan_covers_every_observation_once(F, M, B, itemsize):
    """Blocks of whole tracks, walked in passes of g whole tracks (or, past
    256 observations, one track's spans of mc): every (track, observation)
    in exactly one pass, in m order within a track; a thread for each
    observation of a pass, each of its 9 g summing lanes and each epilogue
    lane; the shared memory within what a block gets without an opt-in."""
    tracks, g, mc, threads, smem = K.triage_plan(F, M, B, itemsize)
    assert 1 <= g <= tracks <= K.TRIAGE_MAX_TRACKS and 1 <= mc <= M
    assert g == 1 or mc == M
    assert g * mc <= K.TRIAGE_MAX_THREADS and threads % 32 == 0
    assert max(g * mc, 9 * g, tracks) <= threads <= K.TRIAGE_MAX_THREADS
    assert smem <= K.SMEM_NO_OPTIN
    seen = []
    for f0 in range(0, F, tracks):
        nh = min(tracks, F - f0)
        for s0 in range(0, nh, g):
            for m0 in range(0, M, mc):
                ng, mp = min(g, nh - s0), min(mc, M - m0)
                seen += [(f0 + s0 + t, m0 + m) for t in range(ng) for m in range(mp)]
    assert sorted(seen) == [(f, m) for f in range(F) for m in range(M)]
    if (F, M) == (768, 32):  # the main path: 192 blocks over the 132 SMs; B = 32: 768
        assert (tracks, g, threads) == ((4, 4, 128) if B == 1 else (32, 8, 256))
    if F == 1:
        assert (tracks, g, mc, threads) == (1, 1, 1, 32)


@pytest.mark.parametrize("F,M", [(0, 4), (4, 0)])
def test_triage_plan_rejects_empty_shapes(F, M):
    with pytest.raises(ValueError, match="F, M and B"):
        K.triage_plan(F, M, 1, 4)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("nt", [1, 3, 9, 10, 64])
def test_p15_plan_chunks_fit_without_opt_in(nt, itemsize):
    """The ring's chunks of C ticks cover the nt ticks, C is the most two
    slots hold beside the fixed buffers (9 ticks in f32, 4 in f64), and the
    shared memory stays within what a block gets without an opt-in."""
    C, chunks, smem = K.p15_plan(nt, itemsize)
    cmax = 9 if itemsize == 4 else 4
    assert C == min(nt, cmax) and chunks == -(-nt // C) and (chunks - 1) * C < nt <= chunks * C
    assert smem <= K.SMEM_NO_OPTIN
    mat = 16 * K.P15_PITCH * itemsize
    tick = -(-(16 * K.P15_PITCH + 225) // (16 // itemsize)) * 16
    assert smem == 5 * mat + min(chunks, 2) * C * tick


def test_p15_plan_rejects_no_ticks():
    with pytest.raises(ValueError, match="nt >= 1"):
        K.p15_plan(0, 4)


def test_triage_and_p15_launchers_pass_their_plans(monkeypatch):
    """The launchers hand the C entry points the plan of their shapes (the
    triage's depends on B too, the P15 recurrence's on nt and the type) and
    allocate the outputs with the batch axis. The launch itself is recorded,
    not made: the tests run on the CPU."""
    calls = []
    monkeypatch.setattr(K, "_launch", lambda name, dt, *args: calls.append((name, args)))
    rng = np.random.default_rng(7)
    for B, F, M in ((1, 37, 40), (3, 13, 1)):
        args = [_t(np.stack([a] * B)) for a in _triage_inputs(rng, F, M)]
        m, rho, ok = K._triage_launch(*args, 1e-12, 640, 480)
        assert m.shape == (B, F, 3) and rho.shape == (B, F) and ok.shape == (B, F)
        name, a = calls[-1]
        assert name == "msckf_triage" and a[13:16] == (F, M, B)
        assert a[16:] == K.triage_plan(F, M, B, 8)
    for nt, dtype in ((64, torch.float32), (9, torch.float64)):
        P0 = torch.eye(15, dtype=dtype)[None]
        Phi = torch.eye(15, dtype=dtype).expand(2, nt, 15, 15).contiguous()
        P, acc, sig = K._p15_launch(P0.expand(2, 15, 15).contiguous(), Phi, Phi.clone())
        assert P.shape == (2, 15, 15) and sig.shape == (2, nt, 6)
        name, a = calls[-1]
        C, _, smem = K.p15_plan(nt, P0.element_size())
        assert name == "msckf_p15_recurrence" and a[6:] == (nt, 2, C, smem)
    assert len(calls) == 4


def _update_terms_inputs(rng, U, R2=12, D=27):
    """tests/test_update_terms_fused.py's inputs in float64, with rows
    beyond 8 zero (padding observations), mixed thresholds (track 1 fails),
    a NaN threshold (track 2), an unused row (track U - 1, sel_ok False),
    and an inf Jacobian entry in track 3, which must fail the gate and add
    nothing to A and c."""
    Hf = rng.normal(size=(U, R2, 3))
    H = rng.normal(size=(U, R2, D)) * 0.5
    r = rng.normal(size=(U, R2)) * 0.1
    Hf[:, 8:] = 0.0
    H[:, 8:] = 0.0
    r[:, 8:] = 0.0
    H[3, 2, 5] = np.inf
    Pm = rng.normal(size=(D, D)) * 0.05
    crit = np.full(U, 50.0)
    crit[1] = 1e-6
    crit[2] = np.nan
    sel_ok = np.ones(U, bool)
    sel_ok[U - 1] = False
    return H, Hf, r, Pm @ Pm.T, crit, sel_ok


@pytest.mark.parametrize("U,R2,D", [(6, 12, 27), (13, 12, 27), (5, 80, 30)],
                         ids=["6", "13", "5-2M80-D30"])
def test_update_terms_plain_matches_pallas(U, R2, D):
    rng = np.random.default_rng(U)
    args = _update_terms_inputs(rng, U, R2, D)
    sigma2, rcond = 0.01, 1e-12
    A_w, c_w, p_w = pk.update_terms_fused(*map(jnp.asarray, args), sigma2, rcond,
                                          interpret=True)
    A, c, passed = K.update_terms_fused(*map(_t, args), sigma2, rcond)
    np.testing.assert_array_equal(passed.numpy(), np.asarray(p_w))
    assert not passed[[1, 2, 3, U - 1]].any() and passed.sum() >= U - 5
    assert np.isfinite(A.numpy()).all() and np.isfinite(c.numpy()).all()
    _close(A.numpy(), np.asarray(A_w))
    _close(c.numpy(), np.asarray(c_w))


@pytest.mark.parametrize("U,R2", [(128, 64), (13, 12), (12, 16), (37, 40), (1, 1), (5, 64), (0, 8),
                                  (8, 65), (8, 128)])
def test_update_chunk_plan_covers_every_row_once(U, R2):
    """The accumulation's chunks hold whole tracks, every track (so every
    row) in exactly one chunk, in order, and about 512 rows each."""
    tpc, n = K.update_chunk_plan(U, R2)
    assert 1 <= tpc <= K.UPDATE_CHUNK_MAX_TRACKS
    tracks = [list(range(k * tpc, min((k + 1) * tpc, U))) for k in range(n)]
    assert all(tracks) and sum(tracks, []) == list(range(U))
    rows = [[u * R2 + q for u in t for q in range(R2)] for t in tracks]
    assert sum(rows, []) == list(range(U * R2))
    assert tpc * R2 <= max(K.UPDATE_CHUNK_ROWS, R2)
    if (U, R2) == (128, 64):
        assert (tpc, n) == (8, 16)  # the TPU kernel's tile of 8 tracks


@pytest.mark.parametrize("R2", [0])
def test_update_chunk_plan_rejects_2m_outside_the_gate(R2):
    with pytest.raises(ValueError, match="2M"):
        K.update_chunk_plan(8, R2)


def test_update_terms_scratch_follows_the_plan_not_the_batch(monkeypatch):
    """The wrapper's launcher sizes the partials scratch (B, chunks, D, D)
    and (B, chunks, D) from the plan and passes the same tracks per chunk
    whatever the batch, so a batched call sums in a single call's order;
    2M > 64 (the general form of launch 1) launches as well, with S's
    scratch (B, U, 2M, 2M) and, where the gate's working set leaves shared
    memory, a gate scratch of B * U working sets. The launch itself is
    recorded, not made, and the library's answers are stubbed: the tests
    run on the CPU."""
    calls = []
    gate_elems = {65: 65 * 66 // 2 + 9 * 65}  # as if 2M = 65 left shared memory
    monkeypatch.setattr(K, "_launch", lambda name, dt, *args: calls.append(args))
    monkeypatch.setattr(K, "gate_scratch_elems", lambda dt, n, device: gate_elems.get(n, 0))
    rng = np.random.default_rng(3)
    D = 20
    for U, R2 in ((37, 40), (4, 65)):
        tpc, n = K.update_chunk_plan(U, R2)
        for B in (1, 3):
            H, Hf, r, P, crit, sel = (_t(np.stack([a] * B))
                                      for a in _update_terms_inputs(rng, U, R2, D))
            ptr = {t.data_ptr(): t for t in (H, Hf, r, P, crit, sel)}
            A, c, passed = K._update_terms_launch(H, Hf, r, P, crit, sel, 0.01, 1e-12)
            assert A.shape == (B, D, D) and c.shape == (B, D) and passed.shape == (B, U)
            args = calls[-1]
            assert args[:6] == tuple(ptr)
            assert args[15:20] == (U, R2, D, B, tpc)
            assert (args[9] is None) == (R2 not in gate_elems)
            sc = K.update_terms_scratch(B, U, R2, D, torch.float64, "cpu")
            assert sc["Ht"].shape == (B, U, R2, D) and sc["rt"].shape == (B, U, R2)
            assert sc["Ss"].shape == (B, U, R2, R2)
            assert sc["Apart"].shape == (B, n, D, D) and sc["cpart"].shape == (B, n, D)
            assert (sc["gate"] is None if R2 not in gate_elems
                    else sc["gate"].shape == (B * U * gate_elems[R2],))
    assert len(calls) == 4
