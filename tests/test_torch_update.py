"""The hybrid EKF update of a float32 filter (``filter/update.py``) on the
updates where the float32 batched path lost rows on the H100, and the
float64 and fused paths it must leave as they were.

``tests/data/f32_hybrid_lost_rows.npz`` holds four captured updates of the
runner's default batched configuration (float32 filter, float64 island,
hybrid terms, the 12-iteration Newton-Schulz gate under
``batched_dispatch``): each update's float32 input state, trimmed to the
tracks it reads, and its mask. Each has one track seen at a depth near
zero (Jacobian entries 1e3 to 1e8). Two such tracks have a float32 S that
is not positive definite, which the unconverged Newton-Schulz gate passed;
in the other two the information matrix formed as a difference of terms
up to 10x its size lost its small eigenvalues in float32. Replayed here on
the CPU in float32, the gate (a float32 filter's is the exact one) decides
as a float64 Cholesky solve of the same float32 S and r~ does, and the
correction follows the float64 filter's from the same state. In float64
the terms and the gate are bitwise the difference form and the
Newton-Schulz gate.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import msckf_tpu_torch as mt
from msckf_tpu_torch.filter import update as U
from msckf_tpu_torch.filter.state import device_consts, state_to_numpy
from msckf_tpu_torch.ops import kernels as K
from msckf_tpu_torch.ops.smallmat import default_rcond
from msckf_tpu_torch.parallel.batched import batched_dispatch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = Path(__file__).resolve().parent / "data" / "f32_hybrid_lost_rows.npz"
# (seed, row, step) of the captured updates, 512 rows of vio_bench's mc2048
# traffic over 2 laps: the two gate cases, then the two accumulation cases
CASES = ("c0", "c1", "c2", "c3")
FILTER = dict(f_max=192, u_max=32, k_max=256, desc_dim=16, m_max=32, n_cam_slots=32,
              update_kernel="hybrid", correction_dtype="float64",
              accelerometer_noise_density=0.005, gyroscope_noise_density=0.0005,
              accelerometer_random_walk=0.0005, gyroscope_random_walk=5e-05)
CFG32 = batched_dispatch(mt.reference_experiment_config(dtype="float32", **FILTER))
CFG64 = batched_dispatch(mt.reference_experiment_config(dtype="float64", **FILTER))


@pytest.fixture(scope="module")
def captured():
    """Each case's float32 state (tracks back in their slots) and mask."""
    data = np.load(FIXTURE)
    empty = state_to_numpy(mt.make_initial_state(CFG32, device="cpu"))
    out = {}
    for c in CASES:
        d = {}
        slots = data[f"{c}.track_slots"]
        for name, blank in empty.items():
            a = data[f"{c}.{name}"]
            if name.startswith("tracks."):
                full = np.zeros_like(blank)
                full[slots] = a
                a = full
            d[name] = a
        valid = torch.zeros(CFG32.f_max, dtype=torch.bool)
        valid[torch.as_tensor(slots)] = True
        out[c] = (mt.state_from_numpy(d, device="cpu"), valid, tuple(data[f"{c}.case"]))
    return out


def _cast(state, dtype):
    return torch.utils._pytree.tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, state)


def _locals_at_return(fn, *args):
    """``fn(*args)`` and its local variables as it returned (``fn`` may be
    wrapped by a tracing span)."""
    import inspect

    code = inspect.unwrap(fn).__code__
    got = {}

    def prof(frame, event, arg):
        if event == "return" and frame.f_code is code:
            got.update(frame.f_locals)

    sys.setprofile(prof)
    try:
        out = fn(*args)
    finally:
        sys.setprofile(None)
    return out, got


def _crit(cfg, state, valid):
    """The chi-square threshold of each update row, as the update picks its
    rows: the valid tracks in slot order."""
    n_obs = state.tracks.n_obs[valid]
    dof = torch.clamp(2 * n_obs - 3, 0, 2 * cfg.m_max)
    crit = torch.full((cfg.u_max,), float("nan"), dtype=torch.float64)
    crit[: len(n_obs)] = device_consts(cfg, state.device).chi2[dof].double()
    return crit


def _difference_form(L):
    """A and c as the JAX package forms them, from ``build_update_terms``'s
    locals: the block-diagonal Gram of Hcam less the projector's rank-3
    cross terms."""
    zero = torch.zeros((), dtype=L["Hcam"].dtype)
    pm = L["passed"][:, None, None]
    Hcam_m = torch.where(pm, L["Hcam"], zero)
    A_bd = torch.einsum("urd,ure->de", Hcam_m, Hcam_m)
    Wm = torch.where(pm, L["Wc"], zero)
    Gm = torch.where(pm, L["HtH"], zero)
    Kcm = torch.where(pm, L["Kc"], zero)
    T_wk = torch.einsum("uid,uie->de", Wm, Kcm)
    GK = torch.einsum("uij,ujd->uid", Gm, Kcm)
    T_kgk = torch.einsum("uid,uie->de", Kcm, GK)
    A_cam = A_bd - T_wk - T_wk.T + T_kgk
    r_m = torch.where(L["passed"][:, None], L["r_t"], zero)
    Fr = torch.einsum("uri,ur->ui", L["Hf_stack"], L["r_t"])
    Frm = torch.where(L["passed"][:, None], Fr, zero)
    c_cam = torch.einsum("urd,ur->d", Hcam_m, r_m) - torch.einsum("uid,ui->d", Kcm, Frm)
    return (torch.nn.functional.pad(A_cam, (15, 0, 15, 0)),
            torch.nn.functional.pad(c_cam, (15, 0)))


def _correction(state64, A, c):
    """delta and P of the float64 island from one float64 state."""
    return U._correction_terms(CFG64, state64.P, A.double(), c.double())


@pytest.mark.parametrize("case", CASES)
def test_lost_rows_gate_decides_as_an_exact_solve(captured, case):
    """The float32 gate's decisions on each captured update are those of a
    float64 Cholesky solve of the same float32 S and r~ (NaN, a rejection,
    where S is not positive definite). In c0 and c1 the Newton-Schulz gamma
    that ``gating_solver="ns"`` gave before passed a track that the exact
    solve rejects."""
    state, valid, _ = captured[case]
    _, L = _locals_at_return(U.build_update_terms, CFG32, state, valid)
    S, r, gamma = L["S"], L["r_t"], L["gamma"]
    crit = _crit(CFG32, state, valid)
    live = ~torch.isnan(crit)
    exact = U._cholesky_gamma(S.double(), r.double())
    np.testing.assert_array_equal((gamma.double() <= crit)[live], (exact <= crit)[live])
    ns = U._ns_gamma(S, r, CFG32.gating_ns_iters, CFG32.sigma_image**2).double()
    ns_passes_a_rejected = bool(((ns <= crit) & ~(exact <= crit))[live].any())
    assert ns_passes_a_rejected == (case in ("c0", "c1"))


@pytest.mark.parametrize("case", ("c1", "c2", "c3"))
def test_lost_rows_correction_follows_float64(captured, case):
    """Where the float32 and float64 gates agree, the correction from the
    float32 terms (the projected rows, summed in the island's float64)
    follows the one from the float64 terms of the same state. The
    difference form's float32 A put the correction 0.17 and 1.2 m off in c3
    and c2, and P's gap at 23 and 2.8 times its largest entry; the repaired
    terms leave 9.5e-3 m and 2.8e-2 (c3), 2.3e-5 m and 7.6e-4 (c2), the rest
    being the float32 projector's rounding at Jacobian entries near 5e3."""
    state, valid, _ = captured[case]
    s64 = _cast(state, torch.float64)
    t32 = U.build_update_terms(CFG32, state, valid)
    t64 = U.build_update_terms(CFG64, s64, valid)
    assert int(t32.n_gate_rejected) == int(t64.n_gate_rejected)
    assert t32.A.dtype == t32.c.dtype == torch.float64
    d32, P32 = _correction(s64, t32.A, t32.c)
    d64, P64 = _correction(s64, t64.A, t64.c)
    assert float((d32 - d64).abs().max()) < 3e-2
    assert float((P32 - P64).abs().max() / P64.abs().max()) < 0.1
    if case != "c1":  # c1's track near zero depth fails both gates
        _, L = _locals_at_return(U.build_update_terms, CFG32, state, valid)
        A_old, c_old = _difference_form(L)
        d_old, P_old = _correction(s64, A_old, c_old)
        assert float((d_old - d64).abs().max()) > 0.1
        assert float((P_old - P64).abs().max() / P64.abs().max()) > 1.0


@pytest.mark.parametrize("gate", ["ns", "kernel"])
@pytest.mark.parametrize("case", CASES)
def test_float64_terms_and_gate_are_the_difference_form(captured, case, gate):
    """In float64 A and c are bitwise the difference form of the same
    locals, and the gamma bitwise the Newton-Schulz gate's; ``kernel`` is
    the undispatched configuration, whose gate is the gating kernel."""
    cfg = CFG64 if gate == "ns" else mt.reference_experiment_config(dtype="float64", **FILTER)
    state, valid, _ = captured[case]
    out, L = _locals_at_return(U.build_update_terms, cfg, _cast(state, torch.float64), valid)
    A, c = _difference_form(L)
    if gate == "ns":
        want = U._ns_gamma(L["S"], L["r_t"], 12, cfg.sigma_image**2)
    else:
        want = K.batched_gating_gamma(L["S"].contiguous(), L["r_t"].contiguous())
    for got, ref in ((out.A, A), (out.c, c), (L["gamma"], want)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)


def test_fused_terms_are_the_kernel_output(captured):
    """``update_kernel="fused"`` returns the fused kernel's A, c and gate as
    they were, padded, before any of the hybrid branch runs."""
    cfg = batched_dispatch(mt.reference_experiment_config(
        dtype="float32", **dict(FILTER, update_kernel="fused")))
    state, valid, _ = captured["c3"]
    out, L = _locals_at_return(U.build_update_terms, cfg, state, valid)
    A_cam, c_cam, passed = K.update_terms_fused(
        L["Hcam"], L["Hf_stack"], L["r_stack"], state.P[15:, 15:].contiguous(), L["crit"],
        L["sel_ok"], cfg.sigma_image**2, default_rcond(torch.float32))
    assert torch.equal(out.A, torch.nn.functional.pad(A_cam, (15, 0, 15, 0)))
    assert torch.equal(out.c, torch.nn.functional.pad(c_cam, (15, 0)))
    assert int(out.n_gate_rejected) == int((L["sel_ok"] & ~passed).sum())


# --- the departures from the JAX package, applied on its side too ---------


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's update terms under its batched dispatch, jitted
    for float32 and float64, and its Newton-Schulz inverse."""
    import jax

    from msckf_tpu.config import reference_experiment_config as jax_config
    from msckf_tpu.filter.update import build_update_terms as jax_build_update_terms
    from msckf_tpu.parallel.batched import batched_dispatch as jax_dispatch

    fns = {}
    for dtype in ("float32", "float64"):
        jcfg = jax_dispatch(jax_config(dtype=dtype, **FILTER))
        fns[dtype] = (jcfg, jax.jit(lambda st, v, jcfg=jcfg: jax_build_update_terms(jcfg, st, v)))
    return fns


def _jax_gate_with_the_departure(S, r):
    """The JAX package's gate under ``gating_solver="ns"`` with the port's
    float32 departure applied: its exact gate (msckf_tpu/filter/update.py:
    399-401), the Cholesky gamma, in place of the Newton-Schulz one."""
    import jax
    import jax.numpy as jnp

    L = jnp.linalg.cholesky(S)
    sol = jax.scipy.linalg.cho_solve((L, True), r[..., None])[..., 0]
    return jnp.sum(r * sol, axis=-1)


@pytest.mark.parametrize("case", CASES)
def test_float32_gate_departure_matches_jax_with_it(captured, case):
    """ROADMAP §1: a float32 filter takes the exact gate where
    ``gating_solver="ns"`` asks for the Newton-Schulz gate. On each captured
    update's float32 S and r~ the JAX package's gate with that departure
    decides as the port's."""
    import jax.numpy as jnp

    state, valid, _ = captured[case]
    _, L = _locals_at_return(U.build_update_terms, CFG32, state, valid)
    got = L["gamma"]
    want = np.asarray(_jax_gate_with_the_departure(jnp.asarray(L["S"].numpy()),
                                                   jnp.asarray(L["r_t"].numpy())))
    crit = _crit(CFG32, state, valid).numpy()
    live = ~np.isnan(crit)
    np.testing.assert_array_equal((got.numpy() <= crit)[live], (want <= crit)[live])


@pytest.mark.parametrize("case", ("c2", "c3"))
def test_float32_terms_departure_against_jax(captured, jax_side, case):
    """ROADMAP §1: a float32 filter sums A and c from the projected rows in
    the island's float64. On the two accumulation cases the port's float32
    terms give the JAX package's float64 correction of the same state as
    closely as the port's own (within 3e-2 m and 0.1 of P's largest entry),
    a bound the JAX package's float32 difference form misses (0.52 m in c2,
    P 0.95 off in c3)."""
    from tests.test_torch_modules import jax_state_from_numpy

    state, valid, _ = captured[case]
    s64 = _cast(state, torch.float64)
    d = state_to_numpy(state)
    want = {}
    for dtype, (jcfg, fn) in jax_side.items():
        t = fn(jax_state_from_numpy(jcfg, d), valid.numpy())
        want[dtype] = _correction(s64, torch.as_tensor(np.array(t.A)),
                                  torch.as_tensor(np.array(t.c)))
    t32 = U.build_update_terms(CFG32, state, valid)
    got = _correction(s64, t32.A, t32.c)
    (d64, P64), (dj, Pj) = want["float64"], want["float32"]
    gap = lambda a, b: (float((a[0] - b[0]).abs().max()),
                        float((a[1] - b[1]).abs().max() / b[1].abs().max()))
    dd, dP = gap(got, (d64, P64))
    assert dd < 3e-2 and dP < 0.1
    jd, jP = gap((dj, Pj), (d64, P64))
    assert jd > 3e-2 or jP > 0.1
