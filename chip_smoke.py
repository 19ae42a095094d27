#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``msckf_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases device,kernels

Phases (each one raises, and the script exits non-zero, on any failure):

1. device   — card name and power limit, torch and CUDA versions; builds the
              four CUDA kernels into msckf_tpu_torch/build/ and times it.
2. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in float32 and float64, on seeded
              inputs: equal gate/verification decisions, floats within the
              stated tolerances; CUDA-event times of kernel, plain version
              and (gating) a library yardstick; the bound for each.
3. parity   — the test configuration (float64, 600 ticks of the circle) on
              the card and on the CPU: equal counters, matching trajectories.
4. main     — the slice configuration, float32 filter with a float64
              correction island at the reference capacities, over the whole
              circle: error < 0.2 m, no overflow, every kernel launched as
              often as the frame loop predicts; frames/s and host syncs.

The last lines are one JSON object with the kernels' numbers, the card's
name and power limit, and the result line read by the acceptance check.
The script imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and FLOP/s
# outside the tensor cores for each type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# operations each kernel does, counted from its source (see the .cu files)
VERIFICATION_FLOPS_PER_PAIR = 452
P15_FLOPS_PER_TICK = 3 * 2 * 15**3 + 3 * 15 * 15  # three 15^3 products, + Qd, symmetrize
PROPAGATE_FLOPS_PER_TICK = 44_625

TOL = {"float32": 1e-4, "float64": 1e-10}

PHASES = ("device", "kernels", "parity", "main")
DEVICE = "cuda"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` runs of the device time of ``fn()`` (CUDA events
    around each run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_only_ms(torch, fn, match: str, reps: int = 20):
    """Mean device time per call of the CUDA kernels whose name contains
    ``match``, from torch.profiler; None when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(
        getattr(e, "device_time_total", 0.0) for e in prof.key_averages() if match in e.key
    )
    return total_us / reps / 1e3 if total_us > 0 else None


def _fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def assert_close(name, got, want, rtol, floor=False):
    """Check |got - want| <= rtol * (|want| + s) element by element, with
    s = 0 (purely relative) or, with ``floor``, s = max|want|: the output's
    scale, for outputs with entries at or near zero (the signed epipolar
    residual, the zeros of a covariance). Non-finite entries must match.
    Returns (max abs error, max of |got - want| / (|want| + s))."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    fin = np.isfinite(w)
    check(np.array_equal(np.isfinite(g), fin), f"{name}: non-finite entries differ")
    if not fin.any():
        return 0.0, 0.0
    s = float(np.abs(w[fin]).max()) if floor else 0.0
    d = np.abs(g[fin] - w[fin])
    den = np.abs(w[fin]) + s
    rel = np.divide(d, den, out=np.where(d > 0, np.inf, 0.0), where=den > 0)
    bad = rel > rtol
    check(not bad.any(), f"{name}: {int(bad.sum())} entries outside rtol {rtol}")
    return float(d.max()), float(rel.max())


def _worst(errs: dict):
    return max(e[0] for e in errs.values()), max(e[1] for e in errs.values())


def _per_output(errs: dict) -> str:
    return "              per output (max abs / rel): " + ", ".join(
        f"{k} {a:.2e}/{r:.2e}" for k, (a, r) in errs.items())


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def _rotations(rng, n, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_matrix()


def kernel_inputs(torch, dtype, rng, cfg):
    """Seeded inputs at the main path's shapes (U = u_max systems of
    n = 2 m_max rows; F x M = f_max x m_max verification pairs; a 9-tick P15
    block; a 1-tick propagation block)."""
    dev = torch.device(DEVICE)
    U, n, F, M = cfg.u_max, 2 * cfg.m_max, cfg.f_max, cfg.m_max

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    # gating: S = A A^T + sigma^2 I over k_u live rows (k_u = 2 n_obs),
    # sigma^2 I padding rows with zero residual, as the update builds them;
    # A A^T is a well-conditioned Wishart draw (condition number < 10), so
    # float32 round-off stays far inside the tolerance. System 3 gets a
    # negative pivot, which must fail the gate.
    from scipy.stats import chi2

    S = np.zeros((U, n, n))
    r = np.zeros((U, n))
    dof = np.zeros(U, np.int64)
    for u in range(U):
        k = int(rng.integers(2, n // 2 + 1)) * 2
        A = rng.normal(size=(k, 4 * k)) * (0.3 / np.sqrt(4 * k))
        S[u, :k, :k] = A @ A.T
        r[u, :k] = rng.normal(size=k) * 0.3
        dof[u] = k - 3
    S += 0.01 * np.eye(n)
    S[3, 10, 10] = -1.0
    crit = chi2.ppf(0.95, dof)
    gating = (t(S), t(r), t(crit))

    # verification: observation poses near the current camera, keypoints
    # in the image, a share of short baselines
    camR = _rotations(rng, 1, 0.5)[0]
    camt = rng.normal(size=3)
    R1 = camR[None] @ _rotations(rng, F * M, 0.2)
    t1 = camt + rng.normal(size=(F * M, 3)) * np.where(rng.random((F * M, 1)) < 0.2, 0.003, 0.5)
    kp1 = rng.uniform([0, 0], [640, 480], size=(F * M, 2))
    kp2 = rng.uniform([0, 0], [640, 480], size=(F, 2))
    verification = (
        t(R1.reshape(F, M, 3, 3)), t(t1.reshape(F, M, 3)), t(kp1.reshape(F, M, 2)),
        t(kp2), t(camR), t(camt), t(cfg.K_np), t(cfg.K_inv_np),
    )

    # P15 recurrence over the 9 IMU-only ticks of a frame block
    B = 9
    L = rng.normal(size=(15, 15)) * 0.01
    Phi = np.eye(15) + rng.normal(size=(B, 15, 15)) * 0.01
    Lq = rng.normal(size=(B, 15, 15)) * 1e-4
    p15 = (t(L @ L.T), t(Phi), t(Lq @ Lq.transpose(0, 2, 1)))

    def prop_inputs(Bp, prop_count, pad):
        ts = 1.0 + 0.005 * np.arange(1, Bp + 1)
        valid = np.ones(Bp, bool)
        if pad:
            valid[-pad:] = False
            ts[-pad:] = 0.0
        Lp = rng.normal(size=(15, 15)) * 0.01
        return (
            t(_rotations(rng, 1, 1.0)[0]), t(rng.normal(size=3)), t(rng.normal(size=3)),
            t(rng.normal(size=3) * 0.01), t(rng.normal(size=3) * 0.01),
            torch.tensor(1.0, dtype=dtype, device=dev),
            torch.tensor(prop_count, dtype=torch.int64, device=dev),
            t(ts), t(rng.normal(size=(Bp, 3)) * 0.1),
            t(rng.normal(size=(Bp, 3)) + np.array([0, 0, 9.8])),
            torch.as_tensor(valid, device=dev), t(cfg.noise_cov_diag_np),
            t(cfg.gravity_np), t(Lp @ Lp.T),
        )

    propagate = prop_inputs(1, 10, 0)
    propagate_checks = [prop_inputs(1, 0, 0), prop_inputs(2, 5, 1)]
    return gating, verification, p15, propagate, propagate_checks


def phase_kernels(torch, K, cfg, rng):
    """Kernel vs plain version on the card, both dtypes. Returns the float32
    rows for the kernels line, keyed by kernel name."""
    rows = {}
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        sz = torch.finfo(dtype).bits // 8
        gating, verification, p15, propagate, propagate_checks = kernel_inputs(
            torch, dtype, rng, cfg
        )
        log(f"-- kernels, {dtype_name} (tolerance rtol {tol})")

        # 1. gating
        S, r, crit = gating
        U, n = r.shape
        g_k = K.batched_gating_gamma(S, r)
        g_p = K.batched_gating_gamma_plain(S, r)
        torch.cuda.synchronize()
        check(not torch.isfinite(g_k[3]), "gating: negative pivot gave a finite gamma")
        check(torch.equal(g_k <= crit, g_p <= crit), "gating: gate decisions differ")
        ea, er = assert_close("gating gamma", g_k, g_p, tol)
        n_pass = int((g_k <= crit).sum())
        ms = time_ms(torch, lambda: K.batched_gating_gamma(S, r))
        dev_ms = kernel_only_ms(torch, lambda: K.batched_gating_gamma(S, r), "gating_kernel")
        plain = time_ms(torch, lambda: K.batched_gating_gamma_plain(S, r))

        def library():
            L, _ = torch.linalg.cholesky_ex(S)
            sol = torch.cholesky_solve(r[..., None], L)[..., 0]
            return torch.sum(r * sol, dim=-1)

        lib = time_ms(torch, library)
        bms, bby = bound_ms((U * n * n + U * n + U) * sz, U * (n**3 / 3 + n**2 + 2 * n), dtype_name)
        log(f"gating        U={U} n={n}: max abs {ea:.3e} rel {er:.3e}; {n_pass}/{U} pass "
            f"(decisions equal); kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, cholesky_ex+cholesky_solve {lib:.4f} ms, bound {bms:.6f} ms ({bby})")
        rows["batched_gating_gamma"] = dict(err=ea, ms=ms, plain=plain, bound=bms, by=bby, lib=lib)

        # 2. verification
        F, M = verification[1].shape[:2]
        out_k = K.verification_scores(*verification)
        out_p = K.verification_scores_plain(*verification)
        torch.cuda.synchronize()
        errs = {name: assert_close(f"verification {name}", a, b, tol, floor=name == "epi")
                for name, a, b in zip(("homo", "epi", "base"), out_k, out_p)}
        homo, epi, base = out_k
        short = base < 0.01

        def decisions(h, e, b):
            return torch.where(b < 0.01, h > cfg.homography_rejection_threshold,
                               e > cfg.epipolar_rejection_threshold)

        dk, dp = decisions(*out_k), decisions(*out_p)
        check(torch.equal(dk, dp), "verification: rejection decisions differ")
        ea, er = _worst(errs)
        ms = time_ms(torch, lambda: K.verification_scores(*verification))
        dev_ms = kernel_only_ms(torch, lambda: K.verification_scores(*verification),
                                "verification_kernel")
        plain = time_ms(torch, lambda: K.verification_scores_plain(*verification))
        nbytes = (F * M * (9 + 3 + 2 + 3) + F * 2 + 30) * sz
        bms, bby = bound_ms(nbytes, F * M * VERIFICATION_FLOPS_PER_PAIR, dtype_name)
        log(f"verification  F={F} M={M}: max abs {ea:.3e} rel {er:.3e}; "
            f"{int(dk.sum())} rejections, {int(short.sum())} short baselines "
            f"(decisions equal); kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms ({bby})")
        log(_per_output(errs))
        rows["verification_scores"] = dict(err=ea, ms=ms, plain=plain, bound=bms, by=bby, lib=None)

        # 3. P15 recurrence
        B = p15[1].shape[0]
        out_k = K.p15_recurrence_fused(*p15)
        out_p = K.p15_recurrence_fused_plain(*p15)
        torch.cuda.synchronize()
        errs = {nm: assert_close(f"p15 {nm}", a, b, tol, floor=True)
                for nm, a, b in zip(("P", "Phi_acc", "sig"), out_k, out_p)}
        ea, er = _worst(errs)
        ms = time_ms(torch, lambda: K.p15_recurrence_fused(*p15))
        dev_ms = kernel_only_ms(torch, lambda: K.p15_recurrence_fused(*p15), "p15_kernel")
        plain = time_ms(torch, lambda: K.p15_recurrence_fused_plain(*p15))
        nbytes = (225 + 2 * B * 225 + 2 * 225 + 6 * B) * sz
        bms, bby = bound_ms(nbytes, B * P15_FLOPS_PER_TICK, dtype_name)
        log(f"p15           B={B}: max abs {ea:.3e} rel {er:.3e}; kernel {ms:.4f} ms "
            f"(kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, bound {bms:.8f} ms ({bby})")
        log(_per_output(errs))
        rows["p15_recurrence_fused"] = dict(err=ea, ms=ms, plain=plain, bound=bms, by=bby, lib=None)

        # 4. propagation block (B = 1 as on the path; the first-step null
        # state and a padding tick are checked too)
        names = ("R", "p", "v", "last_ts", "prop_count", "P15", "Phi_acc",
                 "outR", "outp", "outv", "outsig")
        errs = {}
        for args in (propagate, *propagate_checks):
            out_k = K.propagate_block_fused(*args)
            out_p = K.propagate_block_fused_plain(*args)
            torch.cuda.synchronize()
            for nm, a, b in zip(names, out_k, out_p):
                if nm == "prop_count":
                    check(torch.equal(a, b), "propagate: prop_count differs")
                    continue
                e = assert_close(f"propagate {nm}", a, b, tol, floor=True)
                prev = errs.get(nm, (0.0, 0.0))
                errs[nm] = (max(prev[0], e[0]), max(prev[1], e[1]))
        ea, er = _worst(errs)
        Bp = propagate[7].shape[0]
        ms = time_ms(torch, lambda: K.propagate_block_fused(*propagate))
        dev_ms = kernel_only_ms(torch, lambda: K.propagate_block_fused(*propagate),
                                "propagate_kernel")
        plain = time_ms(torch, lambda: K.propagate_block_fused_plain(*propagate))
        nbytes = ((9 + 4 * 3 + 1 + 12 + 3 + 225) + Bp * 7) * sz + Bp + 8 \
            + ((9 + 3 + 3 + 1 + 225 + 225) + Bp * 21) * sz + 8
        bms, bby = bound_ms(nbytes, Bp * PROPAGATE_FLOPS_PER_TICK, dtype_name)
        log(f"propagate     B={Bp}: max abs {ea:.3e} rel {er:.3e} (also first step, padding "
            f"tick); kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), plain {plain:.4f} ms, "
            f"bound {bms:.8f} ms ({bby})")
        log(_per_output(errs))
        rows["propagate_block_fused"] = dict(err=ea, ms=ms, plain=plain, bound=bms, by=bby, lib=None)
        if dtype_name == "float32":
            rows32 = dict(rows)
    return rows32


# ---------------------------------------------------------------------------
# phases 3 and 4: the filter
# ---------------------------------------------------------------------------


def _run(torch, pkg, cfg, seq, device, max_ticks=None, stats=None):
    from msckf_tpu_torch.data.stream import build_stream, to_device

    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores,
                      max_ticks=max_ticks)
    std = to_device(st, cfg, device=device)
    state = pkg.make_initial_state(cfg, std.R_init, device=device)
    return std, lambda: pkg.run_sequence(cfg, state, std.prefix, std.frames,
                                         assume_camera=True, device=device, stats=stats)


def _flat(pre, fr, name):
    pv = pre.valid.cpu().numpy()
    fv = fr.valid.cpu().numpy().reshape(-1)
    a = getattr(pre, name).cpu().numpy()
    b = getattr(fr, name).cpu().numpy()
    return np.concatenate([a[pv], b.reshape((-1,) + b.shape[2:])[fv]])


def phase_parity(torch, pkg, seq):
    cfg = pkg.reference_experiment_config(dtype="float64", f_max=512, u_max=64, k_max=512,
                                          use_pallas_triage=False)
    T = 600
    res = {}
    for dev in (DEVICE, "cpu"):
        _, run = _run(torch, pkg, cfg, seq, dev, T)
        t0 = time.perf_counter()
        final, pre, fr = run()
        torch.cuda.synchronize()
        res[dev] = (final, pre, fr, time.perf_counter() - t0)
    (fg, pg, rg, tg), (fc, pc, rc, tc) = res[DEVICE], res["cpu"]
    for name in ("n_cams", "n_tracks"):
        check(np.array_equal(_flat(pg, rg, name), _flat(pc, rc, name)), f"parity: {name} differ")
    counters = {}
    for k in ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
              "n_track_overflow", "n_update_overflow"):
        a, b = int(getattr(fg.diag, k)), int(getattr(fc.diag, k))
        check(a == b, f"parity: {k} differs ({a} vs {b})")
        counters[k] = a
    worst = {}
    for name in ("p_WI", "v_WI", "R_WI"):
        d = float(np.abs(_flat(pg, rg, name) - _flat(pc, rc, name)).max())
        check(d <= 1e-7, f"parity: {name} differs by {d}")
        worst[name] = d
    for name in ("sigma_pos", "sigma_rot"):
        a, b = _flat(pg, rg, name), _flat(pc, rc, name)
        check(np.allclose(a, b, rtol=1e-4, atol=1e-16), f"parity: {name} differs")
        worst[name] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())
    log(f"parity: T={T} ticks, float64, card {tg:.2f} s vs CPU {tc:.2f} s; counters equal "
        f"{counters}; max |dp| {worst['p_WI']:.2e}, |dv| {worst['v_WI']:.2e}, "
        f"|dR| {worst['R_WI']:.2e}, sigma rel {max(worst['sigma_pos'], worst['sigma_rot']):.2e}")


def _block_kind(B: int) -> str:
    return "propagate_block_fused" if B <= 2 else ("p15_recurrence_fused" if B <= 64 else "scan")


def phase_main(torch, pkg, K, seq, kernel_rows):
    cfg = pkg.reference_experiment_config(use_pallas_triage=False)  # f32, f64 island
    check(cfg.dtype == "float32" and cfg.correction_dtype == "float64", "slice config")
    stats = pkg.FrameStats()
    std, run = _run(torch, pkg, cfg, seq, DEVICE, None, stats)
    C, B = std.frames["imu_ts"].shape
    Bp = std.prefix["imu_ts"].shape[0]
    gt = seq.poses_t[len(seq.timestamps) - 1]

    # the driven run: counts from 0, read right after
    K.reset_launches()
    t0 = time.perf_counter()
    final, _, _ = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = K.launch_counts()
    err = float(np.linalg.norm(final.imu.p_WI.double().cpu().numpy() - gt))
    overflow = int(final.diag.n_track_overflow) + int(final.diag.n_update_overflow)
    check(np.isfinite(err), f"main: non-finite final position ({err})")
    check(err < 0.2, f"main: final position error {err:.4f} m >= 0.2 m")
    check(overflow == 0, f"main: capacity overflow {overflow}")

    predicted = dict.fromkeys(launches, 0)
    for kind in (_block_kind(Bp), *[_block_kind(1), _block_kind(B - 1)] * C):
        if kind != "scan":
            predicted[kind] += 1
    predicted["verification_scores"] = stats.camera_steps
    predicted["batched_gating_gamma"] = stats.camera_steps + stats.prune_updates
    for k, v in launches.items():
        check(v > 0, f"main: kernel {k} never launched")
        check(v == predicted[k], f"main: {k} launched {v} times, loop predicts {predicted[k]}")
    syncs, frames = stats.host_syncs, stats.frames
    log(f"main: {C} frames x {B} ticks (+{Bp}-tick prefix), float32 filter, float64 island, "
        f"f_max={cfg.f_max} u_max={cfg.u_max} k_max={cfg.k_max} desc_dim={cfg.desc_dim}")
    log(f"main: final error {err:.4f} m, overflow 0, {stats.prunes} prunes "
        f"({stats.prune_updates} with an update), launches {launches} (= predicted)")

    # synchronizing calls seen by PyTorch over one run, for comparison with
    # the loop's own count of its host branches
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync_sites = {}
    n_port_syncs = 0
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sync_sites[site] = sync_sites.get(site, 0) + 1
            n_port_syncs += "msckf_tpu_torch" in Path(w.filename).parts
    n_sync_warn = sum(sync_sites.values())
    # every synchronizing call of the port is one of the loop's counted
    # branches (the rest is this function's own synchronize())
    check(n_port_syncs == stats.host_syncs - syncs,
          f"main: {n_port_syncs} synchronizing calls in the port, the loop counts "
          f"{stats.host_syncs - syncs}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_med = float(np.median(times))
    kernel_ms = sum(launches[k] * kernel_rows[k]["ms"] for k in launches)
    log(f"main: {C / t_med:.2f} camera frames/s, {t_med / C * 1e3:.3f} ms/frame "
        f"(median of 3 runs {[round(x, 4) for x in times]} s; first run {first_s:.3f} s)")
    log(f"main: kernels' share of the frame time {kernel_ms / (t_med * 1e3) * 100:.2f}% "
        f"({kernel_ms:.3f} ms of {t_med * 1e3:.1f} ms per run, from launches x kernel ms)")
    log(f"main: host syncs per frame {syncs / frames:.3f} (the loop's count: {syncs} "
        f"over the driven run's {frames} frames); "
        f"PyTorch sync-debug warnings over one run: {n_sync_warn}, by site "
        f"{dict(sorted(sync_sites.items(), key=lambda kv: -kv[1]))}")
    profile_window(torch, pkg, cfg, seq)
    return launches


def profile_window(torch, pkg, cfg, seq, n_frames: int = 20):
    """Device busy share and the largest device-time items over the first
    ``n_frames`` camera frames of the main configuration (torch.profiler;
    a warm-up run first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    std, run = _run(torch, pkg, cfg, seq, DEVICE, 20 + 10 * n_frames)
    C = std.frames["imu_ts"].shape[0]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time; busy share not measured")
        return
    n_kernels = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.device_time_total)[:6]
    log(f"profile: {C} frames, {wall_ms / C:.3f} ms/frame under the profiler, device busy "
        f"{busy_ms / C:.3f} ms/frame ({busy_ms / wall_ms * 100:.1f}% busy, "
        f"{100 - busy_ms / wall_ms * 100:.1f}% idle), {n_kernels / C:.0f} device ops/frame")
    for e in top:
        log(f"profile:   {e.device_time_total / 1e3 / C:.4f} ms/frame  {e.count / C:.1f}/frame  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (REPO / "msckf_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: msckf_tpu_torch not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import msckf_tpu_torch as pkg
    from msckf_tpu_torch.data.synthetic import generate_circle_sequence
    from msckf_tpu_torch.ops import kernels as K
    from msckf_tpu_torch.ops.precision import set_f32_matmuls

    set_f32_matmuls()
    card = gpu_name_and_power()
    log(f"== device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = K.build_kernels()
    K._library()
    log(f"== build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    build_log = K.BUILD_DIR / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or line.startswith("=="):
                log("   " + line.strip())

    cfg = pkg.reference_experiment_config(use_pallas_triage=False)
    kernel_rows = None
    if "kernels" in phases:
        log("== kernels")
        kernel_rows = phase_kernels(torch, K, cfg, np.random.default_rng(0))
        K.reset_launches()  # the comparisons above are not the main path's launches
    seq = generate_circle_sequence(rng=np.random.default_rng(0), desc_dim=10)
    if "parity" in phases:
        log("== parity")
        phase_parity(torch, pkg, seq)
    launches = None
    if "main" in phases:
        check(kernel_rows is not None, "the main phase needs the kernels phase")
        log("== main")
        launches = phase_main(torch, pkg, K, seq, kernel_rows)

    if kernel_rows is not None:
        src = {
            "batched_gating_gamma": ("gating.cu", 103),
            "verification_scores": ("verification.cu", 626),
            "p15_recurrence_fused": ("p15_recurrence.cu", 951),
            "propagate_block_fused": ("propagate_block.cu", 1020),
        }
        line = {"kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": f"msckf_tpu_torch/csrc/{src[name][0]}",
                "replaces": f"msckf_tpu/ops/pallas_kernels.py:{src[name][1]}",
                "launches": None if launches is None else launches[name],
                "max_abs_err": row["err"],
                "ms": row["ms"],
                "plain_ms": row["plain"],
                "bound_ms": row["bound"],
                "bound_by": row["by"],
                "library_ms": row["lib"],
            }
            for name, row in kernel_rows.items()
        ]}
        log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
