#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``msckf_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases device,kernels

Phases (each one raises, and the script exits non-zero, on any failure):

1. device   — card name and power limit, torch and CUDA versions; builds the
              six CUDA kernels into msckf_tpu_torch/build/ and times it.
2. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's shapes, in float32 and float64, on seeded
              inputs: equal gate decisions, the verification's homo, epi
              and base and the triage's m, rho and ok bitwise equal, floats
              within the stated tolerances; CUDA-event times of kernel,
              plain version and (gating) a library yardstick; the bound for
              each; the launch floor (the device time of a one-element
              fill). The verification also at (F, M) = (13, 1), (5, 7),
              (37, 40) and (769, 32), and its whole call's device time
              beside that of a torch.cat of its four constants into one
              array. The propagation block also from the first step, with
              a padding tick, and at nt = 9 with two padding ticks; batched
              also with qc and gravity shared (stride 0), bitwise equal to
              its single launches. The triage also at (F, M) = (768, 32),
              (769, 40), (13, 1) and (5, 7), the P15 recurrence at nt = 3,
              9 and 64, each also batched at B = 4 bitwise against its
              single launches. The gate also at
              n = 80 and 130 (and, in float64, 240, whose working set lies
              in a global scratch). The update terms
              also at six ragged shapes up to 2M = 80 and D = 294, on both
              forms of their first launch (single and batched at B = 4,
              bitwise), with the device time of each of their four launches
              and a yardstick: the same products by torch.matmul. Then each
              kernel's batched form (its vmap
              rule's one launch for B = 32 sequences; B = 4 for the update
              terms in float64): bitwise equal to B single launches, within
              the same tolerances of the plain version over the batch
              axis; its times and bound.
3. parity   — the test capacities in float64, 150 ticks of the circle, on
              the card and on the CPU, in the default configuration, with
              update_kernel="fused" and with the plain triage
              (use_pallas_triage=False), then the default and the fused ones
              with n_cam_slots=41, m_max=40 (2M = 80, D = 246): equal
              counters and per-tick counts, matching trajectories; the same
              for batched_run_sequence over two seeds (default dispatch).
4. main     — the default configuration (float32 filter, float64
              correction island, triage kernel, hybrid update with the
              gating kernel) at the reference capacities over the whole
              circle: error < 0.2 m, no overflow, every kernel launched as
              often as the frame loop predicts; host syncs, and a profile.
5. fused    — the same with update_kernel="fused": error, overflow,
              launches, host syncs and a profile.
6. plain    — the same with the plain triage (use_pallas_triage=False):
              error, overflow, launches and host syncs.
   Then frames/s of each configuration driven above, 2 runs each: the
   driven run, then one more in reverse order.
7. xla      — a short run with update_kernel="xla" (the batched-Cholesky
              gate): launches, and no synchronizing call beyond the loop's.
8. batched  — batched_run_sequence over 32 seeds of the circle at the
              reference capacities in float32, the whole circle, in the
              default dispatch and with update_kernel="fused", then 400
              ticks with dispatch_auto=False (the triage and gating
              kernels): every sequence within 0.2 m, no overflow, one launch
              per call site and frame (not one per sequence), no functorch
              fallback to a per-sequence loop, no host sync; aggregate
              frames/s beside the single default loop's (the driven runs);
              profiles of the default and the fused batched loop.
9. solvers  — the gain solves on the card at D = 207 in float32 and float64
              (the unbatched gain_solve the LU's bits; under vmap at B = 32
              within 1e-5 of float64, and the batched LU's bits for a batch
              holding one hard system; one Newton-Schulz step the LU's bits;
              the Cholesky solve finite at cond(P) = 1e8); CUDA-event times
              of the correction chain (lu, ns, chol, single and at B = 32,
              float32 and float64 chains) and of the solves alone; the whole
              circle with gain_solver="ns", "chol" and triangulation="gn",
              and 200 ticks with use_pallas=False, each with error,
              overflow, launch and sync checks (no triage kernel under gn,
              no kernel at all with use_pallas=False); their frames/s from
              the driven runs; the batched float32 chain (B = 32, 200
              ticks, batched_solver "ns" and "lu": overflow, launches, 0
              host syncs, the position gap per sequence); and 150-tick
              float64 card-vs-CPU parity of the four settings.
10. images  — the image-in pipeline over bench.py's rendered sequence (104
              frames of 640 x 480, rendered on the host by the port's
              numpy renderer) with the committed weights
              (weights/xfeat_selfsup.npz): the CNN on the card against the
              CPU on four frames (the backbone's largest errors; the valid
              keypoint sets agree in at least 99 % of the slots, every
              mismatch logged with its score gap; matched keypoints' scores
              within 1e-5 and descriptors within 1e-4; the batched call's
              keypoints equal to single calls'); run_sequence_images at
              top_k = 300 with the whole-stack CNN in the runner's rendered
              configuration and in bench.py's headline settings (NS gain and
              gate, float32 island), each with final error < 0.5 m, no
              overflow, launches equal to the loop's prediction, host syncs
              per frame; CUDA-event times of detect_and_compute on one frame
              and of the CNN stage over the stack, the filter alone, the
              image loop's frames/s (two runs, in turns with the synthetic
              default loop when main ran), and a 5-frame profile.
11. runner  — the port's CLI, msckf_tpu_torch.runner.main, in-process:
              600 ticks of the synthetic circle (the runner's dataset
              capacities), then
              with --stream_chunk 16 and 64: final error < 0.2 m, no
              overflow, launches equal to twice the loop's prediction (the
              runner's warm-up and timed run), the streamed runs bitwise
              equal to the monolithic one (metrics, diagnostics, final
              state) with one host sync a chunk more, the stream's device
              bytes (peak allocation) within two chunks and a chunk's
              outputs; frames/s of the three, two runs each in turns; a
              checkpoint saved after half the frames, loaded on the card and
              continued, bitwise equal to the uninterrupted run; --batch 32
              over 300 ticks unstreamed and with --stream_chunk 64 (every
              sequence under 0.2 m, no overflow, launches as predicted, the
              streamed final states bitwise equal to the unstreamed,
              aggregate frames/s); --source rendered (the runner's 320 x 240
              circle, 400 ticks) with --frontend fused and host: error
              < 0.5 m, no overflow, launches as predicted.
12. island  — the double-word correction island
              (correction_dtype="compensated", ops/compensated.py): (a)
              two_sum and two_prod exact against float64 on 10^6 pairs; (b)
              _exact_pow2 exact over [-126, 127], exponents read exactly,
              and every Ozaki slice of one island call at D = 207 on its
              grid, at most 8 bits, exact in bfloat16, from inputs under 2;
              (c) ozaki_matmul and df_matmul within the JAX tests' bounds of
              a float64 product on the card, and within 1e-11 of rowmax *
              colmax of the port's CPU result; (d) refined_solve "lu" and
              "ns" under 1e-8 of float64, and the divergence safeguard; (e)
              on real updates captured from the circle on the card, the
              island within 1e-6 of the float64 chain, and its double-word
              results before rounding under 0.05x the float32 chain's
              error; CUDA-event times of the chains single and at B = 32,
              device ops a call, the batched island's peak memory at
              B = 32 and 256; frames/s of 200 ticks of the circle with
              each island, single and at B = 32, in turns ABBA; then,
              while (h) runs, (f) the whole circle with the island, default
              and fused, each beside the float64 island's driven run
              (phases main and fused): error, overflow, launches and host
              syncs equal to the float64 run's, the sync check; (g) the
              batched circle at B = 32 with the island beside phase
              batched's float64 run: every sequence under 0.2 m, 0 host
              syncs, launches, peak memory; (h) the runner's classic
              (10,798 ticks, mid noise, --gen_noise default) with the
              island and the float64 island, in two processes at once
              beside (f), (g) and phase sources when it runs: no NaN, mean ATE
              <= 10.5 m and final ATE <= 52.5 m, overflow 0, launches.
13. sources — the dataset sources: 100 frames of tests/test_tartanair_e2e.py's
              boxes orbit at TartanAir's camera (640 x 480, f 320, centre
              320, 240), rendered on the host in 6 processes and written as
              RGB PNGs by the port's encoder (filter types 0-4 by rows in
              turn) with the trajectory in TartanAir's format; both grey
              reads of every frame timed on the host, one frame unfiltered
              by the native library and by the plain version (equal bytes,
              both times); the runner with --source tartanair, --frontend
              fused and host, --refine_subpix (final error < 0.5 m, no NaN,
              no overflow, launches equal to twice the loop's prediction,
              camera_info.csv's camera; load time and camera frames/s); the
              native reader bitwise the csv reader on the generated imu.csv;
              24 frames in PeringLab's format through --source peringlab;
              LiveRerunStream with a recording sink on 400 ticks of the
              circle streamed in 16-frame chunks (one record a tick, the
              run's positions and counts, launches as predicted).
14. train   — the XFeat trainer (models/train_xfeat.py, float32, TF32 off):
              (a) one batch_loss and backward at the CLI's width (batch 8,
              256 x 256, the committed weights, a seeded PairPool batch) on
              the card against the CPU: loss and aux, every parameter's
              gradient and the new batch statistics within TRAIN_TOL, and
              the same step with TF32 on beyond at least one limit; the
              optimizer (ClippedAdamW) on both from the same float64
              gradients within 1e-12; (b) train() from scratch, 200 steps,
              batch 8, 256 x 256, a 32-pair pool refreshed by 8 every 50
              steps: every loss finite, the mean of the last 20 under 0.8x
              that of the first 20; steps/s, images/s, the pool's host share
              and the peak allocation of the loop, and one step's time by
              CUDA events; (c) the frozen benchmark
              (weights/frontend_eval_v1.npz) with the committed weights on
              the card and the CPU: precisions within 0.01 and matches/pair
              within 1.0 of each other, at or above the gates (hard 0.60,
              mild 0.52, 60 matches/pair); (d) save_npz_params of (b)'s model
              and load_xfeat_npz on the card: detect_and_compute bitwise
              the in-memory model's; (e) train_xfeat.main(--steps 20
              --pool 8) in-process on the card, its weights loaded.
15. scaleout — scale-out on the one card, at the runner's --batch capacities
              (float32; 32 seeds of the circle, 300 ticks): (a)
              sharded_run_sequence over a mesh that names the card twice,
              16 + 16 rows: each shard's rows bitwise batched_run_sequence of
              those rows alone, launches twice the per-shard prediction,
              counters and per-tick counts equal to one launch of 32 and its
              trajectories within 1e-3; shardmap_run_sequence, one unbatched
              sequence a shard in its own host thread (12 frames), each
              bitwise its own run_sequence; run_batched_streamed(sharding=) bitwise the
              sharded run; (b) init_distributed at world size 1 over NCCL,
              global_data_mesh, shard_global_batch and multihost_run_sequence
              bitwise batched_run_sequence, gather_global a real all-gather;
              (c) two processes on the card over gloo: multihost_demo with 16
              rows each, bitwise a one-process run of those rows, and the
              runner's --batch 32 under the torchrun environment contract,
              rank 0's errors within 1e-3 m of the one-process runner's (a
              third process); (d)
              sharded XFeat with the committed weights on 8 rendered frames of
              640 x 480: mesh (1, 1) over NCCL bitwise the unsharded call,
              meshes (1, 2) and (2, 1) over two gloo ranks with every
              keypoint slot and validity equal and scores and descriptors
              within 5e-4; (e) save_state_dcp after 6 of 12 frames, load_state_dcp on
              the card, resumed bitwise; (f) each form's wall time beside the
              card's name and power limit. The child processes run beside
              (a), (b) and (e), each under a deadline; their output is logged
              when one fails.

The last lines are one JSON object with the kernels' numbers, the card's
name and power limit, and the result line read by the acceptance check.
The script imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and FLOP/s
# outside the tensor cores for each type; for matmul-shaped work float64
# also runs on the tensor cores (DMMA), at 67 TFLOP/s, while float32 there
# would be TF32, which does not keep float32's precision
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_FLOPS_MATMUL = {"float32": 67e12, "float64": 67e12}

# operations each kernel does, counted from its source (see the .cu files)
VERIFICATION_FLOPS_PER_PAIR = 452
P15_FLOPS_PER_TICK = 3 * 2 * 15**3 + 3 * 15 * 15  # three 15^3 products, + Qd, symmetrize
PROPAGATE_FLOPS_PER_TICK = 44_625
TRIAGE_FLOPS_PER_OBS = 50  # norm 6, 3 divisions, X 24, b.d 5, y 12
TRIAGE_FLOPS_PER_TRACK = 122  # the 3x3 solve, the anchor frame, projection, refresh


def update_terms_flops(U: int, R2: int, D: int) -> float:
    """Operations the function needs for one update_terms_fused call, from
    update_terms.cu: per track the Gram and Hf^T r sums, Hf^T H,
    C = W Hf^T H, H~ = H - Hf C, H~ P, the symmetric S (R2 (R2 + 1) / 2 dot
    products of length D) and the Cholesky with its substitution; then the
    symmetric A (D (D + 1) / 2 dot products over all U * R2 rows) and c."""
    per_track = (9 * 2 * R2 + 3 * 2 * R2 * D + 15 * D + 6 * R2 * D
                 + 2 * R2 * D * D + D * R2 * (R2 + 1) + R2**3 / 3 + 2 * R2**2)
    return U * per_track + U * R2 * D * (D + 1) + 2 * U * R2 * D

TOL = {"float32": 1e-4, "float64": 1e-10}

# the four launches of one update_terms_fused call (update_terms.cu), and
# the two of the general form of its first launch (2M > 64, or a working set
# over the shared-memory opt-in), which replace update_track_kernel
UPDATE_LAUNCHES = ("update_track_kernel", "gate_kernel", "update_partial_kernel",
                   "update_reduce_kernel")
UPDATE_KERNELS = UPDATE_LAUNCHES + ("update_project_kernel", "update_s_kernel")
# (U, 2M, D) of the ragged update-terms checks: the CPU tests' two shapes
# (tests/test_torch_kernels.py, tests/test_torch_batched_kernels.py), one of
# several chunks with D a multiple of 16 bytes but not of the 64-column
# tile, 2M = 80 at D = 246 (n_cam_slots = 41, m_max = 40: the general launch
# 1 in both types), and D = 198 and 294 at 2M = 64 (past the earlier
# design's f64 limit of D = 192; 294 is past the fast form's f64 limit of 288)
RAGGED_UPDATE_SHAPES = ((13, 12, 27), (12, 16, 63), (37, 40, 100), (9, 80, 246), (9, 64, 198),
                        (9, 64, 294))
RAGGED_BATCH = 4
# n of the gate checks beyond the main path's 64 (U = GATE_U systems each);
# in float64 also one whose working set leaves shared memory for the global
# scratch (n >= 237 on the H100's opt-in)
GATE_SHAPES = (80, 130)
GATE_GLOBAL_N = 240
GATE_U = 32
# (F, M) of the triage checks beyond the main path's: a ragged last block
# with M past one warp (M = 40: m_max = 40), M = 1, and F and M below one
# block's plan; ticks of the P15 checks: 3 and 9 in one chunk, 64 in several
# (in both types); each also batched, B sequences against their singles
TRIAGE_SHAPES = ((768, 32), (769, 40), (13, 1), (5, 7))
TRIAGE_BATCH = 4
# (F, M) of the verification checks beyond the main path's: M = 1, F x M
# below one block, a ragged last block with M past one warp, F one past the
# main path's; each also batched, VERIFY_BATCH sequences against their
# singles
VERIFY_SHAPES = ((13, 1), (5, 7), (37, 40), (769, 32))
VERIFY_BATCH = 4
P15_TICKS = (3, 9, 64)
P15_BATCH = 4

PHASES = ("device", "kernels", "parity", "main", "fused", "plain", "xla", "batched",
          "solvers", "images", "runner", "island", "sources", "train", "scaleout")
BATCH = 32  # sequences of the batched phase and the batched kernel checks
# ticks of the float64 card-vs-CPU parity runs (phases parity and solvers;
# 600 until the island phase joined the script, cut to keep it in its time)
PARITY_TICKS = 150
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


WINDOWS = 6  # profiler windows kernel_only_ms may take for one reading
# camera frames of each profile (20 until phase sources joined the script,
# 10 until phase train did; cut to keep the script in its time)
PROFILE_FRAMES = 5


def kernel_only_ms(torch, fn, match=None, reps: int = 20):
    """Mean device time per call of the CUDA kernels whose name contains
    ``match`` (a string, or a tuple of strings for a call of several
    kernels; None: every kernel the call launches), from torch.profiler;
    None when it records no device time. A kernel's time a call is its mean
    over the records the profiler kept (it now and then drops a window's
    first one) times its launches a call, k, which its record count must
    show: k * reps, or one less. A window that shows neither is taken
    again, up to six times (with three, a call has failed when a window of
    the triage kernel lost two records three times running)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    matches = (match,) if isinstance(match, str) else match
    fn()
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, odd = 0.0, []
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA or not e.count
                    or (matches is not None and not any(m in e.key for m in matches))):
                continue
            k = -(-e.count // reps)
            if e.count < k * reps - 1:
                odd.append(f"{e.count} records of {e.key}")
            total_us += e.device_time_total / e.count * k
        if not odd:
            return total_us / 1e3 if total_us > 0 else None
    raise SmokeFailure(f"profiler: {', '.join(odd)} in {reps} calls, {WINDOWS} windows running")


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


def bound_ms(nbytes: float, flops: float, dtype: str, peaks=PEAK_FLOPS):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peaks[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_bound(name: str, dims, dtype: str, B: int = 1):
    """(bound ms, what bounds it) of one call on B sequences, from the
    shapes: each input read once, each output written once, the operations
    counted from the kernel's source."""
    sz = 4 if dtype == "float32" else 8
    peaks = PEAK_FLOPS
    if name == "batched_gating_gamma":
        # the recurrence reads S's upper triangle only (gate.cuh copies just
        # that), so each system moves n (n + 1) / 2 + n elements in, 1 out
        U, n = dims
        nbytes = U * (n * (n + 1) // 2 + n + 1) * sz
        flops = U * (n**3 / 3 + n**2 + 2 * n)
    elif name == "verification_scores":
        F, M = dims
        nbytes = (F * M * (9 + 3 + 2 + 3) + F * 2 + 30) * sz
        flops = F * M * VERIFICATION_FLOPS_PER_PAIR
    elif name == "p15_recurrence_fused":
        (nt,) = dims
        nbytes, flops = (225 + 2 * nt * 225 + 2 * 225 + 6 * nt) * sz, nt * P15_FLOPS_PER_TICK
    elif name == "propagate_block_fused":
        (nt,) = dims
        nbytes = ((9 + 4 * 3 + 1 + 12 + 3 + 225) + nt * 7) * sz + nt + 8 \
            + ((9 + 3 + 3 + 1 + 225 + 225) + nt * 21) * sz + 8
        flops = nt * PROPAGATE_FLOPS_PER_TICK
    elif name == "triage_refresh_fused":
        F, M = dims
        nbytes = (F * M * 7 + F * 12 + 18 + F * 4) * sz + F
        flops = F * M * TRIAGE_FLOPS_PER_OBS + F * TRIAGE_FLOPS_PER_TRACK
    else:
        U, n2, D = dims
        nbytes = (U * n2 * (D + 4) + 2 * D * D + D + U) * sz + 2 * U
        flops, peaks = update_terms_flops(U, n2, D), PEAK_FLOPS_MATMUL
    return bound_ms(B * nbytes, B * flops, dtype, peaks)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def _rotations(rng, n, scale):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.normal(size=(n, 3)) * scale).as_matrix()


def gate_inputs(rng, U, n):
    """S = A A^T + sigma^2 I over k_u live rows (k_u = 2 n_obs), sigma^2 I
    padding rows with zero residual, as the update builds them; A A^T is a
    well-conditioned Wishart draw (condition number < 10), so float32
    round-off stays far inside the tolerance. System 3 gets a negative
    pivot, which must fail the gate. Returns numpy S, r and the chi-square
    thresholds."""
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
    return S, r, chi2.ppf(0.95, dof)


def p15_inputs(torch, dtype, rng, nt):
    """P0, Phi and Qd of an nt-tick P15 block: Phi near the identity, P0 and
    Qd symmetric positive semi-definite."""
    L = rng.normal(size=(15, 15)) * 0.01
    Phi = np.eye(15) + rng.normal(size=(nt, 15, 15)) * 0.01
    Lq = rng.normal(size=(nt, 15, 15)) * 1e-4
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=DEVICE)
                 for a in (L @ L.T, Phi, Lq @ Lq.transpose(0, 2, 1)))


def triage_inputs(torch, dtype, rng, F, M, cfg):
    """Triage inputs for F >= 4 tracks of M observations: each track's point
    seen along noisy lines from its n_obs camera centres (the first the
    anchor, rotated little, so that most points project into the image);
    unused observation slots zero, as in the track store. Track 1 lies
    behind its anchor, track 2 outside the image, track 3 has all weights
    zero."""
    t_a = rng.normal(size=(F, 3))
    R_a = _rotations(rng, F, 0.1)
    Ci = np.concatenate([rng.uniform(-1.0, 1.0, (F, 2)), rng.uniform(3.0, 8.0, (F, 1))], 1)
    Ci[1] = [0.1, 0.1, -5.0]
    Ci[2] = [15.0, 0.0, 5.0]
    wp = t_a + np.einsum("fij,fj->fi", R_a, Ci)
    live = np.arange(M)[None, :] < rng.integers(min(2, M), M + 1, F)[:, None]
    bases = t_a[:, None, :] + rng.normal(size=(F, M, 3))
    bases[:, 0] = t_a
    dirs = wp[:, None, :] - bases + rng.normal(size=(F, M, 3)) * 0.01
    bases[~live] = 0.0
    dirs[~live] = 0.0
    weights = np.where(live, rng.uniform(0.5, 1.0, (F, M)), 0.0)
    weights[3] = 0.0
    return tuple(torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=DEVICE)
                 for a in (bases, dirs, weights, R_a, t_a, cfg.K_np, cfg.K_inv_np))


def verification_inputs(torch, dtype, rng, F, M, cfg):
    """Seeded verification inputs for F x M pairs: observation poses near
    the current camera, keypoints in the image, a share of short
    baselines."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=DEVICE)

    camR = _rotations(rng, 1, 0.5)[0]
    camt = rng.normal(size=3)
    R1 = camR[None] @ _rotations(rng, F * M, 0.2)
    t1 = camt + rng.normal(size=(F * M, 3)) * np.where(rng.random((F * M, 1)) < 0.2, 0.003, 0.5)
    kp1 = rng.uniform([0, 0], [640, 480], size=(F * M, 2))
    kp2 = rng.uniform([0, 0], [640, 480], size=(F, 2))
    return (t(R1.reshape(F, M, 3, 3)), t(t1.reshape(F, M, 3)), t(kp1.reshape(F, M, 2)),
            t(kp2), t(camR), t(camt), t(cfg.K_np), t(cfg.K_inv_np))


def kernel_inputs(torch, dtype, rng, cfg):
    """Seeded inputs at the main path's shapes (U = u_max systems of
    n = 2 m_max rows; F x M = f_max x m_max verification pairs; a 9-tick P15
    block; a 1-tick propagation block)."""
    dev = torch.device(DEVICE)
    U, n, F, M = cfg.u_max, 2 * cfg.m_max, cfg.f_max, cfg.m_max

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    gating = tuple(map(t, gate_inputs(rng, U, n)))

    verification = verification_inputs(torch, dtype, rng, F, M, cfg)

    # P15 recurrence over the 9 IMU-only ticks of a frame block
    p15 = p15_inputs(torch, dtype, rng, 9)

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
    # the first step (identity null state), a padding tick, and nt = 9 with
    # two padding ticks: the kernel takes any nt
    propagate_checks = [prop_inputs(1, 0, 0), prop_inputs(2, 5, 1), prop_inputs(9, 7, 2)]

    triage = triage_inputs(torch, dtype, rng, F, M, cfg)

    # update terms at U = u_max, 2M = 64 over the camera span, D = 6N = 192,
    # as the filter calls it: each observation's two rows in one 6-column
    # camera block; the last 8 tracks are padding (sel_ok False, zero rows); residuals of a random
    # scale per track, so that some tracks fail their chi-square threshold;
    # track 2's threshold is NaN; track 5 observes only the last camera
    # slot, whose block of P is -I, so that its S is not positive definite.
    N = cfg.n_cam_slots
    D = 6 * N
    H = np.zeros((U, n, D))
    Hf = np.zeros((U, n, 3))
    ru = np.zeros((U, n))
    n_obs = rng.integers(2, M + 1, U)
    n_obs[U - 8:] = 0
    for u in range(U):
        k = int(n_obs[u])
        slots = np.full(k, N - 1) if u == 5 else rng.integers(0, N - 1, k)
        for m_, c_ in enumerate(slots):
            H[u, 2 * m_:2 * m_ + 2, 6 * c_:6 * c_ + 6] = rng.normal(size=(2, 6))
        Hf[u, :2 * k] = rng.normal(size=(2 * k, 3))
        ru[u, :2 * k] = rng.normal(size=2 * k) * cfg.sigma_image * rng.uniform(0.5, 2.0)
    Lp = rng.normal(size=(D, D)) * (0.003 / np.sqrt(D))
    P = Lp @ Lp.T + 1e-5 * np.eye(D)
    last = slice(6 * (N - 1), D)
    P[last, :] = 0.0
    P[:, last] = 0.0
    P[last, last] = -np.eye(6)
    from scipy.stats import chi2

    dof_u = np.clip(2 * n_obs - 3, 0, n)
    crit_u = np.where(dof_u > 0, chi2.ppf(0.95, np.maximum(dof_u, 1)), np.nan)
    crit_u[2] = np.nan
    update = (t(H), t(Hf), t(ru), t(P), t(crit_u),
              torch.as_tensor(np.arange(U) < U - 8, device=dev))
    return gating, verification, p15, propagate, propagate_checks, triage, update


def phase_kernels(torch, K, cfg, rng):
    """Kernel vs plain version on the card, both dtypes. Returns the float32
    rows for the kernels line, keyed by kernel name."""
    from msckf_tpu_torch.ops.smallmat import default_rcond

    rows = {}
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        (gating, verification, p15, propagate, propagate_checks, triage,
         update) = kernel_inputs(torch, dtype, rng, cfg)
        sz = torch.empty((), dtype=dtype).element_size()
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
        dev_ms = kernel_only_ms(torch, lambda: K.batched_gating_gamma(S, r), "gate_kernel")
        plain = time_ms(torch, lambda: K.batched_gating_gamma_plain(S, r))

        def library():
            L, _ = torch.linalg.cholesky_ex(S)
            sol = torch.cholesky_solve(r[..., None], L)[..., 0]
            return torch.sum(r * sol, dim=-1)

        lib = time_ms(torch, library)
        bms, bby = kernel_bound("batched_gating_gamma", (U, n), dtype_name)
        log(f"gating        U={U} n={n}: max abs {ea:.3e} rel {er:.3e}; {n_pass}/{U} pass "
            f"(decisions equal); kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, cholesky_ex+cholesky_solve {lib:.4f} ms, bound {bms:.6f} ms ({bby})")
        rows["batched_gating_gamma"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                            by=bby, lib=lib)
        check_gate_shapes(torch, K, dtype_name, rng)

        # 2. verification (bitwise equal by construction: no FMA contraction,
        # the plain version's order of every product and sum)
        F, M = verification[1].shape[:2]
        out_k = K.verification_scores(*verification)
        out_p = K.verification_scores_plain(*verification)
        torch.cuda.synchronize()
        check(all(same_bits(torch, a, b) for a, b in zip(out_k, out_p)),
              "verification: homo, epi or base not bitwise equal to the plain version")
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
        bms, bby = kernel_bound("verification_scores", (F, M), dtype_name)
        log(f"verification  F={F} M={M}: homo, epi and base bitwise equal to the plain "
            f"version; {int(dk.sum())} rejections, {int(short.sum())} short baselines "
            f"(decisions equal); kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms ({bby}); plan (threads, blocks) "
            f"{K.verification_plan(F, M)}")
        rows["verification_scores"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                           by=bby, lib=None)
        log_verification_call(torch, K, verification)
        check_verification_shapes(torch, K, dtype_name, rng, cfg)
        if dtype_name == "float32":
            log_launch_floor(torch)

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
        bms, bby = kernel_bound("p15_recurrence_fused", (B,), dtype_name)
        log(f"p15           B={B}: max abs {ea:.3e} rel {er:.3e}; kernel {ms:.4f} ms "
            f"(kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, bound {bms:.8f} ms ({bby})")
        log(_per_output(errs))
        rows["p15_recurrence_fused"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                            by=bby, lib=None)
        check_p15_shapes(torch, K, dtype_name, rng)

        # 4. propagation block (nt = 1 as on the path; the first-step null
        # state, a padding tick and nt = 9 are checked too)
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
        bms, bby = kernel_bound("propagate_block_fused", (Bp,), dtype_name)
        log(f"propagate     nt={Bp}: max abs {ea:.3e} rel {er:.3e} (also first step, padding "
            f"tick, nt=9 with two padding ticks); kernel {ms:.4f} ms (kernel only "
            f"{_fmt_ms(dev_ms)}), plain {plain:.4f} ms, bound {bms:.8f} ms ({bby})")
        log(_per_output(errs))
        rows["propagate_block_fused"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                             by=bby, lib=None)

        # 5. triage (bitwise equal by construction: no FMA contraction, the
        # plain version's order of summation)
        rcond = default_rcond(dtype)
        targs = (*triage, rcond, cfg.width, cfg.height)
        F, M = triage[2].shape
        out_k = K.triage_refresh_fused(*targs)
        out_p = K.triage_refresh_fused_plain(*targs)
        torch.cuda.synchronize()
        ok = out_k[2]
        check(all(same_bits(torch, a, b) for a, b in zip(out_k, out_p)),
              "triage: m, rho or ok not bitwise equal to the plain version")
        check(not ok[1] and not ok[2], "triage: a point behind or outside its anchor passed")
        errs = {"m": assert_close("triage m", out_k[0], out_p[0], tol, floor=True),
                "rho": assert_close("triage rho", out_k[1], out_p[1], tol)}
        ea, er = _worst(errs)
        ms = time_ms(torch, lambda: K.triage_refresh_fused(*targs))
        dev_ms = kernel_only_ms(torch, lambda: K.triage_refresh_fused(*targs), "triage_kernel")
        plain = time_ms(torch, lambda: K.triage_refresh_fused_plain(*targs))
        bms, bby = kernel_bound("triage_refresh_fused", (F, M), dtype_name)
        log(f"triage        F={F} M={M}: m, rho and ok bitwise equal to the plain version; "
            f"{int(ok.sum())}/{F} ok; kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}), "
            f"plain {plain:.4f} ms, bound {bms:.6f} ms ({bby}); plan {K.triage_plan(F, M, 1, sz)}")
        rows["triage_refresh_fused"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                            by=bby, lib=None)
        check_triage_shapes(torch, K, dtype_name, rng, cfg)

        # 6. fused update terms. The kernel builds S by its own loops and the
        # plain version by matrix products, so gamma differs by round-off:
        # a decision may differ only where gamma lies within the tolerance
        # of its threshold. A and c are compared on the kernel's decisions.
        H, Hf, ru, P, crit, sel_ok = update
        U, n2, D = H.shape
        sigma2 = cfg.sigma_image**2
        uargs = (H, Hf, ru, P, crit, sel_ok, sigma2, rcond)
        out = K.update_terms_fused(*uargs)
        again = K.update_terms_fused(*uargs)
        torch.cuda.synchronize()
        p_k = out[2]
        check(all(same_bits(torch, x, y) for x, y in zip(out, again)), "update terms: runs differ")
        H_t, _, gamma = K.update_terms_gamma_plain(H, Hf, ru, P, sigma2, rcond)
        check(not torch.isfinite(gamma[5]) and not p_k[5], "update terms: a non-PD S passed")
        check(not p_k[2] and not p_k[~sel_ok].any(), "update terms: NaN crit or padding passed")
        errs, near = check_update_terms(torch, K, "update terms", out, update, sigma2, rcond, tol)
        ea, er = _worst(errs)
        ms = time_ms(torch, lambda: K.update_terms_fused(*uargs))
        dev_ms = kernel_only_ms(torch, lambda: K.update_terms_fused(*uargs), UPDATE_KERNELS)
        split = launch_split(torch, lambda: K.update_terms_fused(*uargs))
        plain = time_ms(torch, lambda: K.update_terms_fused_plain(*uargs))
        mm = update_matmul_ms(torch, H_t, P)
        bms, bby = kernel_bound("update_terms_fused", (U, n2, D), dtype_name)
        log(f"update terms  U={U} 2M={n2} D={D}: max abs {ea:.3e} rel {er:.3e}; "
            f"{int(p_k.sum())}/{U} pass, "
            + (f"decisions differ within tolerance of the threshold on {near}; " if near
               else "decisions equal; ")
            + f"kernel {ms:.4f} ms (kernel only {_fmt_ms(dev_ms)}: {split}), "
            f"plain {plain:.4f} ms, matmul yardstick {mm:.4f} ms, bound {bms:.6f} ms ({bby})")
        log(_per_output(errs))
        rows["update_terms_fused"] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain, bound=bms,
                                          by=bby, lib=None, matmul=mm)
        check_update_ragged(torch, K, dtype_name, rng)
        if dtype_name == "float32":
            rows32 = dict(rows)
    return rows32


def launch_split(torch, fn) -> str:
    """Device time per call of each of update_terms_fused's launches."""
    return ", ".join(f"{m} {_fmt_ms(kernel_only_ms(torch, fn, m))}" for m in UPDATE_LAUNCHES)


def check_gate_shapes(torch, K, dtype_name, rng):
    """The gate kernel at n beyond the main path's 64 (GATE_SHAPES and, in
    float64, GATE_GLOBAL_N, whose working set lies in the global scratch):
    the negative pivot fails, decisions equal to the plain version's, gamma
    within the tolerance; a batched launch of two sequences bitwise equal
    to its single launches."""
    dtype = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    shapes = GATE_SHAPES + ((GATE_GLOBAL_N,) if dtype_name == "float64" else ())
    for n in shapes:
        S, r, crit = (torch.as_tensor(a, dtype=dtype, device=DEVICE)
                      for a in gate_inputs(rng, GATE_U, n))
        g_k = K.batched_gating_gamma(S, r)
        g_p = K.batched_gating_gamma_plain(S, r)
        torch.cuda.synchronize()
        check(not torch.isfinite(g_k[3]), f"gating n={n}: negative pivot gave a finite gamma")
        check(torch.equal(g_k <= crit, g_p <= crit), f"gating n={n}: gate decisions differ")
        ea, er = assert_close(f"gating n={n} gamma", g_k, g_p, tol)
        half = GATE_U // 2
        g_b = torch.func.vmap(K.batched_gating_gamma)(S.view(2, half, n, n), r.view(2, half, n))
        g_1 = K.batched_gating_gamma(S[half:].contiguous(), r[half:].contiguous())
        torch.cuda.synchronize()
        check(same_bits(torch, g_b.reshape(-1), g_k) and same_bits(torch, g_b[1], g_1),
              f"gating n={n}: batched launch differs from single launches")
        scratch = K.gate_scratch_elems(dtype, n, S.device)
        dev_ms = kernel_only_ms(torch, lambda: K.batched_gating_gamma(S, r), "gate_kernel")
        log(f"gating        U={GATE_U} n={n}: max abs {ea:.3e} rel {er:.3e}; "
            f"{int((g_k <= crit).sum())}/{GATE_U} pass (decisions equal), negative pivot "
            f"fails, batched (B=2) bitwise equal to single; working set in "
            + (f"the global scratch ({scratch} elements per system)" if scratch
               else "shared memory")
            + f"; kernel only {_fmt_ms(dev_ms)}")


def check_verification_shapes(torch, K, dtype_name, rng, cfg):
    """The verification kernel at VERIFY_SHAPES: homo, epi and base bitwise
    equal to the plain version's, and a batched launch of VERIFY_BATCH
    sequences bitwise equal to its single launches (each single launch
    reads its sequence through a view at the sequence's offset) and to a
    batched launch with K and K^-1 shared."""
    dtype = getattr(torch, dtype_name)
    for F, M in VERIFY_SHAPES:
        draws = [verification_inputs(torch, dtype, rng, F, M, cfg) for _ in range(VERIFY_BATCH)]
        stacked = [torch.stack([d[j] for d in draws]) for j in range(8)]
        K.reset_launches()
        out = torch.func.vmap(K.verification_scores)(*stacked)
        # K and K^-1 shared by the sequences (stride 0), as on the batched loop
        shared = torch.func.vmap(lambda *a: K.verification_scores(*a, *draws[0][6:]))(
            *stacked[:6])
        torch.cuda.synchronize()
        check(K.LAUNCHES["verification_scores"] == 2,
              "verification batched: more than one launch a batched call")
        check(all(same_bits(torch, a, w) for a, w in zip(shared, out)),
              f"verification F={F} M={M} batched: shared K and K^-1 change the scores")
        for b in range(VERIFY_BATCH):
            one = K.verification_scores(*(x[b] for x in stacked))
            want = K.verification_scores_plain(*draws[b])
            torch.cuda.synchronize()
            check(all(same_bits(torch, a, w) for a, w in zip(one, want)),
                  f"verification F={F} M={M}: not bitwise equal to the plain version")
            check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
                  f"verification F={F} M={M} batched: sequence {b} differs from its single "
                  f"launch")
        dev_ms = kernel_only_ms(torch, lambda: K.verification_scores(*draws[0]),
                                "verification_kernel")
        log(f"verification  F={F} M={M}: homo, epi and base bitwise equal to the plain version "
            f"over {VERIFY_BATCH} draws (single launches on views at each sequence's offset), "
            f"the batched launch (B={VERIFY_BATCH}, K and K^-1 batched or shared) bitwise equal "
            f"to the single ones; plan "
            f"{K.verification_plan(F, M)}; kernel only {_fmt_ms(dev_ms)}")


def log_verification_call(torch, K, args):
    """Device time of every kernel a verification call launches, single and
    batched (B = BATCH copies), beside that of a torch.cat of the call's
    four constants (camR, camt, K, K^-1) into one (B, 30) array: the op a
    launch that takes them by one pointer would add to each call."""
    stacked = [torch.stack([x] * BATCH) for x in args]
    res = []
    for B, xs, call in ((1, args, lambda: K.verification_scores(*args)),
                        (BATCH, stacked, lambda: torch.func.vmap(K.verification_scores)(*stacked))):
        consts = [x.reshape(B, -1) for x in xs[4:]]
        whole = kernel_only_ms(torch, call)
        gather = kernel_only_ms(torch, lambda: torch.cat(consts, dim=1))
        res.append(f"B={B}: whole call {_fmt_ms(whole)}, torch.cat of the constants "
                   f"{_fmt_ms(gather)}")
    log("verification  device time (every kernel launched): " + "; ".join(res))


def log_launch_floor(torch):
    """The launch floor: the device time (profiler) and the call time (CUDA
    events) of a one-element fill on the card, the least any kernel's
    launch costs."""
    x = torch.empty(1, device=DEVICE)
    dev_ms = kernel_only_ms(torch, lambda: x.fill_(1.0), "elementwise_kernel")
    ms = time_ms(torch, lambda: x.fill_(1.0))
    log(f"launch floor  one-element fill_: kernel only {_fmt_ms(dev_ms)}, call {ms:.4f} ms")


def check_triage_shapes(torch, K, dtype_name, rng, cfg):
    """The triage kernel at TRIAGE_SHAPES (a ragged last block, M past one
    warp, M = 1, F and M below one block's plan): m, rho and ok bitwise
    equal to the plain version's, and a batched launch of TRIAGE_BATCH
    sequences bitwise equal to its single launches."""
    from msckf_tpu_torch.ops.smallmat import default_rcond

    dtype = getattr(torch, dtype_name)
    sz = torch.empty((), dtype=dtype).element_size()
    scalars = (default_rcond(dtype), cfg.width, cfg.height)
    for F, M in TRIAGE_SHAPES:
        draws = [triage_inputs(torch, dtype, rng, F, M, cfg) for _ in range(TRIAGE_BATCH)]
        singles = []
        for args in draws:
            out_k = K.triage_refresh_fused(*args, *scalars)
            out_p = K.triage_refresh_fused_plain(*args, *scalars)
            torch.cuda.synchronize()
            check(all(same_bits(torch, a, b) for a, b in zip(out_k, out_p)),
                  f"triage F={F} M={M}: m, rho or ok not bitwise equal to the plain version")
            # (with one observation the intersection is degenerate: no test)
            check(M == 1 or (not out_k[2][1] and not out_k[2][2]),
                  f"triage F={F} M={M}: a point behind or outside its anchor passed")
            singles.append(out_k)
        stacked = [torch.stack([d[j] for d in draws]) for j in range(7)]
        K.reset_launches()
        out = torch.func.vmap(lambda *a: K.triage_refresh_fused(*a, *scalars))(*stacked)
        torch.cuda.synchronize()
        check(K.LAUNCHES["triage_refresh_fused"] == 1, "triage batched: more than one launch")
        for b, one in enumerate(singles):
            check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
                  f"triage F={F} M={M} batched: sequence {b} differs from its single launch")
        dev_ms = kernel_only_ms(torch, lambda: K.triage_refresh_fused(*draws[0], *scalars),
                                "triage_kernel")
        log(f"triage        F={F} M={M}: m, rho and ok bitwise equal to the plain version over "
            f"{TRIAGE_BATCH} draws, the batched launch (B={TRIAGE_BATCH}) bitwise equal to the "
            f"single ones; plan {K.triage_plan(F, M, 1, sz)}; kernel only {_fmt_ms(dev_ms)}")


def check_p15_shapes(torch, K, dtype_name, rng):
    """The P15 recurrence at P15_TICKS ticks (one chunk, several chunks of
    the ring): within the tolerance of the plain version, and a batched
    launch of P15_BATCH sequences bitwise equal to its single launches."""
    dtype = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    sz = torch.empty((), dtype=dtype).element_size()
    for nt in P15_TICKS:
        draws = [p15_inputs(torch, dtype, rng, nt) for _ in range(P15_BATCH)]
        singles, errs = [], {}
        for b, args in enumerate(draws):
            out_k = K.p15_recurrence_fused(*args)
            out_p = K.p15_recurrence_fused_plain(*args)
            torch.cuda.synchronize()
            for nm, a, w in zip(("P", "Phi_acc", "sig"), out_k, out_p):
                errs[f"{nm}{b}"] = assert_close(f"p15 nt={nt} {nm}", a, w, tol, floor=True)
            singles.append(out_k)
        stacked = [torch.stack([d[j] for d in draws]) for j in range(3)]
        K.reset_launches()
        out = torch.func.vmap(K.p15_recurrence_fused)(*stacked)
        torch.cuda.synchronize()
        check(K.LAUNCHES["p15_recurrence_fused"] == 1, "p15 batched: more than one launch")
        for b, one in enumerate(singles):
            check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
                  f"p15 nt={nt} batched: sequence {b} differs from its single launch")
        ea, er = _worst(errs)
        dev_ms = kernel_only_ms(torch, lambda: K.p15_recurrence_fused(*draws[0]), "p15_kernel")
        log(f"p15           nt={nt}: max abs {ea:.3e} rel {er:.3e} over {P15_BATCH} draws, the "
            f"batched launch (B={P15_BATCH}) bitwise equal to the single ones; plan (ticks a "
            f"chunk, chunks, shared bytes) {K.p15_plan(nt, sz)}; kernel only {_fmt_ms(dev_ms)}")


def update_matmul_ms(torch, H_t, P) -> float:
    """Yardstick beside the update-terms kernel (never called by the port):
    CUDA-event time of the three products the hybrid path computes for the
    same work (filter/update.py:236-237, 250), by torch.matmul in float32
    with TF32 off: H~P over all tracks, S per track, A over all rows.
    H_t (..., U, 2M, D), P (..., D, D)."""
    Hf = H_t.float().contiguous()
    Pf = P.float().unsqueeze(-3)
    rows = Hf.flatten(-3, -2)

    def run():
        S = torch.matmul(torch.matmul(Hf, Pf), Hf.transpose(-1, -2))
        return S, torch.matmul(rows.transpose(-1, -2), rows)

    return time_ms(torch, run)


def ragged_update_inputs(torch, dtype, rng, U, R2, D):
    """The CPU tests' update-terms inputs (tests/test_torch_kernels.py::
    _update_terms_inputs) on the card: rows beyond 8 zero (padding
    observations), track 1's threshold fails, track 2's is NaN, track U - 1
    is an unused slot (sel_ok False), and an inf Jacobian entry in track 3
    must fail the gate and add nothing to A and c."""
    dev = torch.device(DEVICE)
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
    return tuple(torch.as_tensor(a, dtype=dtype, device=dev) for a in (H, Hf, r, Pm @ Pm.T, crit)) \
        + (torch.as_tensor(sel_ok, device=dev),)


def check_update_terms(torch, K, name, out, args, sigma2, rcond, tol):
    """One update_terms_fused result against the plain version: decisions
    equal, or different only where gamma lies within the tolerance of its
    threshold; A and c on the kernel's decisions within rtol (scaled by
    their largest entry). Returns (errors, tracks decided near threshold)."""
    A_k, c_k, p_k = out
    H, Hf, ru, P, crit, sel_ok = args
    H_t, r_t, gamma = K.update_terms_gamma_plain(H, Hf, ru, P, sigma2, rcond)
    p_p = sel_ok & (gamma <= crit)
    near = []
    for u in torch.nonzero(p_k != p_p)[:, 0].tolist():
        g, cr = float(gamma[u]), float(crit[u])
        check(abs(g - cr) <= tol * abs(cr),
              f"{name}: gate decision differs on track {u} (gamma {g}, crit {cr})")
        near.append(f"track {u} (gamma {g:.6g}, crit {cr:.6g})")
    A_p, c_p = K.update_terms_masked_plain(H_t, r_t, p_k)
    return {"A": assert_close(f"{name} A", A_k, A_p, tol, floor=True),
            "c": assert_close(f"{name} c", c_k, c_p, tol, floor=True)}, near


def launch1_form(torch, fn) -> str:
    """Which form of its first launch one update_terms_fused call took, by
    the kernels the profiler saw it launch: "fast" (update_track_kernel) or
    "general" (update_project_kernel, update_s_kernel)."""
    from torch.profiler import ProfilerActivity, profile

    # the profiler now and then hands back a window without the device's
    # kernel records (only the runtime's calls), or without its first one:
    # the window holds two calls, and one that tells nothing is taken again,
    # up to three times
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()]
        fast = any("update_track_kernel" in k for k in keys)
        general = any("update_s_kernel" in k for k in keys)
        if fast or general:
            break
    check(fast != general, f"update terms: launch 1's form not told by the profile ({keys})")
    return "fast" if fast else "general"


def check_update_ragged(torch, K, dtype_name, rng):
    """update_terms_fused at shapes that are not multiples of its tiles
    (ragged columns, rows, panels and chunks), single and batched: against
    the plain version, the padding, NaN, failing and inf tracks rejected,
    repeated calls bitwise equal, and a batched launch of RAGGED_BATCH
    sequences bitwise equal to its single launches."""
    dtype = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    sigma2, rcond = 0.01, 1e-12
    for U, R2, D in RAGGED_UPDATE_SHAPES:
        draws = [ragged_update_inputs(torch, dtype, rng, U, R2, D) for _ in range(RAGGED_BATCH)]
        path = launch1_form(torch, lambda: K.update_terms_fused(*draws[0], sigma2, rcond))
        singles = []
        errs, near = {}, []
        for b, args in enumerate(draws):
            out = K.update_terms_fused(*args, sigma2, rcond)
            again = K.update_terms_fused(*args, sigma2, rcond)
            torch.cuda.synchronize()
            check(all(same_bits(torch, x, y) for x, y in zip(out, again)),
                  f"update terms ragged {U}x{R2}x{D}: runs differ")
            check(not out[2][[1, 2, 3, U - 1]].any(),
                  f"update terms ragged {U}x{R2}x{D}: a failing, NaN, inf or unused track passed")
            check(bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all()),
                  f"update terms ragged {U}x{R2}x{D}: A or c not finite")
            e, nr = check_update_terms(torch, K, f"update terms ragged {U}x{R2}x{D}", out, args,
                                       sigma2, rcond, tol)
            errs.update({f"{k}{b}": v for k, v in e.items()})
            near += nr
            singles.append(out)
        stacked = [torch.stack([d[j] for d in draws]) for j in range(6)]
        K.reset_launches()
        out = torch.func.vmap(lambda *a: K.update_terms_fused(*a, sigma2, rcond))(*stacked)
        torch.cuda.synchronize()
        check(K.LAUNCHES["update_terms_fused"] == 1,
              f"update terms ragged batched: {K.LAUNCHES['update_terms_fused']} launches")
        for b, one in enumerate(singles):
            check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
                  f"update terms ragged {U}x{R2}x{D} batched: sequence {b} differs from its "
                  "single launch")
        ea, er = _worst(errs)
        log(f"update terms  ragged U={U} 2M={R2} D={D} ({path} launch 1): max abs {ea:.3e} "
            f"rel {er:.3e} over "
            f"{RAGGED_BATCH} draws; "
            + (f"decisions near the threshold on {near}; " if near else "decisions equal; ")
            + f"padding, NaN, failing and inf tracks rejected; repeated calls and the batched "
            f"launch (B={RAGGED_BATCH}) bitwise equal to the single ones")


def check_propagate_shared(torch, K, tensors, stacked_out):
    """The propagation block's batched launch as the batched loop makes it:
    qc and gravity shared by the sequences (not mapped by the vmap), so
    they reach the kernel with stride 0. One launch, bitwise equal to the
    launch with them stacked and to each sequence's single launch."""
    qc, g = tensors[11][0], tensors[12][0]
    check(all(torch.equal(tensors[11][b], qc) and torch.equal(tensors[12][b], g)
              for b in range(tensors[7].shape[0])),
          "propagate shared: the draws do not share qc and gravity")
    in_dims = (0,) * 11 + (None, None, 0)
    K.reset_launches()
    out = torch.func.vmap(K.propagate_block_fused, in_dims=in_dims)(
        *tensors[:11], qc, g, tensors[13])
    torch.cuda.synchronize()
    check(K.LAUNCHES["propagate_block_fused"] == 1,
          f"propagate shared: {K.LAUNCHES['propagate_block_fused']} launches for one call")
    check(all(same_bits(torch, o, w) for o, w in zip(out, stacked_out)),
          "propagate shared: differs from the launch with qc and gravity stacked")
    for b in range(tensors[7].shape[0]):
        one = K.propagate_block_fused(*(x[b] for x in tensors[:11]), qc, g, tensors[13][b])
        check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
              f"propagate shared: sequence {b} differs from its single launch")
    log(f"propagate_block_fused  batched B={tensors[7].shape[0]} with qc and gravity shared "
        f"(stride 0): one launch, bitwise equal to the stacked launch and to its single ones")


def same_bits(torch, a, b) -> bool:
    """Bitwise equality, NaNs included."""
    if a.dtype.is_floating_point:
        iv = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


def phase_kernels_batched(torch, K, cfg, rng):
    """Each kernel's batched form: its op under torch.func.vmap over BATCH
    sequences of seeded inputs (BATCH draws of kernel_inputs), which the
    op's vmap rule runs as one launch. Held bitwise against one single
    launch per sequence and, within the kernel's tolerance, against the
    plain version over the batch axis. Returns the float32 rows."""
    from msckf_tpu_torch.ops.smallmat import default_rcond

    rows = {}
    for dtype_name in ("float32", "float64"):
        dtype = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        draws = [kernel_inputs(torch, dtype, rng, cfg) for _ in range(BATCH)]

        def stacked(i, n=BATCH):
            return [torch.stack([d[i][j] for d in draws[:n]]) for j in range(len(draws[0][i]))]

        rcond = default_rcond(dtype)
        sigma2 = cfg.sigma_image**2
        S, r, crit = stacked(0)
        U, n = r.shape[1:]
        F, M = draws[0][1][1].shape[:2]
        H, Hf, ru, P, ucrit, sel_ok = stacked(6, BATCH if dtype_name == "float32" else 4)
        Uu, n2, D = H.shape[1:]

        def gating_plain(S, r):
            return K.batched_gating_gamma_plain(S.flatten(0, 1), r.flatten(0, 1)).view(r.shape[:2])

        def update_plain(H, Hf, r, P, crit, sel_ok, sigma2, rcond):
            # on the kernel's decisions, as the single check does (below)
            return K.update_terms_masked_plain(*K.update_terms_gamma_plain(
                H, Hf, r, P, sigma2, rcond)[:2], upd_passed)

        cases = (
            ("batched_gating_gamma", K.batched_gating_gamma, (S, r), (), gating_plain,
             "gate_kernel", (U, n)),
            ("verification_scores", K.verification_scores, stacked(1), (),
             K.verification_scores_plain, "verification_kernel", (F, M)),
            ("p15_recurrence_fused", K.p15_recurrence_fused, stacked(2), (),
             K.p15_recurrence_fused_plain, "p15_kernel", (draws[0][2][1].shape[0],)),
            ("propagate_block_fused", K.propagate_block_fused, stacked(3), (),
             K.propagate_block_fused_plain, "propagate_kernel", (draws[0][3][7].shape[0],)),
            ("triage_refresh_fused", K.triage_refresh_fused, stacked(5),
             (rcond, cfg.width, cfg.height), K.triage_refresh_fused_plain, "triage_kernel",
             (F, M)),
            ("update_terms_fused", K.update_terms_fused, (H, Hf, ru, P, ucrit, sel_ok),
             (sigma2, rcond), update_plain, UPDATE_KERNELS, (Uu, n2, D)),
        )
        log(f"-- batched kernels, {dtype_name} (tolerance rtol {tol}; update terms at "
            f"B={H.shape[0]}, the others at B={BATCH})")
        for name, op, tensors, scalars, plain, match, dims in cases:
            Bn = tensors[0].shape[0]

            def run():
                return torch.func.vmap(lambda *a: op(*a, *scalars))(*tensors)

            torch.cuda.synchronize()
            K.reset_launches()
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message=".*batching rule.*")
                out = run()
            torch.cuda.synchronize()
            check(K.LAUNCHES[name] == 1,
                  f"{name} batched: {K.LAUNCHES[name]} launches for one batched call")
            out = out if isinstance(out, tuple) else (out,)
            for b in range(Bn):
                one = op(*(x[b] for x in tensors), *scalars)
                one = one if isinstance(one, tuple) else (one,)
                check(all(same_bits(torch, o[b], w) for o, w in zip(out, one)),
                      f"{name} batched: sequence {b} differs from its single launch")
            if name == "update_terms_fused":
                upd_passed = out[2]
                upd_Ht = K.update_terms_gamma_plain(*tensors[:4], *scalars)[0]
            want = plain(*tensors, *scalars)
            want = want if isinstance(want, tuple) else (want,)
            errs = {}
            for i, (o, w) in enumerate(zip(out, want)):
                if o.dtype == torch.bool:
                    check(torch.equal(o, w), f"{name} batched: decisions differ from plain")
                elif o.dtype.is_floating_point:
                    errs[i] = assert_close(f"{name} batched output {i}", o, w, tol, floor=True)
            if name == "batched_gating_gamma":
                check(torch.equal(out[0] <= crit, want[0] <= crit),
                      "gating batched: gate decisions differ from plain")
            if name in ("triage_refresh_fused", "verification_scores"):
                check(all(same_bits(torch, o, w) for o, w in zip(out, want)),
                      f"{name} batched: not bitwise equal to the plain version")
            ea, er = _worst(errs)
            ms = time_ms(torch, run)
            dev_ms = kernel_only_ms(torch, run, match)
            plain_ms = time_ms(torch, lambda: plain(*tensors, *scalars))
            bms, bby = kernel_bound(name, dims, dtype_name, Bn)
            lib = mm = None
            split = ""
            if name == "update_terms_fused":
                mm = update_matmul_ms(torch, upd_Ht, tensors[3])
                split = f" ({launch_split(torch, run)}), matmul yardstick {mm:.4f} ms"
            if name == "batched_gating_gamma":  # the single check's yardstick, all systems
                Sf, rf = S.flatten(0, 1), r.flatten(0, 1)

                def library():
                    L, _ = torch.linalg.cholesky_ex(Sf)
                    return torch.sum(rf * torch.cholesky_solve(rf[..., None], L)[..., 0], dim=-1)

                lib = time_ms(torch, library)
            log(f"{name:22s} batched B={Bn}: bitwise equal to {Bn} single launches; max abs "
                f"{ea:.3e} rel {er:.3e} vs plain; call {ms:.4f} ms (kernel only "
                f"{_fmt_ms(dev_ms)}{split}), plain {plain_ms:.4f} ms, "
                + (f"cholesky_ex+cholesky_solve {lib:.4f} ms, " if lib is not None else "")
                + f"bound {bms:.6f} ms ({bby})")
            rows[name] = dict(err=ea, ms=ms, dev=dev_ms, plain=plain_ms, bound=bms, by=bby,
                              lib=lib, B=Bn, matmul=mm)
            if name == "propagate_block_fused":
                check_propagate_shared(torch, K, tensors, out)
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


def path_kernels(cfg) -> set:
    """The kernels a configuration's frame loop launches: none with
    ``use_pallas=False``, the master switch; no triage kernel under
    ``triangulation="gn"``."""
    if not cfg.use_pallas:
        return set()
    names = {"verification_scores"}
    if cfg.use_pallas_propagation:
        names |= {"propagate_block_fused", "p15_recurrence_fused"}
    if cfg.use_pallas_triage and cfg.triangulation != "gn":
        names.add("triage_refresh_fused")
    if cfg.update_kernel == "fused":
        names.add("update_terms_fused")
    elif cfg.update_kernel == "hybrid" and cfg.gating_solver not in ("xla", "ns"):
        names.add("batched_gating_gamma")
    return names


def _block_kind(B: int, cfg) -> str:
    """The propagation kernel of a block of B ticks ("scan": none; every
    block is a scan when the configuration's propagation kernels are off)."""
    if "propagate_block_fused" not in path_kernels(cfg):
        return "scan"
    return "propagate_block_fused" if B <= 2 else ("p15_recurrence_fused" if B <= 64 else "scan")


def predicted_launches(K, cfg, stats, C: int, B: int, Bp: int) -> dict:
    """Launches of each kernel over one run of C frame blocks of B ticks
    after a Bp-tick prefix, from the loop's own counts: the propagation
    kernels by block length; verification once per camera step; the triage
    once per camera step and once per prune (the prune triages whether or
    not it then updates); the update kernel once per update."""
    pred = dict.fromkeys(K.LAUNCHES, 0)
    for kind in (_block_kind(Bp, cfg), *[_block_kind(1, cfg), _block_kind(B - 1, cfg)] * C):
        if kind != "scan":
            pred[kind] += 1
    if "verification_scores" in path_kernels(cfg):
        pred["verification_scores"] = stats.camera_steps
    updates = stats.camera_steps + stats.prune_updates
    if "triage_refresh_fused" in path_kernels(cfg):
        pred["triage_refresh_fused"] = stats.camera_steps + stats.prunes
    for name in ("update_terms_fused", "batched_gating_gamma"):
        if name in path_kernels(cfg):
            pred[name] = updates
    return pred


def phase_parity(torch, pkg, K, seq, label, **overrides):
    cfg = pkg.reference_experiment_config(dtype="float64", f_max=512, u_max=64, k_max=512,
                                          **overrides)
    T = PARITY_TICKS
    res = {}
    for dev in (DEVICE, "cpu"):
        _, run = _run(torch, pkg, cfg, seq, dev, T)
        K.reset_launches()
        t0 = time.perf_counter()
        final, pre, fr = run()
        torch.cuda.synchronize()
        res[dev] = (final, pre, fr, time.perf_counter() - t0)
        if dev == DEVICE:
            card_launches = K.launch_counts()
    for k in path_kernels(cfg):
        check(card_launches[k] > 0, f"parity {label}: kernel {k} not launched on the card")
    (fg, pg, rg, tg), (fc, pc, rc, tc) = res[DEVICE], res["cpu"]
    for name in ("n_cams", "n_tracks"):
        check(np.array_equal(_flat(pg, rg, name), _flat(pc, rc, name)),
              f"parity {label}: {name} differ")
    counters = {}
    for k in ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
              "n_track_overflow", "n_update_overflow"):
        a, b = int(getattr(fg.diag, k)), int(getattr(fc.diag, k))
        check(a == b, f"parity {label}: {k} differs ({a} vs {b})")
        counters[k] = a
    worst = {}
    for name in ("p_WI", "v_WI", "R_WI"):
        d = float(np.abs(_flat(pg, rg, name) - _flat(pc, rc, name)).max())
        check(d <= 1e-7, f"parity {label}: {name} differs by {d}")
        worst[name] = d
    for name in ("sigma_pos", "sigma_rot"):
        a, b = _flat(pg, rg, name), _flat(pc, rc, name)
        check(np.allclose(a, b, rtol=1e-4, atol=1e-16), f"parity {label}: {name} differs")
        worst[name] = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300)).max())
    log(f"parity {label}: T={T} ticks, float64, card {tg:.2f} s vs CPU {tc:.2f} s; counters "
        f"equal {counters}; max |dp| {worst['p_WI']:.2e}, |dv| {worst['v_WI']:.2e}, "
        f"|dR| {worst['R_WI']:.2e}, sigma rel {max(worst['sigma_pos'], worst['sigma_rot']):.2e}")


def drive(torch, pkg, K, seq, cfg, label, max_ticks=None):
    """The configuration's driven run: launch counts set to 0 just before
    it and read just after; no overflow, launches equal to the loop's
    prediction, every kernel of the path launched, and over the whole circle
    a final position error under 0.2 m. Returns (run, stats, launches,
    number of frames, seconds)."""
    stats = pkg.FrameStats()
    std, run = _run(torch, pkg, cfg, seq, DEVICE, max_ticks, stats)
    C, B = std.frames["imu_ts"].shape
    Bp = std.prefix["imu_ts"].shape[0]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    final, _, _ = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    overflow = int(final.diag.n_track_overflow) + int(final.diag.n_update_overflow)
    check(overflow == 0, f"{label}: capacity overflow {overflow}")
    err_txt = ""
    if max_ticks is None:
        gt = seq.poses_t[len(seq.timestamps) - 1]
        err = float(np.linalg.norm(final.imu.p_WI.double().cpu().numpy() - gt))
        check(np.isfinite(err), f"{label}: non-finite final position ({err})")
        check(err < 0.2, f"{label}: final position error {err:.4f} m >= 0.2 m")
        err_txt = f"final error {err:.4f} m, "
    predicted = predicted_launches(K, cfg, stats, C, B, Bp)
    for k in path_kernels(cfg):
        check(launches[k] > 0, f"{label}: kernel {k} never launched")
    for k, v in launches.items():
        check(v == predicted[k], f"{label}: {k} launched {v} times, loop predicts {predicted[k]}")
    log(f"{label}: {C} frames x {B} ticks (+{Bp}-tick prefix), {cfg.dtype} filter, "
        f"{cfg.correction_dtype} island, use_pallas_triage={cfg.use_pallas_triage}, "
        f"update_kernel={cfg.update_kernel!r}, gain_solver={cfg.gain_solver!r}, "
        f"triangulation={cfg.triangulation!r}, use_pallas={cfg.use_pallas}, "
        f"f_max={cfg.f_max} u_max={cfg.u_max} "
        f"k_max={cfg.k_max} desc_dim={cfg.desc_dim}")
    log(f"{label}: {err_txt}overflow 0, {stats.camera_steps} camera steps, {stats.prunes} "
        f"prunes ({stats.prune_updates} with an update), launches "
        f"{ {k: v for k, v in launches.items() if v} } (= predicted; the others 0)")
    return run, stats, launches, C, seconds


def sync_check(torch, run, stats, label):
    """One run under PyTorch's sync-debug mode: every synchronizing call of
    the port must be one of the loop's counted branches (the rest is this
    function's own synchronize()). Returns the warnings by site."""
    before = stats.host_syncs
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    n_port = 0
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
            n_port += "msckf_tpu_torch" in Path(w.filename).parts
    check(n_port == stats.host_syncs - before,
          f"{label}: {n_port} synchronizing calls in the port, the loop counts "
          f"{stats.host_syncs - before}; by site {sites}")
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def timed_runs(torch, runs: dict, order) -> dict:
    """Host seconds of each named run (ending in a synchronize), taken in
    the given order of names."""
    times = {name: [] for name in runs}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    return times


def _rate(C, times) -> str:
    t = float(np.median(times))
    return (f"{C / t:.2f} camera frames/s, {t / C * 1e3:.3f} ms/frame (median of "
            f"{len(times)} runs {[round(x, 4) for x in times]} s)")


def phase_main(torch, pkg, K, seq):
    cfg = pkg.reference_experiment_config()  # the JAX package's default
    check(cfg.dtype == "float32" and cfg.correction_dtype == "float64"
          and cfg.use_pallas_triage and cfg.update_kernel == "hybrid"
          and cfg.gating_solver == "auto", "main: not the default configuration")
    run, stats, launches, C, first_s = drive(torch, pkg, K, seq, cfg, "main")
    driven_stats = copy.copy(stats)  # the run closure keeps counting into stats
    syncs, frames = stats.host_syncs, stats.frames
    sites = sync_check(torch, run, stats, "main")
    log(f"main: first run {first_s:.3f} s; host syncs per frame {syncs / frames:.3f} (the "
        f"loop's count: {syncs} over the driven run's {frames} frames); PyTorch sync-debug "
        f"warnings over one run: {sum(sites.values())}, by site {sites}")
    std, prof_run = _run(torch, pkg, cfg, seq, DEVICE, 20 + 10 * PROFILE_FRAMES)
    profile_window(torch, prof_run, std.frames["imu_ts"].shape[0], "main")
    return run, C, launches, first_s, driven_stats


def phase_driven(torch, pkg, K, seq, label, profile=False, **overrides):
    """A whole-circle configuration other than the default: its driven run
    and the sync check over SOLVER_TICKS (phase main's covers the prunes of
    the whole circle); with ``profile``, a PROFILE_FRAMES-frame profile."""
    cfg = pkg.reference_experiment_config(**overrides)
    run, stats, launches, C, first_s = drive(torch, pkg, K, seq, cfg, label)
    driven_stats = copy.copy(stats)  # the run closure keeps counting into stats
    syncs, frames = stats.host_syncs, stats.frames
    sstats = pkg.FrameStats()
    _, srun = _run(torch, pkg, cfg, seq, DEVICE, SOLVER_TICKS, sstats)
    sites = sync_check(torch, srun, sstats, label)
    log(f"{label}: first run {first_s:.3f} s; host syncs per frame {syncs / frames:.3f} (the "
        f"loop's count: {syncs} over {frames} frames); PyTorch sync-debug warnings over "
        f"{SOLVER_TICKS} ticks: {sum(sites.values())}, by site {sites}")
    if profile:
        std, prof_run = _run(torch, pkg, cfg, seq, DEVICE, 20 + 10 * PROFILE_FRAMES)
        profile_window(torch, prof_run, std.frames["imu_ts"].shape[0], label)
    return run, C, launches, first_s, driven_stats


def compare_rates(torch, kernel_rows, driven: dict):
    """Frames/s over the whole circle of each driven configuration, 2 runs
    each: the driven run (in the order the phases ran), then one more in
    reverse order (CBA) within this call; the kernels' share of the frame
    time from launches x kernel call time."""
    runs = {name: run for name, (run, *_) in driven.items()}
    C = next(iter(driven.values()))[1]
    names = list(runs)
    times = timed_runs(torch, runs, names[::-1])
    for name in names:
        times[name].insert(0, driven[name][3])
    med = {name: float(np.median(t)) for name, t in times.items()}
    for name in names:
        launches = driven[name][2]
        kernel_ms = sum(launches[k] * kernel_rows[k]["ms"] for k in launches)
        log(f"rates: {name} {_rate(C, times[name])}; kernels' share of the frame time "
            f"{kernel_ms / (med[name] * 1e3) * 100:.2f}% ({kernel_ms:.3f} ms of "
            f"{med[name] * 1e3:.1f} ms per run, from launches x kernel ms)")
    if "default" in med:
        ratios = ", ".join(f"{name} / default {med['default'] / med[name]:.3f}"
                           for name in names if name != "default")
        order = names + names[::-1]
        log(f"rates: frames/s ratios {ratios} (runs in turns "
            f"{''.join('ABC'[names.index(n)] for n in order)}, the first of each the "
            f"driven run)")


def phase_xla(torch, pkg, K, seq):
    cfg = pkg.reference_experiment_config(update_kernel="xla")
    run, stats, _, _, seconds = drive(torch, pkg, K, seq, cfg, "xla", max_ticks=400)
    sites = sync_check(torch, run, stats, "xla")
    log(f"xla: 400 ticks in {seconds:.3f} s; PyTorch sync-debug warnings over one run "
        f"{sum(sites.values())}, by site {sites} (the port's equal the loop's count)")


def _seq(out, b):
    """Sequence b of a batched TickOutput."""
    return type(out)(*(x[b] for x in out))


def phase_parity_batched(torch, pkg, K):
    """batched_run_sequence over two seeds, PARITY_TICKS in float64 at the
    parity capacities, on the card and on the CPU, default dispatch: the
    checks of phase_parity for each sequence."""
    from msckf_tpu_torch.data.stream import to_device

    cfg = pkg.reference_experiment_config(dtype="float64", f_max=512, u_max=64, k_max=512)
    T, seeds = PARITY_TICKS, (0, 1)
    st = pkg.circle_streams(cfg, seeds, max_ticks=T)
    res = {}
    for dev in (DEVICE, "cpu"):
        std = to_device(st, cfg, device=dev)
        states = pkg.batched_initial_state(cfg, len(seeds), std.R_init, device=dev)
        K.reset_launches()
        t0 = time.perf_counter()
        final, pre, fr = pkg.batched_run_sequence(cfg, states, std.prefix, std.frames,
                                                  assume_camera=True, device=dev)
        torch.cuda.synchronize()
        res[dev] = (final, pre, fr, time.perf_counter() - t0)
        if dev == DEVICE:
            card_launches = K.launch_counts()
    for k in path_kernels(pkg.batched_dispatch(cfg)):
        check(card_launches[k] > 0, f"batched parity: kernel {k} not launched on the card")
    (fg, pg, rg, tg), (fc, pc, rc, tc) = res[DEVICE], res["cpu"]
    worst = dict.fromkeys(("p_WI", "v_WI", "R_WI", "sigma"), 0.0)
    counters = []
    for b in range(len(seeds)):
        pgb, rgb, pcb, rcb = _seq(pg, b), _seq(rg, b), _seq(pc, b), _seq(rc, b)
        for name in ("n_cams", "n_tracks"):
            check(np.array_equal(_flat(pgb, rgb, name), _flat(pcb, rcb, name)),
                  f"batched parity: sequence {b}: {name} differ")
        cb = {}
        for k in ("n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
                  "n_track_overflow", "n_update_overflow"):
            a, c = int(getattr(fg.diag, k)[b]), int(getattr(fc.diag, k)[b])
            check(a == c, f"batched parity: sequence {b}: {k} differs ({a} vs {c})")
            cb[k] = a
        counters.append(cb)
        for name in ("p_WI", "v_WI", "R_WI"):
            d = float(np.abs(_flat(pgb, rgb, name) - _flat(pcb, rcb, name)).max())
            check(d <= 1e-7, f"batched parity: sequence {b}: {name} differs by {d}")
            worst[name] = max(worst[name], d)
        for name in ("sigma_pos", "sigma_rot"):
            a, c = _flat(pgb, rgb, name), _flat(pcb, rcb, name)
            check(np.allclose(a, c, rtol=1e-4, atol=1e-16),
                  f"batched parity: sequence {b}: {name} differs")
            worst["sigma"] = max(worst["sigma"],
                                 float((np.abs(a - c) / np.maximum(np.abs(c), 1e-300)).max()))
    log(f"parity batched: B={len(seeds)} seeds {seeds}, T={T} ticks, float64, default "
        f"dispatch, card {tg:.2f} s vs CPU {tc:.2f} s; counters equal per sequence "
        f"{counters}; max |dp| {worst['p_WI']:.2e}, |dv| {worst['v_WI']:.2e}, |dR| "
        f"{worst['R_WI']:.2e}, sigma rel {worst['sigma']:.2e}")


def predicted_batched_launches(K, cfg, C: int, B: int, Bp: int) -> dict:
    """Launches over one batched run: each call site of the single loop
    launches once per frame for the whole batch (never once per sequence).
    Under vmap both branches of every cond run, so the prune's triage and
    update run on every frame: the triage and the update kernels launch
    twice per frame."""
    pred = dict.fromkeys(K.LAUNCHES, 0)
    for kind in (_block_kind(Bp, cfg), *[_block_kind(1, cfg), _block_kind(B - 1, cfg)] * C):
        if kind != "scan":
            pred[kind] += 1
    if "verification_scores" in path_kernels(cfg):
        pred["verification_scores"] = C
    for name in ("triage_refresh_fused", "update_terms_fused", "batched_gating_gamma"):
        if name in path_kernels(cfg):
            pred[name] = 2 * C
    return pred


def phase_batched(torch, pkg, K, seq, single=None):
    """BATCH seeds of the circle through batched_run_sequence at the
    reference capacities in float32. ``single``: the main phase's driven
    run, its frame count and seconds, beside which the batched driven run's
    aggregate frames/s is given. Returns the launches and the default
    batched run's (frames, seconds)."""
    from msckf_tpu_torch.data.stream import to_device

    gt = seq.poses_t[len(seq.timestamps) - 1]  # the same trajectory for every seed
    base = pkg.reference_experiment_config()
    streams = {}

    def make_run(cfg, max_ticks=None, dispatch_auto=True, stats=None):
        if max_ticks not in streams:
            streams[max_ticks] = to_device(
                pkg.circle_streams(cfg, range(BATCH), max_ticks=max_ticks), cfg, DEVICE)
        std = streams[max_ticks]
        states = pkg.batched_initial_state(cfg, BATCH, std.R_init, device=DEVICE)
        return std, lambda: pkg.batched_run_sequence(
            cfg, states, std.prefix, std.frames, dispatch_auto=dispatch_auto,
            assume_camera=True, device=DEVICE, stats=stats)

    def drive_batched(label, cfg, max_ticks=None, dispatch_auto=True):
        stats = pkg.FrameStats()
        std, run = make_run(cfg, max_ticks, dispatch_auto, stats)
        C, Bt = std.frames["imu_ts"].shape[1:3]
        Bp = std.prefix["imu_ts"].shape[1]
        torch.cuda.synchronize()
        K.reset_launches()
        with warnings.catch_warnings():
            # functorch warns where an op has no batching rule and it loops
            # over the sequences instead
            warnings.filterwarnings("error", message=".*batching rule.*")
            t0 = time.perf_counter()
            final, _, _ = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = K.launch_counts()
        overflow = (final.diag.n_track_overflow + final.diag.n_update_overflow).cpu().numpy()
        check(not overflow.any(), f"{label}: capacity overflow {overflow.tolist()}")
        err_txt = ""
        if max_ticks is None:
            err = np.linalg.norm(final.imu.p_WI.double().cpu().numpy() - gt, axis=-1)
            check(np.isfinite(err).all() and (err < 0.2).all(),
                  f"{label}: final position errors {np.round(err, 4).tolist()} m, "
                  f"not all under 0.2 m")
            err_txt = (f"final errors {err.min():.4f} to {err.max():.4f} m (median "
                       f"{np.median(err):.4f}), ")
        dcfg = pkg.batched_dispatch(cfg) if dispatch_auto else cfg
        predicted = predicted_batched_launches(K, dcfg, C, Bt, Bp)
        for k in path_kernels(dcfg):
            check(launches[k] > 0, f"{label}: kernel {k} never launched")
        for k, v in launches.items():
            check(v == predicted[k], f"{label}: {k} launched {v} times, one per call site "
                                     f"and frame predicts {predicted[k]}")
        check(stats.host_syncs == 0, f"{label}: {stats.host_syncs} host syncs")
        log(f"{label}: B={BATCH} x {C} frames x {Bt} ticks (+{Bp}-tick prefix), "
            f"{dcfg.dtype} filter, gating_solver={dcfg.gating_solver!r}, "
            f"use_pallas_triage={dcfg.use_pallas_triage}, update_kernel={dcfg.update_kernel!r}; "
            f"{err_txt}overflow 0, {seconds:.3f} s, {BATCH * C / seconds:.1f} aggregate "
            f"frames/s; prunes per sequence {int(stats.prunes.min())} to "
            f"{int(stats.prunes.max())}; 0 host syncs; launches "
            f"{ {k: v for k, v in launches.items() if v} } (= one per call site and frame: "
            f"{ {k: round(v / C, 3) for k, v in launches.items() if v} } per frame)")
        return run, C, seconds, launches

    fused_cfg = pkg.reference_experiment_config(update_kernel="fused")
    run_b, C, first_s, launches = drive_batched("batched", base)
    fused = drive_batched("batched fused", fused_cfg)
    kernels = drive_batched("batched kernels", base, max_ticks=400, dispatch_auto=False)
    launches["update_terms_fused"] = fused[3]["update_terms_fused"]
    for name in ("triage_refresh_fused", "batched_gating_gamma"):
        launches[name] = kernels[3][name]

    stats = pkg.FrameStats()
    _, sync_run = make_run(base, 400, stats=stats)
    sites = sync_check(torch, sync_run, stats, "batched")
    log(f"batched: sync check over 400 ticks: {stats.host_syncs} host syncs counted, "
        f"PyTorch sync-debug warnings {sum(sites.values())}, by site {sites}")

    if single is not None:
        _, C_s, ts = single
        check(C_s == C, "batched: the single and batched circles differ in frames")
        tb = first_s
        log(f"rates: batched B={BATCH}: {BATCH * C / tb:.1f} aggregate frames/s, "
            f"{tb / C * 1e3:.3f} ms per frame of the batch; single default loop: "
            f"{C / ts:.2f} frames/s, {ts / C * 1e3:.3f} ms/frame; batched frame / single frame "
            f"{tb / ts:.3f}, aggregate / single frames/s {BATCH * ts / tb:.3f} (the driven "
            f"runs of both)")
    for label, cfg in (("batched", base), ("batched fused", fused_cfg)):
        _, prof_run = make_run(cfg, 20 + 10 * PROFILE_FRAMES)
        profile_window(torch, prof_run, PROFILE_FRAMES, label)
    return launches, (C, first_s)


# ---------------------------------------------------------------------------
# phase 9: the gain solvers, the Gauss-Newton triangulation, the XLA-only forms
# ---------------------------------------------------------------------------

# the use_pallas=False run, the sync checks and the batched chain (400
# until the island phase joined the script)
SOLVER_TICKS = 200


def _filter_system(rng, D, gain_scale):
    """tests/test_torch_solve.py's realistic system: Bt = sigma^2 I + s P A,
    float64 numpy."""
    H = rng.standard_normal((40, D))
    A = H.T @ H
    P = rng.standard_normal((D, D))
    P = P @ P.T + np.eye(D)
    s = gain_scale * 0.01 / np.abs(P @ A).max()
    return 0.01 * np.eye(D) + s * (P @ A), P


def _spd_system(rng, D, cond, rank=40):
    """tests/test_torch_solve.py's P of the given condition and A = H^T H."""
    Q, _ = np.linalg.qr(rng.standard_normal((D, D)))
    P = (Q * np.logspace(0, -np.log10(cond), D)) @ Q.T
    H = rng.standard_normal((rank, D)) / np.sqrt(rank)
    return P, H.T @ H


def _hard_system(rng, D):
    """tests/test_torch_solve.py's hopeless system, cond(Bt) > 1e5."""
    A = rng.standard_normal((D, D))
    P = rng.standard_normal((D, D))
    Bt = 1e-4 * np.eye(D) + (P @ P.T) @ (A @ A.T)
    check(np.linalg.cond(Bt) > 1e5, "solvers: the hard system is not hard")
    return Bt, P @ P.T


def check_solves(torch, dtype_name, rng, D):
    """The gain solves on the card at D on the CPU tests' systems: the
    unbatched gain_solve is the LU's bits; the rule's batch of BATCH
    realistic systems is within 1e-5 of a float64 solve; one hard system
    sends the whole batch to the batched LU's bits; one Newton-Schulz step
    falls back to the LU's bits; the Cholesky solve at cond(P) = 1e8 is
    finite."""
    from msckf_tpu_torch.ops import solve as S

    dt = getattr(torch, dtype_name)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=DEVICE, dtype=dt)

    def lu(Bt, P):
        return torch.linalg.solve_ex(Bt, P, check_errors=False).result

    Bt, P = (t(x) for x in _filter_system(rng, D, 0.3))
    check(same_bits(torch, S.gain_solve(Bt, P), lu(Bt, P)),
          f"solvers {dtype_name}: unbatched gain_solve is not the LU's bits")
    systems = [_filter_system(rng, D, g) for g in np.linspace(0.1, 2.0, BATCH)]
    Btb, Pb = t(np.stack([b for b, _ in systems])), t(np.stack([p for _, p in systems]))
    Y = torch.func.vmap(S.gain_solve)(Btb, Pb)
    Yr = torch.linalg.solve(Btb.double(), Pb.double())
    rel = float((Y.double() - Yr).abs().max() / Yr.abs().max())
    check(rel < 1e-5, f"solvers {dtype_name}: batched gain_solve rel error {rel:.2e} >= 1e-5")
    kept = not same_bits(torch, Y, lu(Btb, Pb))
    hBt, hP = _hard_system(rng, D)
    Btb[-1], Pb[-1] = t(hBt), t(hP)
    check(same_bits(torch, torch.func.vmap(S.gain_solve)(Btb, Pb), lu(Btb, Pb)),
          f"solvers {dtype_name}: a batch with a hard system is not the batched LU's bits")
    P1, A1 = (t(x) for x in _spd_system(rng, D, 1e3))
    Bt1 = 1e-3 * torch.eye(D, dtype=dt, device=DEVICE) + P1 @ A1
    check(same_bits(torch, S.ns_solve_direct(Bt1, P1, iters=1), lu(Bt1, P1)),
          f"solvers {dtype_name}: ns_solve_direct(iters=1) is not the LU's bits")
    P8, A8 = (t(x) for x in _spd_system(rng, D, 1e8))
    L8 = S.chol_gain_solve(P8, A8, 1.5)
    check(bool(torch.isfinite(L8).all()), f"solvers {dtype_name}: chol at cond 1e8 not finite")
    lu8 = lu(1.5 * torch.eye(D, dtype=dt, device=DEVICE) + P8 @ A8, P8).T
    rel8 = float((L8 - lu8).abs().max() / lu8.abs().max())
    check(rel8 < 1e-2, f"solvers {dtype_name}: chol at cond 1e8 differs from the LU by {rel8:.2e}")
    log(f"solvers {dtype_name}: D={D}: unbatched gain_solve = the LU's bits; B={BATCH} "
        f"realistic systems rel error {rel:.2e} vs float64 (Newton-Schulz kept: {kept}); "
        f"one hard system -> the batched LU's bits; ns_solve_direct(iters=1) = the LU's bits; "
        f"chol at cond(P) 1e8 finite, {rel8:.2e} from the LU")


def time_solvers(torch, pkg, rng) -> dict:
    """CUDA-event times (median of 25) of the correction chain
    (``_correction_terms``: the solve, delta and the Joseph update) at the
    reference capacities (D = 207) for each gain solver, single and under
    vmap at B = BATCH, with a float32 filter and a float32 or a float64
    chain; and of the solves alone: the LU, the Newton-Schulz solve without
    its gate, ns_solve_direct (the same with the gate's residual and its
    always-computed LU) and gain_solve's rule. Well-conditioned systems,
    so every gate keeps its Newton-Schulz answer."""
    import dataclasses

    from msckf_tpu_torch.filter.update import _correction_terms
    from msckf_tpu_torch.ops import solve as S

    base = pkg.reference_experiment_config()
    D, B = base.err_dim, BATCH
    H = rng.standard_normal((B, 30, D)) * 1e-3
    A = np.einsum("bri,brj->bij", H, H)
    P = rng.standard_normal((B, D, D)) * 0.05
    P = P @ np.swapaxes(P, 1, 2) + 0.01 * np.eye(D)
    c = rng.standard_normal((B, D))
    rows = {}
    for ct in ("float32", "float64"):
        args = [torch.as_tensor(x, dtype=torch.float32, device=DEVICE) for x in (P, A, c)]
        variants = [("lu", "lu"), ("ns", "lu"), ("chol", "lu")]
        if ct == "float32":
            variants.append(("lu", "ns"))  # the batched float32 chain's rule
        for gain, batched in variants:
            cfg = dataclasses.replace(base, correction_dtype=ct, gain_solver=gain,
                                      batched_solver=batched)
            name = f"chain {ct} " + (gain if batched == "lu" else "gain_solve rule")
            one = time_ms(torch, lambda: _correction_terms(cfg, args[0][0], args[1][0],
                                                           args[2][0]))
            vm = torch.func.vmap(lambda p, a, cc: _correction_terms(cfg, p, a, cc))
            many = time_ms(torch, lambda: vm(*args))
            rows[name] = (one, many)
        dt = getattr(torch, ct)
        Pd, Ad = args[0].to(dt), args[1].to(dt)
        Bt = base.sigma_image**2 * torch.eye(D, dtype=dt, device=DEVICE) + Pd @ Ad
        solves = {
            "lu": lambda b, p: torch.linalg.solve_ex(b, p, check_errors=False).result,
            "ns (no gate)": lambda b, p: S._ns_solve(b, p, base.solver_ns_iters),
            "ns_solve_direct": lambda b, p: S.ns_solve_direct(b, p, base.solver_ns_iters),
        }
        for sname, f in solves.items():
            rows[f"solve {ct} {sname}"] = (time_ms(torch, lambda: f(Bt[0], Pd[0])),
                                           time_ms(torch, lambda: torch.func.vmap(f)(Bt, Pd)))
        rule = torch.func.vmap(lambda b, p: S.gain_solve(b, p, base.solver_ns_iters))
        rows[f"solve {ct} gain_solve rule"] = (None, time_ms(torch, lambda: rule(Bt, Pd)))
    for name, (one, many) in rows.items():
        log(f"solvers time: {name:32s} single {_fmt_ms(one):>14s}, B={B} {_fmt_ms(many):>14s}")
    return rows


def batched_float32_chain(torch, pkg, K):
    """BATCH seeds of the circle, SOLVER_TICKS ticks, float32 filter with a
    float32 correction chain through the batched loop (default dispatch),
    with batched_solver "ns" (gain_solve's rule: one Newton-Schulz solve of
    the batch, one residual, the batched LU selected where it fails) and
    "lu": overflow 0, launches one per call site and frame, no functorch
    fallback, 0 host syncs; the position gap between the two runs per
    sequence, and how often the rule kept its Newton-Schulz answer."""
    from msckf_tpu_torch.data.stream import to_device
    from msckf_tpu_torch.ops import solve as S

    outs = {}
    std = None
    for solver in ("ns", "lu"):
        cfg = pkg.reference_experiment_config(correction_dtype="float32", batched_solver=solver)
        if std is None:
            std = to_device(pkg.circle_streams(cfg, range(BATCH), max_ticks=SOLVER_TICKS), cfg,
                            DEVICE)
        states = pkg.batched_initial_state(cfg, BATCH, std.R_init, device=DEVICE)
        stats = pkg.FrameStats()
        residuals = []
        original = S._relative_residual

        def recording(Bt, P, Y, dims=(-2, -1)):
            res = original(Bt, P, Y, dims)
            if dims == (0, 1, 2):
                residuals.append(res)  # read after the run: no sync inside it
            return res

        C, Bt_, Bp = (std.frames["imu_ts"].shape[1], std.frames["imu_ts"].shape[2],
                      std.prefix["imu_ts"].shape[1])
        torch.cuda.synchronize()
        K.reset_launches()
        S._relative_residual = recording
        try:
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message=".*batching rule.*")
                t0 = time.perf_counter()
                final, _, fr = pkg.batched_run_sequence(cfg, states, std.prefix, std.frames,
                                                        assume_camera=True, device=DEVICE,
                                                        stats=stats)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            S._relative_residual = original
        launches = K.launch_counts()
        dcfg = pkg.batched_dispatch(cfg)
        predicted = predicted_batched_launches(K, dcfg, C, Bt_, Bp)
        for k, v in launches.items():
            check(v == predicted[k], f"batched chain {solver}: {k} launched {v} times, "
                                     f"predicted {predicted[k]}")
        overflow = (final.diag.n_track_overflow + final.diag.n_update_overflow).cpu().numpy()
        check(not overflow.any(), f"batched chain {solver}: overflow {overflow.tolist()}")
        check(stats.host_syncs == 0, f"batched chain {solver}: {stats.host_syncs} host syncs")
        check(bool(torch.isfinite(final.imu.p_WI).all()), f"batched chain {solver}: non-finite")
        kept = ""
        if solver == "ns":
            check(len(residuals) > 0, "batched chain ns: gain_solve's rule never ran")
            res = torch.stack(residuals).double().cpu().numpy()
            kept = (f"; the rule ran {len(res)} times and kept its Newton-Schulz answer "
                    f"{int((res < 1e-4).sum())} times (worst batch residual {res.max():.2e})")
        log(f"batched chain {solver}: B={BATCH} x {C} frames x {Bt_} ticks, float32 filter and "
            f"chain, batched_solver={solver!r}: overflow 0, 0 host syncs, {seconds:.3f} s, "
            f"{BATCH * C / seconds:.1f} aggregate frames/s; launches "
            f"{ {k: v for k, v in launches.items() if v} } (= predicted){kept}")
        outs[solver] = (fr.p_WI.double(), fr.valid)
    (pn, vn), (pl, vl) = outs["ns"], outs["lu"]
    check(torch.equal(vn, vl), "batched chain: the two runs' valid ticks differ")
    gap = torch.where(vn[..., None], (pn - pl).abs(), 0.0).amax(dim=(1, 2, 3)).cpu().numpy()
    log(f"batched chain: position gap ns vs lu per sequence (max over ticks), m: "
        f"{np.array2string(gap, precision=2, max_line_width=400)}; max {gap.max():.3e}")


def phase_solvers(torch, pkg, K, seq):
    """The settings of the gain-solver slice on the card: the solves checked
    and timed at D = 207; the whole circle with gain_solver "ns", "chol" and
    triangulation "gn", and SOLVER_TICKS ticks with use_pallas=False, each
    with its error, overflow, launch and sync checks (no triage kernel under
    gn, no kernel at all with use_pallas=False); frames/s of the three
    whole-circle configurations from their driven runs; the batched float32
    chain with batched_solver "ns" and "lu"; float64 card-vs-CPU parity of
    the four."""
    rng = np.random.default_rng(9)
    D = pkg.reference_experiment_config().err_dim
    for dtype_name in ("float32", "float64"):
        check_solves(torch, dtype_name, rng, D)
    time_solvers(torch, pkg, rng)

    for label, overrides in (("ns", dict(gain_solver="ns")), ("chol", dict(gain_solver="chol")),
                             ("gn", dict(triangulation="gn"))):
        cfg = pkg.reference_experiment_config(**overrides)
        _, stats, launches, C, first_s = drive(torch, pkg, K, seq, cfg, f"solvers {label}")
        if label == "gn":
            check(launches["triage_refresh_fused"] == 0, "solvers gn: the triage kernel ran")
        sstats = pkg.FrameStats()
        _, srun = _run(torch, pkg, cfg, seq, DEVICE, SOLVER_TICKS, sstats)
        sites = sync_check(torch, srun, sstats, f"solvers {label}")
        log(f"rates: solvers {label} driven run {_rate(C, [first_s])}")
        log(f"solvers {label}: first run {first_s:.3f} s; host syncs per frame "
            f"{stats.host_syncs / stats.frames:.3f} ({stats.host_syncs} over {stats.frames} "
            f"frames); sync check over {SOLVER_TICKS} ticks: PyTorch sync-debug warnings "
            f"{sum(sites.values())}, by site {sites} (the port's equal the loop's count)")

    cfg = pkg.reference_experiment_config(use_pallas=False)
    run, stats, launches, _, seconds = drive(torch, pkg, K, seq, cfg, "solvers xla-only",
                                             max_ticks=SOLVER_TICKS)
    check(sum(launches.values()) == 0, f"solvers xla-only: kernels launched {launches}")
    sites = sync_check(torch, run, stats, "solvers xla-only")
    log(f"solvers xla-only: {SOLVER_TICKS} ticks in {seconds:.3f} s "
        f"({stats.frames / seconds:.2f} frames/s), no kernel launched; PyTorch sync-debug "
        f"warnings {sum(sites.values())}, by site {sites}")

    batched_float32_chain(torch, pkg, K)

    for label, overrides in (("ns", dict(gain_solver="ns")), ("chol", dict(gain_solver="chol")),
                             ("gn", dict(triangulation="gn")),
                             ("xla-only", dict(use_pallas=False))):
        phase_parity(torch, pkg, K, seq, f"solvers {label}", **overrides)


# ---------------------------------------------------------------------------
# phase 10: the image front-end and the image-in pipeline
# ---------------------------------------------------------------------------

# bench.py's headline sequence (bench.py:228-231): 104 frames of a 640 x 480
# ray-traced circle, rendered by the port's numpy copy of the renderer
IMAGE_RENDER = dict(n_ticks=1040, width=640, height=480, fxy=320.0, camera_height=4.0)
IMAGE_TOP_K = 300
IMAGE_CNN_FRAMES = (0, 34, 68, 101)  # the CNN's card-vs-CPU frames
WEIGHTS = REPO / "weights" / "xfeat_selfsup.npz"


def image_cfgs(pkg, seq) -> dict:
    """(a) the runner's --source rendered configuration: the default
    configuration with the sequence's camera; (b) bench.py's headline
    settings (bench.py:257-263)."""
    H, W = seq.images.shape[1:]
    f = IMAGE_RENDER["fxy"]
    cam = dict(R_WC=tuple(map(tuple, seq.R_WC_extrinsic.tolist())),
               K=((f, 0.0, W / 2.0), (0.0, f, H / 2.0), (0.0, 0.0, 1.0)), width=W, height=H)
    return {
        "images": pkg.reference_experiment_config(dtype="float32", **cam),
        "images bench": pkg.reference_experiment_config(
            dtype="float32", gain_solver="ns", correction_dtype="float32",
            gating_solver="ns", gating_ns_iters=12, **cam),
    }


def conv_flops(torch, model, x):
    """(operations of the model's convolutions on x, the model's outputs):
    2 x multiply-adds, counted from each convolution's output shape by
    forward hooks."""
    total = [0.0]

    def hook(mod, _, out):
        k = mod.kernel_size[0] * mod.kernel_size[1] * mod.in_channels // mod.groups
        total[0] += 2.0 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0], out


def check_cnn(torch, model, cpu_model, images) -> float:
    """The same weights on the card and on the CPU over IMAGE_CNN_FRAMES:
    the backbone's largest errors, the valid keypoint sets (at least 99 %
    of the slots agree, each mismatch logged with its score gap), scores
    within 1e-5 and descriptors within 1e-4 on the matched keypoints; the
    batched call against single calls on the card (the same keypoints).
    Returns the CNN's operations per frame."""
    from msckf_tpu_torch.models.xfeat import detect_and_compute

    x = torch.as_tensor(images[list(IMAGE_CNN_FRAMES)])
    xg = x.to(DEVICE)
    n = len(IMAGE_CNN_FRAMES)
    with torch.no_grad():
        out_g = model(xg[:, None])
    flops, out_c = conv_flops(torch, cpu_model, x[:, None])
    flops /= n
    errs = ", ".join(
        f"{name} {(g.cpu() - c).abs().max().item():.3e} (of {c.abs().max().item():.3g})"
        for name, g, c in zip(("feats", "kp_logits", "heatmap"), out_g, out_c))
    log(f"images cnn: card against CPU, frames {list(IMAGE_CNN_FRAMES)}, float32: largest "
        f"error {errs}")
    det_g = [t.cpu() for t in detect_and_compute(model, xg, top_k=IMAGE_TOP_K)]
    det_c = detect_and_compute(cpu_model, x, top_k=IMAGE_TOP_K)
    worst_s = worst_d = 0.0
    for i, f in enumerate(IMAGE_CNN_FRAMES):
        (kg, dg, sg, vg), (kc, dc, sc, vc) = ([t[i] for t in det_g], [t[i] for t in det_c])
        slot_g = {tuple(kg[j].tolist()): j for j in range(len(kg)) if vg[j]}
        slot_c = {tuple(kc[j].tolist()): j for j in range(len(kc)) if vc[j]}
        both = slot_g.keys() & slot_c.keys()
        agree = len(both) / max(len(slot_g), len(slot_c), 1)
        low_g, low_c = float(sg[vg].min()), float(sc[vc].min())
        for side, mine, other, scores, low in (("card", slot_g, slot_c, sg, low_c),
                                               ("CPU", slot_c, slot_g, sc, low_g)):
            for k in sorted(mine.keys() - other.keys()):
                s = float(scores[mine[k]])
                log(f"images cnn: frame {f}: only the {side} keeps {k}, score {s:.6g}; the "
                    f"other side's lowest kept score {low:.6g} (gap {s - low:.3e})")
        check(agree >= 0.99, f"images cnn: frame {f}: keypoint sets agree in {agree:.4f} of "
                             f"the slots, under 0.99")
        if both:
            jg = torch.tensor([slot_g[k] for k in both])
            jc = torch.tensor([slot_c[k] for k in both])
            ds = float((sg[jg] - sc[jc]).abs().max())
            dd = float((dg[jg] - dc[jc]).abs().max())
            check(ds <= 1e-5 and dd <= 1e-4,
                  f"images cnn: frame {f}: matched keypoints' scores differ by {ds:.3e} "
                  f"(limit 1e-5), descriptors by {dd:.3e} (limit 1e-4)")
            worst_s, worst_d = max(worst_s, ds), max(worst_d, dd)
        log(f"images cnn: frame {f}: {len(slot_g)} valid on the card, {len(slot_c)} on the "
            f"CPU, {len(both)} in both ({agree:.4f})")
    log(f"images cnn: matched keypoints: scores within {worst_s:.3e}, descriptors within "
        f"{worst_d:.3e}")
    diff_s = diff_d = 0.0
    for i in range(n):
        single = [t.cpu() for t in detect_and_compute(model, xg[i], top_k=IMAGE_TOP_K)]
        check(torch.equal(single[0], det_g[0][i]) and torch.equal(single[3], det_g[3][i]),
              f"images cnn: frame {IMAGE_CNN_FRAMES[i]}: the batched call's keypoints differ "
              f"from a single call's")
        diff_s = max(diff_s, float((single[2] - det_g[2][i]).abs().max()))
        diff_d = max(diff_d, float((single[1] - det_g[1][i]).abs().max()))
    log(f"images cnn: batched call over {n} frames against {n} single calls on the card: "
        f"keypoints and valid equal, scores within {diff_s:.3e}, descriptors within "
        f"{diff_d:.3e}")
    return flops


def image_run(torch, pkg, cfg, model, seq, max_ticks=None, stats=None):
    """(stream on the card, its images, the initial state, a run of
    run_sequence_images over them with the whole-stack CNN)."""
    from msckf_tpu_torch.data.stream import build_image_stream, to_device

    st = build_image_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc,
                            seq.cam_frame_ticks, max_ticks=max_ticks)
    std = to_device(st, cfg, device=DEVICE)
    images = torch.as_tensor(seq.images[st.proc_cam_idx], device=DEVICE)
    state = pkg.make_initial_state(cfg, std.R_init, device=DEVICE)
    return std, images, state, lambda: pkg.run_sequence_images(
        cfg, model, state, std.prefix, std.frames, images, top_k=IMAGE_TOP_K,
        device=DEVICE, stats=stats)


def drive_images(torch, pkg, K, seq, model, cfg, label):
    """A configuration's driven image-in run over the whole sequence: launch
    counts set to 0 just before it and read just after; final position error
    under 0.5 m (bench.py:287), no overflow, launches equal to the loop's
    prediction. Returns (run, stream, images, state, seconds)."""
    stats = pkg.FrameStats()
    std, images, state, run = image_run(torch, pkg, cfg, model, seq, stats=stats)
    C, B = std.frames["imu_ts"].shape
    Bp = std.prefix["imu_ts"].shape[0]
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    final, _, _ = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = K.launch_counts()
    overflow = int(final.diag.n_track_overflow) + int(final.diag.n_update_overflow)
    check(overflow == 0, f"{label}: capacity overflow {overflow}")
    gt = seq.poses_t[len(seq.timestamps) - 1]
    err = float(np.linalg.norm(final.imu.p_WI.double().cpu().numpy() - gt))
    check(np.isfinite(err) and err < 0.5, f"{label}: final position error {err:.4f} m, "
                                         f"not under 0.5 m")
    predicted = predicted_launches(K, cfg, stats, C, B, Bp)
    for k in path_kernels(cfg):
        check(launches[k] > 0, f"{label}: kernel {k} never launched")
    for k, v in launches.items():
        check(v == predicted[k], f"{label}: {k} launched {v} times, loop predicts {predicted[k]}")
    log(f"{label}: {C} frames x {B} ticks (+{Bp}-tick prefix), {images.shape[1]}x"
        f"{images.shape[2]} images, top_k={IMAGE_TOP_K}, whole-stack CNN; {cfg.dtype} filter, "
        f"{cfg.correction_dtype} island, gain_solver={cfg.gain_solver!r}, "
        f"gating_solver={cfg.gating_solver!r} (ns iters {cfg.gating_ns_iters}), "
        f"f_max={cfg.f_max} u_max={cfg.u_max}")
    log(f"{label}: final error {err:.4f} m, overflow 0, {stats.camera_steps} camera steps, "
        f"{stats.prunes} prunes ({stats.prune_updates} with an update), host syncs per frame "
        f"{stats.host_syncs / stats.frames:.3f} ({stats.host_syncs} over {stats.frames} "
        f"frames), first run {seconds:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} } (= predicted; the others 0)")
    return run, std, images, state, seconds


def phase_images(torch, pkg, K, default=None):
    """The image-in pipeline on the card over bench.py's rendered sequence
    with the committed weights. ``default``: the main phase's driven run and
    its frame count, timed in turns with the image loop."""
    from msckf_tpu_torch.data.rendered import generate_rendered_circle
    from msckf_tpu_torch.models.xfeat import detect_and_compute, load_xfeat_npz

    t0 = time.perf_counter()
    seq = generate_rendered_circle(rng=np.random.default_rng(0), **IMAGE_RENDER)
    log(f"images: rendered {seq.images.shape[0]} frames of {seq.images.shape[2]}x"
        f"{seq.images.shape[1]} on the host in {time.perf_counter() - t0:.1f} s")
    model = load_xfeat_npz(str(WEIGHTS), device=DEVICE)
    cpu_model = load_xfeat_npz(str(WEIGHTS), device="cpu")
    flops = check_cnn(torch, model, cpu_model, seq.images)

    cfgs = image_cfgs(pkg, seq)
    driven = {label: drive_images(torch, pkg, K, seq, model, cfg, label)
              for label, cfg in cfgs.items()}
    cfg = cfgs["images"]
    run, std, images, state, first_s = driven["images"]
    C = images.shape[0]

    one = images[0]
    dc_ms = time_ms(torch, lambda: detect_and_compute(model, one, top_k=IMAGE_TOP_K))
    stack_ms = time_ms(torch, lambda: detect_and_compute(model, images, top_k=IMAGE_TOP_K),
                       reps=5, warmup=1)
    bound, _ = bound_ms(0.0, flops, "float32")
    log(f"images times: detect_and_compute on one {one.shape[1]}x{one.shape[0]} frame at "
        f"top-{IMAGE_TOP_K}: {dc_ms:.4f} ms (CUDA events, median of 25); the CNN stage over "
        f"the stack of {C}: {stack_ms:.3f} ms, {stack_ms / C:.4f} ms/frame (median of 5); "
        f"the convolutions' {flops / 1e9:.3f} GFLOP/frame bound it at {bound:.4f} ms/frame "
        f"(float32, 67 TFLOP/s)")
    kp, desc, score, valid = detect_and_compute(model, images, top_k=IMAGE_TOP_K)
    frames = dict(std.frames, kp=kp.to(cfg.jdtype), desc=desc.to(cfg.jdtype),
                  score=score.to(cfg.jdtype), kp_valid=valid)
    runs = {"images": run, "filter": lambda: pkg.run_sequence(
        cfg, state, std.prefix, frames, assume_camera=True, device=DEVICE)}
    order = ["images", "filter", "filter", "images"]
    if default is not None:
        runs["default"] = default[0]
        order = ["default", "images", "filter", "filter", "images", "default"]
    times = timed_runs(torch, runs, order)
    t_img, t_fil = float(np.median(times["images"])), float(np.median(times["filter"]))
    log(f"rates: image loop {_rate(C, times['images'])}; the filter alone over the CNN "
        f"stage's outputs {_rate(C, times['filter'])}; the CNN stage's share of the image "
        f"loop {stack_ms / (t_img * 1e3) * 100:.2f}%")
    if default is not None:
        C_d = default[1]
        t_def = float(np.median(times["default"]))
        log(f"rates: synthetic default loop in the same turns {_rate(C_d, times['default'])}; "
            f"image loop / default frames/s {(C / t_img) / (C_d / t_def):.3f} (turns "
            f"{''.join({'default': 'A', 'images': 'B', 'filter': 'C'}[n] for n in order)})")
    _, _, _, prof_run = image_run(torch, pkg, cfg, model, seq, max_ticks=20 + 10 * PROFILE_FRAMES)
    profile_window(torch, prof_run, PROFILE_FRAMES, "images")
    log(f"images: the filter per frame {t_fil / C * 1e3:.3f} ms, the CNN per frame "
        f"{stack_ms / C:.4f} ms, the image loop per frame {t_img / C * 1e3:.3f} ms "
        f"(first run {first_s:.3f} s)")


# ---------------------------------------------------------------------------
# phase 11: the runner, chunked streaming and checkpoint/resume
# ---------------------------------------------------------------------------

# a quarter of the synthetic circle (the runner's default is the whole 2,400
# ticks): the whole script with 2,400 took 1,248.3 s, over its 1,200 s, on a
# host whose default loop ran at 17.2 frames/s; with 1,200 it took 1,028.8 s
# on one at 17.0 frames/s, before phase train joined it; 800 until phase
# scaleout joined it
RUNNER_TICKS = 600
RUNNER_CHUNKS = (16, 64)
# the batch and the rendered runs were cut from 600 and 800 ticks when the
# island phase joined the script, to keep it in its time
RUNNER_BATCH_TICKS = 300
RENDERED_TICKS = 400  # 38 frames of the runner's 320 x 240 rendered circle


def runner_call(torch, K, argv):
    """runner.main in-process, with the launch counts set to 0 just before
    and read just after. Returns (result, launches)."""
    from msckf_tpu_torch import runner

    torch.cuda.synchronize()
    K.reset_launches()
    res = runner.main(argv)
    torch.cuda.synchronize()
    return res, K.launch_counts()


def check_runner_run(K, label, m, launches, limit):
    """A runner run's checks: final position error (the norm of the last
    tick's ATE) under ``limit``, no overflow, every kernel of the path
    launched, and launches equal to twice the loop's prediction (the
    warm-up and the timed run are the same run)."""
    err = float(np.linalg.norm(m.ate[-1]))
    check(np.isfinite(err) and err < limit, f"{label}: final position error {err:.4f} m, "
                                            f"not under {limit} m")
    overflow = m.diag["n_track_overflow"] + m.diag["n_update_overflow"]
    check(overflow == 0, f"{label}: capacity overflow {overflow}")
    C, B, Bp = m.blocks
    predicted = predicted_launches(K, m.cfg, m.stats, C, B, Bp)
    for k in path_kernels(m.cfg):
        check(launches[k] > 0, f"{label}: kernel {k} never launched")
    for k, v in launches.items():
        check(v == 2 * predicted[k], f"{label}: {k} launched {v} times, the loop predicts "
                                     f"2 x {predicted[k]} (warm-up and timed run)")
    c, p = m.consistency, m.profiling
    log(f"{label}: {C} frames x {B} ticks (+{Bp}-tick prefix), f_max={m.cfg.f_max} "
        f"k_max={m.cfg.k_max} u_max={m.cfg.u_max} desc_dim={m.cfg.desc_dim}; final error "
        f"{err:.4f} m, overflow 0, {m.stats.camera_steps} camera steps, {m.stats.prunes} prunes, "
        f"host syncs per frame {m.stats.host_syncs / m.stats.frames:.3f}; ATE within 3-sigma "
        f"{c['ate_within_3sigma']:.3f}, AOE {c['aoe_within_3sigma']:.3f}, NEES median "
        f"{c['nees_median']:.2f} (in bounds {c['nees_within_bounds']:.3f}); warm-up "
        f"{p['warmup_s']} s, timed run {p['sequence_s']:.3f} s "
        f"({p['camera_updates_per_s']} camera updates/s); launches "
        f"{ {k: v for k, v in launches.items() if v} } (= 2 x predicted; the others 0)")


def same_state(label, a, b):
    from msckf_tpu_torch.filter.state import state_to_numpy

    sa, sb = state_to_numpy(a), state_to_numpy(b)
    for k in sb:
        check(np.array_equal(sa[k], sb[k]), f"{label}: final state {k} differs")


def same_run(label, a, b):
    """Two runner results bitwise equal: the diagnostics, every metric array
    (each a function of the estimated trajectory and its variances) and
    every leaf of the final state."""
    import dataclasses

    check(a.diag == b.diag, f"{label}: diagnostics differ {a.diag} vs {b.diag}")
    for f in dataclasses.fields(b):
        check(np.array_equal(np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name))),
              f"{label}: metric {f.name} differs")
    same_state(label, a.final, b.final)


def frame_bytes(stream, cfg) -> int:
    """Device bytes of one frame of a host stream in the filter's dtype."""
    item = np.dtype(cfg.dtype).itemsize
    return sum((item if v.dtype == np.float64 else v.itemsize) * v[0].size
               for v in stream.frames.values())


def tick_output_bytes(cfg, ticks: int) -> int:
    """Device bytes of a TickOutput over ``ticks`` ticks: R (9), p, v,
    sigma_rot and sigma_pos (3 each) in the filter's dtype, n_cams and
    n_tracks (int64) and valid (bool)."""
    return ticks * (21 * np.dtype(cfg.dtype).itemsize + 2 * 8 + 1)


def phase_runner(torch, pkg, K):
    """The port's CLI on the card: RUNNER_TICKS of the synthetic circle
    monolithic and streamed, a checkpoint mid-sequence, a batch of BATCH sequences
    unstreamed and streamed, and the rendered source through both
    front-ends."""
    import tempfile

    from msckf_tpu_torch.data.stream import build_stream, to_device
    from msckf_tpu_torch.data.synthetic import generate_circle_sequence
    from msckf_tpu_torch.filter.streamed import run_sequence_streamed
    from msckf_tpu_torch.utils.checkpoint import load_state, save_state

    with tempfile.TemporaryDirectory() as tmp:
        base = ["--source", "synthetic", "--max_frames", str(RUNNER_TICKS), "--device", DEVICE,
                "--data_root", tmp]
        mono, launches = runner_call(torch, K, base)
        check_runner_run(K, "runner", mono, launches, 0.2)
        cfg = mono.cfg
        C, B = mono.blocks[:2]

        # the runner's stream, for the memory bound, the timed runs and the
        # checkpoint
        seq = generate_circle_sequence(rng=np.random.default_rng(42))
        st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                          seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores,
                          max_ticks=RUNNER_TICKS)
        check(st.frames["imu_ts"].shape == (C, B), "runner: the rebuilt stream differs")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        std = to_device(st, cfg, DEVICE)
        whole = torch.cuda.memory_allocated() - before
        first = {"monolithic": mono.profiling["sequence_s"]}
        runs = {"monolithic": lambda: pkg.run_sequence(
            cfg, pkg.make_initial_state(cfg, std.R_init, device=DEVICE), std.prefix,
            std.frames, assume_camera=True, device=DEVICE)}
        for n in RUNNER_CHUNKS:
            label = f"runner --stream_chunk {n}"
            ms, launches = runner_call(torch, K, base + ["--stream_chunk", str(n)])
            check_runner_run(K, label, ms, launches, 0.2)
            same_run(label, ms, mono)
            n_chunks = -(-C // n)
            check(ms.stats.host_syncs == mono.stats.host_syncs + n_chunks,
                  f"{label}: {ms.stats.host_syncs} host syncs, expected the monolithic run's "
                  f"{mono.stats.host_syncs} + {n_chunks} chunks")
            log(f"{label}: bitwise equal to the monolithic run (metrics, diagnostics, every "
                f"leaf of the final state); host syncs per frame {ms.stats.host_syncs / C:.3f} "
                f"against {mono.stats.host_syncs / C:.3f} ({n_chunks} chunks)")
            first[label] = ms.profiling["sequence_s"]
            runs[label] = (lambda n=n: run_sequence_streamed(
                cfg, pkg.make_initial_state(cfg, st.R_init, device=DEVICE), st.prefix,
                st.frames, chunk_frames=n, device=DEVICE, assume_camera=True))
        # the second run of each, in reverse order (turns ABCCBA), with its
        # peak device allocation above the start: the runner calls above
        # paid the one-time allocations (cuBLAS workspaces and the like)
        names = list(runs)
        times, peaks = {}, {}
        for name in names[::-1]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start_bytes = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            peaks[name] = torch.cuda.max_memory_allocated() - start_bytes
        med = {}
        for name in names:
            t = [first[name], times[name]]
            med[name] = float(np.median(t))
            log(f"rates: {name} {_rate(C, t)} (the runner's timed run, then one in reverse "
                f"order)")
        log("rates: runner frames/s ratios " + ", ".join(
            f"{name} / monolithic {med['monolithic'] / med[name]:.3f}" for name in names[1:]))
        # the monolithic run holds the whole stream before it starts; the
        # filter's working set and outputs are in both peaks, so a streamed
        # peak above the monolithic one is what its stream holds: at most
        # two chunks and a chunk's outputs in flight (and the prefix while it
        # runs; 512 bytes of rounding a tensor)
        log(f"runner memory: the whole stream {whole / 2**20:.3f} MiB on the card "
            f"({frame_bytes(st, cfg) / 1024:.2f} KiB a frame); the monolithic run's peak above "
            f"its start {peaks['monolithic'] / 2**20:.3f} MiB, the stream resident before it")
        for n in RUNNER_CHUNKS:
            label = f"runner --stream_chunk {n}"
            extra = peaks[label] - peaks["monolithic"]
            allowed = (2 * n * frame_bytes(st, cfg) + tick_output_bytes(cfg, n * B)
                       + sum(v.nbytes for v in std.prefix.values())
                       + 512 * (2 * len(st.frames) + len(st.prefix) + 8))
            check(extra <= allowed, f"{label}: the streamed run's peak is {extra} bytes above "
                                    f"the monolithic run's, over two chunks and a chunk's "
                                    f"outputs ({allowed})")
            log(f"runner memory: {label}: peak above start {peaks[label] / 2**20:.3f} MiB, "
                f"{extra / 2**20:+.3f} MiB against the monolithic run, which holds the whole "
                f"stream's {whole / 2**20:.3f} MiB beside it (bound: two chunks and a chunk's "
                f"outputs, {allowed / 2**20:.3f} MiB)")

        # a checkpoint mid-sequence on the card: save, load, continue
        half = C // 2
        state = pkg.make_initial_state(cfg, std.R_init, device=DEVICE)
        state, _ = pkg.propagate_prefix(cfg, state, std.prefix)
        state, _ = pkg.run_filter(cfg, state, {k: v[:half] for k, v in std.frames.items()},
                                  assume_camera=True)
        path = str(Path(tmp) / "state.npz")
        save_state(path, state)
        restored = load_state(path, cfg, device=DEVICE)
        same_state("runner checkpoint: the restored state", restored, state)
        final, _ = pkg.run_filter(cfg, restored, {k: v[half:] for k, v in std.frames.items()},
                                  assume_camera=True)
        same_state("runner checkpoint: the resumed run", final, mono.final)
        log(f"runner checkpoint: saved after frame {half} of {C} "
            f"({Path(path).stat().st_size} bytes), loaded on the card, continued: every leaf "
            f"of the final state bitwise equal to the uninterrupted monolithic run")

        # a batch of noise realizations, unstreamed and streamed
        batched = []
        for label, extra in (("runner --batch", []),
                             ("runner --batch --stream_chunk 64", ["--stream_chunk", "64"])):
            errs, launches = runner_call(torch, K, [
                "--source", "synthetic", "--max_frames", str(RUNNER_BATCH_TICKS), "--device",
                DEVICE, "--batch", str(BATCH), "--data_root", tmp] + extra)
            e = np.asarray(errs)
            check(len(e) == BATCH and np.isfinite(e).all() and (e < 0.2).all(),
                  f"{label}: final position errors {np.round(e, 4).tolist()} m, not all under "
                  f"0.2 m")
            Cb, Bt, Bp = errs.blocks
            predicted = predicted_batched_launches(K, pkg.batched_dispatch(errs.cfg), Cb, Bt, Bp)
            for k, v in launches.items():
                check(v == 2 * predicted[k], f"{label}: {k} launched {v} times, one per call "
                                             f"site and frame predicts 2 x {predicted[k]}")
            overflow = (errs.final.diag.n_track_overflow
                        + errs.final.diag.n_update_overflow).cpu().numpy()
            check(not overflow.any(), f"{label}: capacity overflow {overflow.tolist()}")
            log(f"{label}: B={BATCH} x {Cb} frames x {Bt} ticks, final errors {e.min():.4f} to "
                f"{e.max():.4f} m (median {np.median(e):.4f}), overflow 0; timed run "
                f"{errs.seconds:.3f} s, "
                f"{BATCH * Cb / errs.seconds:.1f} aggregate frames/s; launches "
                f"{ {k: v for k, v in launches.items() if v} } (= 2 x one per call site and "
                f"frame)")
            batched.append(errs)
        same_state("runner --batch: the streamed", batched[1].final, batched[0].final)
        log("runner --batch: the streamed final states bitwise equal to the unstreamed")

        # the rendered source through both front-ends
        for frontend in ("fused", "host"):
            label = f"runner --source rendered --frontend {frontend}"
            t0 = time.perf_counter()
            m, launches = runner_call(torch, K, [
                "--source", "rendered", "--max_frames", str(RENDERED_TICKS), "--device", DEVICE,
                "--frontend", frontend, "--data_root", tmp])
            check_runner_run(K, label, m, launches, 0.5)
            log(f"{label}: {m.cfg.width}x{m.cfg.height} images, the call "
                f"{time.perf_counter() - t0:.1f} s (rendering on the host included)")


# ---------------------------------------------------------------------------
# phase 12: the compensated correction island
# ---------------------------------------------------------------------------

ISLAND_PAIRS = 10**6  # two_sum / two_prod pairs of check (a)
ISLAND_CAPTURE_TICKS = 400  # the circle run whose updates check (e) replays
ISLAND_MIN_UPDATES = 10
# ticks of the runs timed in turns, float64 and compensated island, single
# and batched (turns ABBA after the driven runs)
ISLAND_RATE_TICKS = 200
# a larger batch of the captured updates, for the batched island's peak
# memory a sequence
ISLAND_BIG_BATCH = 256
# the runner's classic in the JAX package's probe settings
# (scripts/classic_tpu_probe.py); the limits on its mean and final ATE are
# twice the CPU float64 island's row of docs/RESULTS.md (mid noise: 5.270 m
# and 26.247 m)
CLASSIC_ARGS = ["--source", "synthetic", "--sequence", "classic", "--noise_level", "mid",
                "--gen_noise", "default", "--max_frames", "30000"]
CLASSIC_TICKS = 10798
CLASSIC_LIMITS = (10.5, 52.5)


def _df64(r):
    """hi + lo of a DF pair, in float64 where it lies."""
    return r.hi.double() + r.lo.double()


def island_arithmetic(torch, dw, rng):
    """(a) two_sum and two_prod exact on ISLAND_PAIRS pairs whose magnitudes
    span 1e-12 to 1e12 (their products stay clear of underflow, where
    Dekker's split is no longer exact): hi + lo in float64 on the card equals
    the float64 sum and product; (b, first half) _exact_pow2 exact over
    [-126, 127], _floor_log2 exact at and just below every power of two."""
    n = ISLAND_PAIRS
    a, b = ((rng.standard_normal(n) * 10.0 ** rng.integers(-12, 13, n)).astype(np.float32)
            for _ in range(2))
    ta, tb = (torch.as_tensor(x, device=DEVICE) for x in (a, b))
    check(torch.equal(_df64(dw.two_sum(ta, tb)), ta.double() + tb.double()),
          "island (a): two_sum is not exact on the card")
    check(torch.equal(_df64(dw.two_prod(ta, tb)), ta.double() * tb.double()),
          "island (a): two_prod is not exact on the card")
    e = torch.arange(-126, 128, dtype=torch.int32, device=DEVICE)
    want = 2.0 ** np.arange(-126, 128.0)
    check(np.array_equal(dw._exact_pow2(e).double().cpu().numpy(), want),
          "island (b): _exact_pow2 is not exact on the card")
    m = torch.as_tensor(want, dtype=torch.float32, device=DEVICE)
    below = torch.nextafter(m[1:], torch.zeros_like(m[1:]))
    check(np.array_equal(dw._floor_log2(m).cpu().numpy(), np.arange(-126, 128))
          and np.array_equal(dw._floor_log2(below).cpu().numpy(), np.arange(-126, 127)),
          "island (b): _floor_log2 is not exact on the card")
    log(f"island (a): two_sum and two_prod exact against float64 on the card over {n:,} "
        f"pairs (magnitudes 1e-12 to 1e12); (b) _exact_pow2 exact over [-126, 127], "
        f"_floor_log2 exact at and below each power of two")


def capture_updates(torch, pkg, seq):
    """The default configuration with the island over ISLAND_CAPTURE_TICKS
    ticks of the circle on the card, recording (P, A, c) at each island call
    (copies on the card, read after the run); the calls with A != 0."""
    import msckf_tpu_torch.filter.update as up

    cfg = pkg.reference_experiment_config(correction_dtype="compensated")
    _, run = _run(torch, pkg, cfg, seq, DEVICE, ISLAND_CAPTURE_TICKS)
    calls = []
    island = up._correction_terms_compensated
    up._correction_terms_compensated = lambda c, P, A, cc: (
        calls.append((P.clone(), A.clone(), cc.clone())), island(c, P, A, cc))[1]
    try:
        run()
    finally:
        up._correction_terms_compensated = island
    torch.cuda.synchronize()
    # P and A symmetric to the last bit: the float64 chain forms
    # B^T = sigma^2 I + P A and the island B = sigma^2 I + A P, equal only
    # then (the loop's A and P carry float32 asymmetry of ~1e-8, which would
    # otherwise floor check (e) there)
    updates = [(0.5 * (P + P.mT), 0.5 * (A + A.mT), c) for P, A, c in calls
               if bool(torch.any(A != 0))]
    check(len(updates) >= ISLAND_MIN_UPDATES,
          f"island (e): {len(updates)} real updates captured, fewer than {ISLAND_MIN_UPDATES}")
    log(f"island: {len(calls)} island calls over {ISLAND_CAPTURE_TICKS} ticks of the circle on "
        f"the card, {len(updates)} with a real update (A != 0) kept for checks (b), (c), (e)")
    return updates


def island_slices(torch, dw, pkg, update):
    """(b, second half) every Ozaki slicing of one island call on a captured
    update (D = 207): its input |xn| < 2, and each slice on its level's grid
    step_l = 2^(-6-8l), with at most 8 significant bits, exact in bfloat16."""
    from msckf_tpu_torch.filter.update import _correction_terms_compensated

    cfg = pkg.reference_experiment_config(correction_dtype="compensated")
    seen = []
    slices8 = dw._slices8
    dw._slices8 = lambda xn, lo=None, levels=6: (
        lambda out: (seen.append((xn, out)), out)[1])(slices8(xn, lo, levels))
    try:
        _correction_terms_compensated(cfg, *update)
    finally:
        dw._slices8 = slices8
    worst_in = 0.0
    for xn, out in seen:
        worst_in = max(worst_in, float(xn.abs().max()))
        for lvl, s in enumerate(out):
            q = s / 2.0 ** (-6 - 8 * lvl)  # exact: a power of two
            check(torch.equal(q, torch.round(q)), f"island (b): a level-{lvl} slice is off "
                                                   f"its grid")
            check(float(q.abs().max()) <= 256, f"island (b): a level-{lvl} slice holds more "
                                               f"than 8 significant bits")
            check(torch.equal(s.to(torch.bfloat16).float(), s),
                  f"island (b): a level-{lvl} slice is not exact in bfloat16")
    check(worst_in < 2.0, f"island (b): a normalized operand reaches |xn| = {worst_in}")
    log(f"island (b): {len(seen)} slicings ({len(seen) * len(seen[0][1])} slices) of one "
        f"island call at D = {cfg.err_dim}: every slice on its grid, at most 8 bits, exact in "
        f"bfloat16; largest normalized input |xn| {worst_in!r} (< 2)")


def island_products(torch, dw, rng, update):
    """(c) ozaki_matmul and df_matmul on the card within the JAX tests'
    bounds of a float64 product taken on the card, and the card's hi + lo
    within 1e-11 of rowmax(A) * colmax(B) of the port's CPU result."""

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=DEVICE)

    A = rng.standard_normal((207, 207)).astype(np.float32)
    B = rng.standard_normal((207, 207)).astype(np.float32)
    d1, d2 = 10.0 ** rng.uniform(-6, 0, 207), 10.0 ** rng.uniform(-6, 0, 207)
    A64, B64 = rng.standard_normal((200, 200)), rng.standard_normal((200, 200))
    G = rng.standard_normal((100, 100))
    H = rng.standard_normal((40, 100))
    H[:, :15] = 0.0
    P_f, A_f = update[0].cpu().numpy(), update[1].cpu().numpy()
    cases = [  # name, A, B, A_lo, B_lo, bound against float64
        ("ozaki 207 x 207", A, B, None, None, 1e-12),
        ("ozaki 207 scaled rows / columns", A * d1[:, None], B * d2[None, :], None, None, 1e-12),
        ("ozaki 200 double-word", A64, B64, A64 - A64.astype(np.float32),
         B64 - B64.astype(np.float32), 1e-12),
        ("ozaki zero head vs 1e18", H.T @ H, (G @ G.T) * 1e18, None, None, 1e-10),
        (f"ozaki filter A P (D = {A_f.shape[0]})", A_f, P_f, None, None, 1e-10),
    ]
    rows = []
    for name, a, b, a_lo, b_lo, bound in cases:
        a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
        lo = {k: v for k, v in (("A_lo", a_lo), ("B_lo", b_lo)) if v is not None}
        got = dw.ozaki_matmul(dev(a32), dev(b32), **{k: dev(v) for k, v in lo.items()})
        cpu = dw.ozaki_matmul(torch.as_tensor(a32), torch.as_tensor(b32),
                              **{k: torch.as_tensor(np.asarray(v, np.float32))
                                 for k, v in lo.items()})
        rows.append((name, got, cpu, a32, b32, lo, bound))
    C = rng.standard_normal((150, 150)).astype(np.float32)
    D = rng.standard_normal((150, 150)).astype(np.float32)
    rows.append(("df_matmul 150 x 150", dw.df_matmul(dev(C), dev(D)),
                 dw.df_matmul(torch.as_tensor(C), torch.as_tensor(D)), C, D, {}, 1e-11))
    for name, got, cpu, a32, b32, lo, bound in rows:
        a64 = dev(a32).double() + (dev(lo["A_lo"]).double() if "A_lo" in lo else 0.0)
        b64 = dev(b32).double() + (dev(lo["B_lo"]).double() if "B_lo" in lo else 0.0)
        want = a64 @ b64
        rel = float((_df64(got) - want).abs().max() / want.abs().max())
        check(rel < bound, f"island (c): {name}: {rel:.2e} of float64 on the card, not under "
                           f"{bound:.0e}")
        # rowmax * colmax; a zero row (the zero head) must agree exactly
        scale = (np.abs(a32).max(axis=1)[:, None] * np.abs(b32).max(axis=0)[None, :])
        diff = np.abs(_df64(got).cpu().numpy() - _df64(cpu).numpy())
        vs_cpu = float(np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0),
                                np.where(diff > 0, np.inf, 0.0)).max())
        check(vs_cpu < 1e-11, f"island (c): {name}: card and CPU differ by {vs_cpu:.2e} of "
                              f"rowmax * colmax")
        extra = ""
        if name.startswith("df_matmul"):
            f32 = float((dev(a32) @ dev(b32)).double().sub(want).abs().max() / want.abs().max())
            check(rel < 1e-4 * f32, f"island (c): {name}: not 1e4 x better than float32 "
                                    f"({rel:.2e} vs {f32:.2e})")
            extra = f", float32 matmul {f32:.2e}"
        log(f"island (c): {name}: {rel:.2e} of the float64 product (bound {bound:.0e}){extra}; "
            f"card vs CPU {vs_cpu:.2e} of rowmax * colmax")
    try:
        dw.ozaki_matmul(torch.zeros(4, 300, device=DEVICE), torch.zeros(300, 4, device=DEVICE))
        check(False, "island (c): ozaki_matmul took K = 300")
    except ValueError:
        pass


def island_solves(torch, dw, rng):
    """(d) refined_solve "lu" and "ns" on the card under 1e-8 of a float64
    solve on tests/test_compensated.py's two conditioning cases, and the
    divergence safeguard at cond 1e8 to 1e12: finite, within 8x the plain
    float32 LU's error."""
    n = 100

    def solve(Bd, C, solver, iters):
        B32 = Bd.astype(np.float32)
        B = dw.DF(torch.as_tensor(B32, device=DEVICE),
                  torch.as_tensor((Bd - B32).astype(np.float32), device=DEVICE))
        X = dw.refined_solve(B, torch.as_tensor(C, dtype=torch.float32, device=DEVICE),
                             iters=iters, solver=solver)
        return _df64(X).cpu().numpy()

    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = 10.0 ** rng.uniform(-6, 0, n)
    scaling = d[:, None] * ((Q * np.logspace(0, -2, n)) @ Q.T) * d[None, :]
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    genuine = (Q * np.logspace(0, -4.5, n)) @ Q.T
    out = []
    for name, Bd in (("scaling", scaling), ("genuine", genuine)):
        C = (Bd @ rng.standard_normal((n, 4))).astype(np.float32)
        want = np.linalg.solve(Bd, C.astype(np.float64))
        for solver in ("lu", "ns"):
            rel = np.abs(solve(Bd, C, solver, 3) - want).max() / np.abs(want).max()
            check(rel < 1e-8, f"island (d): refined_solve {solver} {name}: {rel:.2e} >= 1e-8")
            out.append(f"{solver} {name} {rel:.2e}")
    for cond in (1e8, 1e10, 1e12):
        Q, _ = np.linalg.qr(rng.standard_normal((80, 80)))
        Bd = (Q * np.logspace(0, np.log10(cond), 80)) @ Q.T
        C = rng.standard_normal((80, 4))
        want = np.linalg.solve(Bd, C)
        got = solve(Bd, C, "lu", 5)
        rel = np.abs(got - want).max() / np.abs(want).max()
        x32 = np.linalg.solve(Bd.astype(np.float32), C.astype(np.float32))
        rel32 = np.abs(x32 - want).max() / np.abs(want).max()
        check(np.isfinite(got).all() and rel < 8.0 * max(rel32, 1e-7),
              f"island (d): safeguard at cond {cond:.0e}: {rel:.2e} against float32's "
              f"{rel32:.2e}")
        out.append(f"safeguard cond {cond:.0e} {rel:.2e} (float32 LU {rel32:.2e})")
    log("island (d): refined_solve on the card, relative error against float64: "
        + "; ".join(out))


def island_chain(torch, pkg, updates):
    """(e) the island on each captured update against the float64 and the
    plain float32 chains on the card (the float64 one in float64 throughout,
    with the float32 sigma^2 both others use). Its outputs, rounded to float32 as the
    filter takes them, within 1e-6 of the float64 chain's scale at worst
    over the updates. Before that rounding, its double-word results
    (``_compensated_chain``) against the float64 chain in float64 at worst
    under 0.05x the plain float32 chain's worst: rounded, both sides floor
    at one float32 ulp (up to 1.2e-7 of the scale), which on well
    conditioned updates is the float32 chain's own error. Then CUDA-event
    times of the chains, single (island_solver "lu") and under vmap at
    B = BATCH ("ns", as the batched dispatch sets it), the island's device
    ops a call, and the peak device memory of the batched island call at
    B = BATCH and B = ISLAND_BIG_BATCH."""
    import dataclasses

    from msckf_tpu_torch.filter.update import (
        _compensated_chain, _correction_terms, _correction_terms_compensated,
    )

    cfg = pkg.reference_experiment_config(correction_dtype="compensated")
    cfg64 = dataclasses.replace(cfg, correction_dtype="float64")
    cfg32 = dataclasses.replace(cfg, correction_dtype="float32")
    # the yardstick: the float64 chain in float64 throughout, on the same
    # float32 inputs and with the float32 sigma^2 that the island and the
    # float32 chain use (the float64 chain's own sigma^2 differs from it by
    # 3e-8, which would otherwise floor the comparison there)
    s2 = float(np.float32(cfg.sigma_image**2))
    f64 = dataclasses.replace(cfg, dtype="float64", correction_dtype="float64",
                              sigma_image=float(np.sqrt(s2)))
    check(abs(f64.sigma_image**2 - s2) <= 1e-15 * s2, "island (e): sigma^2 not float32's")
    worst = {}
    ratios = []
    for P, A, c in updates:
        d64, P64 = _correction_terms(f64, P.double(), A.double(), c.double())
        dd, Pd = _compensated_chain(cfg, P, A, c)
        outs = {"island": _correction_terms_compensated(cfg, P, A, c),
                "island unrounded": (_df64(dd), _df64(Pd)),
                "float32": _correction_terms(cfg32, P, A, c)}
        errs = {}
        for kind, (d, Pn) in outs.items():
            errs[f"{kind} delta"] = float((d.double() - d64).abs().max() / d64.abs().max())
            errs[f"{kind} P"] = float((Pn.double() - P64).abs().max() / P64.abs().max())
        for k, v in errs.items():
            check(np.isfinite(v), f"island (e): {k} error not finite")
            worst[k] = max(worst.get(k, 0.0), v)
        ratios.append(max(errs["island delta"] / max(errs["float32 delta"], 1e-30),
                          errs["island P"] / max(errs["float32 P"], 1e-30)))
    for q in ("delta", "P"):
        check(worst[f"island {q}"] < 1e-6, f"island (e): {q} {worst[f'island {q}']:.2e} of the "
                                           f"float64 chain, not under 1e-6")
        check(worst[f"island unrounded {q}"] < 0.05 * worst[f"float32 {q}"],
              f"island (e): {q}: the island's worst {worst[f'island unrounded {q}']:.2e} before "
              f"rounding is not under 0.05x the float32 chain's {worst[f'float32 {q}']:.2e}")
    log(f"island (e): {len(updates)} real updates of the circle, D = {cfg.err_dim}, worst "
        f"relative error against the float64 chain: island delta "
        f"{worst['island delta']:.2e}, P {worst['island P']:.2e} (rounded to float32), "
        f"{worst['island unrounded delta']:.2e} and {worst['island unrounded P']:.2e} "
        f"(double-word, before rounding); plain float32 delta {worst['float32 delta']:.2e}, "
        f"P {worst['float32 P']:.2e}; per update, rounded island / float32: median "
        f"{np.median(ratios):.3f}, max {max(ratios):.3f}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    P, A, c = updates[-1]
    chains = {
        "island": lambda: _correction_terms_compensated(cfg, P, A, c),
        "float64 chain": lambda: _correction_terms(cfg64, P, A, c),
        "float32 chain": lambda: _correction_terms(cfg32, P, A, c),
    }
    ops = {}
    for name, fn in chains.items():
        fn()
        torch.cuda.synchronize()
        # device ops a call, over five calls (with device activity alone,
        # the window of a ~1 ms chain came back short or empty)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        ops[name] = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 5
    # the batch: BATCH captured updates (repeated in order if fewer)
    idx = [i % len(updates) for i in range(BATCH)]
    Pb, Ab, cb = (torch.stack([updates[i][j] for i in idx]) for j in range(3))
    cfg_ns = dataclasses.replace(cfg, island_solver="ns")
    batched = {
        "island": torch.func.vmap(lambda p, a, cc: _correction_terms_compensated(cfg_ns, p, a, cc)),
        "float64 chain": torch.func.vmap(lambda p, a, cc: _correction_terms(cfg64, p, a, cc)),
    }
    vm = batched["island"](Pb, Ab, cb)
    for b in range(BATCH):
        d64, _ = _correction_terms(cfg64, *updates[idx[b]])
        rel = float((vm[0][b].double() - d64.double()).abs().max() / d64.double().abs().max())
        check(rel < 1e-6, f"island (e): batched island (ns) delta of system {b}: {rel:.2e}")
    peaks = {}
    for nb in (BATCH, ISLAND_BIG_BATCH):
        big = [i % len(updates) for i in range(nb)]
        args = [torch.stack([updates[i][j] for i in big]) for j in range(3)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        batched["island"](*args)
        torch.cuda.synchronize()
        peaks[nb] = torch.cuda.max_memory_allocated() - start
        del args
    for name, fn in chains.items():
        one = time_ms(torch, fn, reps=15)
        many = time_ms(torch, lambda: batched[name](Pb, Ab, cb), reps=5) if name in batched else None
        log(f"island time: {name:14s} single {one:.3f} ms"
            + (f", B={BATCH} under vmap {many:.3f} ms ({many / BATCH:.3f} ms a system)"
               if many is not None else "")
            + f"; {ops[name]:.0f} device ops a single call")
    slope = (peaks[ISLAND_BIG_BATCH] - peaks[BATCH]) / (ISLAND_BIG_BATCH - BATCH)
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"island memory: the batched island call (island_solver 'ns') peaks "
        f"{peaks[BATCH] / 2**20:.1f} MiB above its inputs at B={BATCH}, "
        f"{peaks[ISLAND_BIG_BATCH] / 2**20:.1f} MiB at B={ISLAND_BIG_BATCH}: "
        f"{slope / 2**20:.2f} MiB a sequence, the card's {total / 2**30:.1f} GiB at about "
        f"B={int(total / slope)}")


def log_turns(torch, label, runs):
    """Frames/s of the float64 and the compensated island's runs, taken in
    turns ABBA (``runs`` maps each to (run, frames): the camera frames of
    one sequence, or of every sequence of a batch)."""
    times = timed_runs(torch, {k: v[0] for k, v in runs.items()},
                       ["float64", "compensated", "compensated", "float64"])
    for name, (_, frames) in runs.items():
        log(f"rates: {label} {name} in turns {_rate(frames, times[name])}")
    t64, tc = (float(np.median(times[k])) for k in ("float64", "compensated"))
    log(f"rates: {label} compensated / float64 frames/s {t64 / tc:.3f} ({ISLAND_RATE_TICKS} "
        f"ticks each, in turns ABBA)")


def island_circle(torch, pkg, K, seq, driven=None):
    """(f) the whole circle on the single loop with the island, in the
    default configuration and with update_kernel="fused", each beside the
    float64 island's driven run (phases main and fused, when they ran in
    this call, else driven here first): error, overflow and launches
    (drive), the same launches and host syncs as the float64 run; the sync
    check of the default island. The runs share the card with the classic
    runs of check (h), so their seconds are no rate of record."""
    import dataclasses

    driven = driven or {}
    for label, overrides in (("default", {}), ("fused", {"update_kernel": "fused"})):
        f64 = pkg.reference_experiment_config(**overrides)
        comp = dataclasses.replace(f64, correction_dtype="compensated")
        if label in driven:
            _, _, l64, _, s64 = driven[label]
        else:
            _, s64, l64, _, _ = drive(torch, pkg, K, seq, f64, f"island {label} float64")
        _, sc, lc, _, _ = drive(torch, pkg, K, seq, comp, f"island {label} compensated")
        check(lc == l64, f"island (f) {label}: launches {lc} differ from the float64 island's "
                         f"{l64}")
        check(sc.host_syncs == s64.host_syncs and sc.frames == s64.frames,
              f"island (f) {label}: {sc.host_syncs} host syncs over {sc.frames} frames against "
              f"the float64 island's {s64.host_syncs} over {s64.frames}")
        log(f"island (f) {label}: launches and host syncs equal to the float64 island's "
            f"({sc.host_syncs / sc.frames:.3f} a frame)")
        if label == "default":
            sstats = pkg.FrameStats()
            _, srun = _run(torch, pkg, comp, seq, DEVICE, SOLVER_TICKS, sstats)
            sites = sync_check(torch, srun, sstats, "island default compensated")
            log(f"island (f) default: sync check over {SOLVER_TICKS} ticks: PyTorch sync-debug "
                f"warnings {sum(sites.values())}, by site {sites} (the port's equal the loop's "
                f"count)")


def island_single_turns(torch, pkg, seq):
    """Frames/s of the single default loop with the float64 and the
    compensated island, ISLAND_RATE_TICKS ticks of the circle each in turns
    ABBA."""
    import dataclasses

    f64 = pkg.reference_experiment_config()
    runs = {}
    for name, cfg in (("float64", f64),
                      ("compensated", dataclasses.replace(f64, correction_dtype="compensated"))):
        std, run = _run(torch, pkg, cfg, seq, DEVICE, ISLAND_RATE_TICKS)
        runs[name] = (run, std.frames["imu_ts"].shape[0])
    log_turns(torch, "island single", runs)


def island_batched_turns(torch, pkg):
    """Aggregate frames/s of BATCH seeds on the batched loop with the
    float64 and the compensated island, ISLAND_RATE_TICKS ticks each in
    turns ABBA."""
    import dataclasses

    from msckf_tpu_torch.data.stream import to_device

    base = pkg.reference_experiment_config()
    std = to_device(pkg.circle_streams(base, range(BATCH), max_ticks=ISLAND_RATE_TICKS), base,
                    DEVICE)
    runs = {}
    for kind in ("float64", "compensated"):
        cfg = dataclasses.replace(base, correction_dtype=kind)
        states = pkg.batched_initial_state(cfg, BATCH, std.R_init, device=DEVICE)
        runs[kind] = (lambda cfg=cfg, states=states: pkg.batched_run_sequence(
            cfg, states, std.prefix, std.frames, assume_camera=True, device=DEVICE),
            BATCH * std.frames["imu_ts"].shape[1])
    log_turns(torch, f"island batched B={BATCH} aggregate", runs)


def island_batched(torch, pkg, K, f64=None):
    """(g) BATCH seeds of the whole circle on the batched loop with the
    island (default dispatch: island_solver "ns"): every sequence under
    0.2 m, no overflow, one launch per call site and frame, no functorch
    fallback, 0 host syncs, its peak device memory. The float64 island's
    run is phase batched's when it ran in this call (``f64`` = (frames,
    seconds)), else run here first. The runs share the card with the
    classic runs of check (h), so their seconds are no rate of record."""
    import dataclasses

    from msckf_tpu_torch.data.stream import to_device
    from msckf_tpu_torch.data.synthetic import generate_circle_sequence

    gt = generate_circle_sequence(rng=np.random.default_rng(0)).poses_t[-1]
    base = pkg.reference_experiment_config()
    std = to_device(pkg.circle_streams(base, range(BATCH)), base, DEVICE)
    C, Bt = std.frames["imu_ts"].shape[1:3]
    Bp = std.prefix["imu_ts"].shape[1]
    seconds = {}
    if f64 is not None:
        check(f64[0] == C, "island (g): the batched phase's circle differs in frames")
        seconds["float64"] = f64[1]
    for kind in ("float64", "compensated"):
        if kind in seconds:
            continue
        cfg = dataclasses.replace(base, correction_dtype=kind)
        label = f"island batched {kind}"
        states = pkg.batched_initial_state(cfg, BATCH, std.R_init, device=DEVICE)
        stats = pkg.FrameStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        K.reset_launches()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            t0 = time.perf_counter()
            final, _, _ = pkg.batched_run_sequence(cfg, states, std.prefix, std.frames,
                                                   assume_camera=True, device=DEVICE,
                                                   stats=stats)
            torch.cuda.synchronize()
            seconds[kind] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - start
        launches = K.launch_counts()
        err = np.linalg.norm(final.imu.p_WI.double().cpu().numpy() - gt, axis=-1)
        check(np.isfinite(err).all() and (err < 0.2).all(),
              f"{label}: final position errors {np.round(err, 4).tolist()} m, not all under 0.2 m")
        overflow = (final.diag.n_track_overflow + final.diag.n_update_overflow).cpu().numpy()
        check(not overflow.any(), f"{label}: capacity overflow {overflow.tolist()}")
        check(stats.host_syncs == 0, f"{label}: {stats.host_syncs} host syncs")
        dcfg = pkg.batched_dispatch(cfg)
        predicted = predicted_batched_launches(K, dcfg, C, Bt, Bp)
        for k, v in launches.items():
            check(v == predicted[k], f"{label}: {k} launched {v} times, one per call site and "
                                     f"frame predicts {predicted[k]}")
        log(f"{label}: B={BATCH} x {C} frames, island_solver={dcfg.island_solver!r}; final "
            f"errors {err.min():.4f} to {err.max():.4f} m (median {np.median(err):.4f}), "
            f"overflow 0, 0 host syncs, launches = one per call site and frame; "
            f"{seconds[kind]:.3f} s beside the classic runs; peak device memory "
            f"{peak / 2**20:.1f} MiB above the streams")


# one runner call in its own process, printing its numbers as the last line
_RUNNER_CHILD = """
import json, sys
import numpy as np
import chip_smoke as cs
from msckf_tpu_torch import runner
from msckf_tpu_torch.ops import kernels as K
m = runner.main(sys.argv[1:])
ate = np.linalg.norm(m.ate, axis=1)
print(json.dumps({
    "ticks": len(ate), "finite": bool(np.isfinite(m.ate).all() and np.isfinite(m.aoe).all()),
    "mean_ate": float(ate.mean()), "final_ate": float(ate[-1]),
    "median_rte_pct": float(np.median(m.rte) * 100), "diag": m.diag,
    "launches": K.launch_counts(),
    "predicted": cs.predicted_launches(K, m.cfg, m.stats, *m.blocks),
    "blocks": list(m.blocks), "f_max": m.cfg.f_max, "u_max": m.cfg.u_max,
    "prunes": int(m.stats.prunes), "syncs_per_frame": m.stats.host_syncs / m.stats.frames,
    "consistency": m.consistency, "profiling": m.profiling,
}, default=lambda x: x.item()))
"""


@contextlib.contextmanager
def classic_runs():
    """Start the runner's classic (CLASSIC_TICKS ticks, mid noise,
    --gen_noise default) with the island and with the float64 island, in
    two processes at once (the card is idle most of a frame), their output
    to files. Yields ({kind: (process, stdout file, stderr file)}, start
    time); kills what still runs on leaving."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp())
    procs = {}
    try:
        t0 = time.perf_counter()
        for kind in ("compensated", "float64"):
            out, err = tmp / f"{kind}.out", tmp / f"{kind}.err"
            with open(out, "w") as fo, open(err, "w") as fe:
                procs[kind] = (subprocess.Popen(
                    [sys.executable, "-c", _RUNNER_CHILD, *CLASSIC_ARGS, "--device", DEVICE,
                     "--data_root", str(tmp), "--correction_dtype", kind],
                    cwd=REPO, stdout=fo, stderr=fe, text=True), out, err)
        yield procs, t0
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def island_classic(procs, t0, beside: str):
    """(h) the two classic runs of ``classic_runs``: no NaN, mean and final
    ATE within CLASSIC_LIMITS, no overflow, launches twice the loop's
    prediction (warm-up and timed run). ``beside``: what ran beside them."""
    for p, _, _ in procs.values():
        p.wait(timeout=max(900 - (time.perf_counter() - t0), 1))
    wall = time.perf_counter() - t0
    for kind, (p, out, err) in procs.items():
        label = f"island (h) classic {kind}"
        check(p.returncode == 0, f"{label}: exit {p.returncode}: {err.read_text()[-2000:]}")
        r = json.loads(out.read_text().strip().splitlines()[-1])
        check(r["ticks"] == CLASSIC_TICKS, f"{label}: {r['ticks']} ticks, not {CLASSIC_TICKS}")
        check(r["finite"], f"{label}: NaN or inf in the trajectory's errors")
        check(r["mean_ate"] <= CLASSIC_LIMITS[0] and r["final_ate"] <= CLASSIC_LIMITS[1],
              f"{label}: mean ATE {r['mean_ate']:.3f} m, final {r['final_ate']:.3f} m, over the "
              f"limits {CLASSIC_LIMITS}")
        overflow = r["diag"]["n_track_overflow"] + r["diag"]["n_update_overflow"]
        check(overflow == 0, f"{label}: capacity overflow {overflow}")
        for k, v in r["launches"].items():
            check(v == 2 * r["predicted"][k], f"{label}: {k} launched {v} times, the loop "
                                              f"predicts 2 x {r['predicted'][k]}")
        c, prof = r["consistency"], r["profiling"]
        log(f"{label}: {r['ticks']} ticks, {r['blocks'][0]} frames, f_max={r['f_max']} "
            f"u_max={r['u_max']}; median RTE {r['median_rte_pct']:.3f} %, mean ATE "
            f"{r['mean_ate']:.3f} m, final ATE {r['final_ate']:.3f} m (limits "
            f"{CLASSIC_LIMITS}); ATE within 3-sigma {c['ate_within_3sigma']:.3f}, AOE "
            f"{c['aoe_within_3sigma']:.3f}; overflow 0, {r['prunes']} prunes, host syncs per "
            f"frame {r['syncs_per_frame']:.3f}; launches = 2 x predicted; warm-up "
            f"{prof['warmup_s']} s, timed run {prof['sequence_s']:.3f} s "
            f"({prof['camera_updates_per_s']} camera updates/s, beside the other run and "
            f"{beside})")
    log(f"island (h): both classic runs in {wall:.1f} s, in two processes at once beside "
        f"{beside}")


def phase_island(torch, pkg, K, seq, driven=None, batched_f64=None, beside=None):
    """The double-word correction island on the card: its arithmetic, the
    slices, the products, the solves, the chain on real updates, the single
    and the batched circle (beside the float64 island's driven runs of the
    earlier phases where they ran), and the runner's classic. ``beside``:
    work run after (f) and (g) while the classic runs go on."""
    from msckf_tpu_torch.ops import compensated as dw

    rng = np.random.default_rng(15)
    island_arithmetic(torch, dw, rng)
    updates = capture_updates(torch, pkg, seq)
    island_slices(torch, dw, pkg, updates[-1])
    island_products(torch, dw, rng, updates[-1])
    island_solves(torch, dw, rng)
    island_chain(torch, pkg, updates)
    island_single_turns(torch, pkg, seq)
    island_batched_turns(torch, pkg)
    # the classic runs share the card with checks (f) and (g), whose times
    # no rate reads, and with ``beside``
    with classic_runs() as (procs, t0):
        island_circle(torch, pkg, K, seq, driven)
        island_batched(torch, pkg, K, batched_f64)
        if beside is not None:
            beside()
        island_classic(procs, t0,
                       "checks (f) and (g)" + (" and phase sources" if beside else ""))


# ---------------------------------------------------------------------------
# phase 13: the dataset sources
# ---------------------------------------------------------------------------

# TartanAir's published camera: 640 x 480, fx = fy = 320, cx = 320, cy = 240
TARTANAIR_CAMERA = dict(width=640, height=480, fxy=320.0)
SOURCES_FRAMES = 100  # camera frames of the boxes orbit: 910 IMU ticks
PERINGLAB_FRAMES = 24
RENDER_WORKERS = 6  # processes rendering the orbit's frames (beside the classic runs)
LIVE_CHUNK = 16  # frames a chunk of the live-streamed run
LIVE_TICKS = 400


def sources_decode(frames, width, height):
    """Both grey reads of every frame, timed on the host, and one frame's
    rows unfiltered by the native library and by the plain version (equal
    bytes; both times)."""
    import zlib

    from msckf_tpu_torch.data import imageio

    times = {}
    for name, read in (("IMREAD_GRAYSCALE", imageio.imread_grayscale),
                       ("cvtColor", imageio.imread_color_gray)):
        t0 = time.perf_counter()
        for p in frames:
            img = read(p)
            check(img.shape == (height, width) and img.dtype == np.uint8,
                  f"sources: {name} read {img.shape} {img.dtype}")
        times[name] = (time.perf_counter() - t0) * 1e3 / len(frames)
    data = Path(frames[0]).read_bytes()
    raw = np.frombuffer(zlib.decompress(b"".join(
        body for ctype, body in imageio._chunks(data, frames[0]) if ctype == "IDAT")), np.uint8)
    t0 = time.perf_counter()
    native = imageio.unfilter(raw, height, 3 * width, 3)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = imageio.unfilter_plain(raw, height, 3 * width, 3)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(native, plain), "sources: the native unfilter differs from the plain")
    kinds = np.bincount(raw.reshape(height, -1)[:, 0], minlength=5)
    log(f"sources: decode on the card's host, {len(frames)} RGB PNG frames of {width}x{height}: "
        f"{times['IMREAD_GRAYSCALE']:.2f} ms a frame (IMREAD_GRAYSCALE formula), "
        f"{times['cvtColor']:.2f} ms (cvtColor formula); one frame's rows (filter types "
        f"{kinds.tolist()}) unfiltered in {native_ms:.2f} ms by the native library, "
        f"{plain_ms:.1f} ms by the plain version, equal bytes")


def sources_live(torch, pkg, K):
    """LiveRerunStream with a recording sink on the circle streamed in
    LIVE_CHUNK-frame chunks: one log record a tick, each tick's estimated
    position, track and camera counts those of the run's outputs, launches
    as the loop predicts."""
    from msckf_tpu_torch.data.stream import build_stream
    from msckf_tpu_torch.data.synthetic import generate_circle_sequence
    from msckf_tpu_torch.filter.streamed import run_sequence_streamed
    from msckf_tpu_torch.utils.viz import HAVE_RERUN, LiveRerunStream

    cfg = pkg.reference_experiment_config()
    seq = generate_circle_sequence(rng=np.random.default_rng(0), desc_dim=10)
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores,
                      max_ticks=LIVE_TICKS)
    from tests.torch_fixtures import RecordingSink

    sink = RecordingSink()
    live = LiveRerunStream(seq.poses_R, seq.poses_t, sink=sink)
    stats = pkg.FrameStats()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    _, pre, fr = run_sequence_streamed(
        cfg, pkg.make_initial_state(cfg, st.R_init, device=DEVICE), st.prefix, st.frames,
        chunk_frames=LIVE_CHUNK, device=DEVICE, assume_camera=True, stats=stats,
        on_prefix=live.consume, on_chunk=lambda start, out: live.consume(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    C, B = st.frames["imu_ts"].shape
    predicted = predicted_launches(K, cfg, stats, C, B, st.prefix["imu_ts"].shape[0])
    for k, v in launches.items():
        check(v == predicted[k], f"sources live: {k} launched {v} times, the loop predicts "
                                 f"{predicted[k]}")

    def flat(name):
        a, b = np.asarray(getattr(pre, name)), np.asarray(getattr(fr, name))
        return np.concatenate([a, b.reshape((-1,) + b.shape[2:])])

    valid = flat("valid").astype(bool)
    ticks = [c for c in sink.calls if c[0] == "set_time"]
    logs = {}
    for c in sink.calls:
        if c[0] == "log":
            logs.setdefault(c[1], []).append(c[2])
    n = int(valid.sum())
    check(len(ticks) == n and [c[2] for c in ticks] == list(range(n)),
          f"sources live: {len(ticks)} ticks logged, the run has {n}")
    check(all(len(v) == n for v in logs.values()) and len(logs) == 21,
          f"sources live: {len(logs)} log paths, counts {sorted({len(v) for v in logs.values()})}")
    if not HAVE_RERUN:  # the payloads are (name, data) pairs without rerun
        est = logs["world/estimated_trajectory"][-1][1]
        check(np.array_equal(est, flat("p_WI")[valid]),
              "sources live: the logged trajectory differs from the run's outputs")
        check([p[1] for p in logs["msckf/features"]] == flat("n_tracks")[valid].tolist()
              and [p[1] for p in logs["msckf/camera_states"]] == flat("n_cams")[valid].tolist(),
              "sources live: the logged track or camera counts differ from the run's outputs")
    log(f"sources live: LiveRerunStream with a recording sink on the circle, {LIVE_TICKS} ticks "
        f"streamed in {LIVE_CHUNK}-frame chunks ({-(-C // LIVE_CHUNK)} chunks): {n} ticks "
        f"logged, {len(sink.calls)} calls, the trajectory and counts those of the run's "
        f"outputs; launches = predicted; {wall:.2f} s with the logging")


def phase_sources(torch, pkg, K):
    """The TartanAir- and PeringLab-format sources on the card through the
    port's CLI, the PNG codec and the native reader on the card's host, and
    LiveRerunStream on a streamed run."""
    import tempfile

    from msckf_tpu_torch.data import native_io
    from msckf_tpu_torch.data.parser import read_table
    from tests.torch_fixtures import write_orbit_dataset

    check(native_io.have_native(), "sources: the native host library did not build")
    cam = TARTANAIR_CAMERA
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        seq_dir = write_orbit_dataset(tmp, "tartanair", "orbit", n_cam=SOURCES_FRAMES, rgb=True,
                                      filters=range(5), workers=RENDER_WORKERS, **cam)
        log(f"sources: {SOURCES_FRAMES} frames of the boxes orbit at TartanAir's camera "
            f"({cam['width']}x{cam['height']}, f {cam['fxy']}) rendered and written as RGB "
            f"PNGs, filter types 0-4 by rows in turn, in {time.perf_counter() - t0:.1f} s "
            f"({RENDER_WORKERS} processes)")
        frames = sorted(str(p) for p in (Path(seq_dir) / "cam").iterdir())
        sources_decode(frames, cam["width"], cam["height"])

        for source, frontend in (("tartanair", "fused"), ("tartanair", "host"),
                                 ("peringlab", "fused")):
            if source == "peringlab":
                write_orbit_dataset(tmp, "peringlab", "orbit", n_cam=PERINGLAB_FRAMES,
                                    workers=RENDER_WORKERS, **cam)
            label = f"sources --source {source} --frontend {frontend}"
            t0 = time.perf_counter()
            m, launches = runner_call(torch, K, [
                "--source", source, "--sequence", "orbit", "--data_root", tmp,
                "--noise_level", "low", "--max_frames", "1000", "--refine_subpix",
                "--frontend", frontend, "--device", DEVICE])
            call_s = time.perf_counter() - t0
            check(np.isfinite(m.ate).all() and np.isfinite(m.aoe).all(),
                  f"{label}: NaN or inf in the trajectory's errors")
            check((m.cfg.width, m.cfg.height, m.cfg.K[0][0]) == (cam["width"], cam["height"],
                                                                 cam["fxy"]),
                  f"{label}: the camera_info.csv camera was not taken")
            check_runner_run(K, label, m, launches, 0.5)
            p = m.profiling
            load_s = call_s - p["warmup_s"] - p["sequence_s"]
            log(f"{label}: the call {call_s:.1f} s, loading {load_s:.1f} s "
                f"(IMU generation, parsing, rasters{', features' if frontend == 'host' else ''}); "
                f"timed run {p['sequence_s']:.3f} s, {p['camera_updates_per_s']} camera "
                f"frames/s")
            if source == "tartanair" and frontend == "fused":
                # the native reader against the csv reader on the generated IMU
                imu = f"{seq_dir}/imu.csv"
                a = native_io.read_numeric_csv(imu)
                b = np.stack(list(read_table(imu).values()), axis=-1)
                check(a.shape == b.shape and np.array_equal(a.view(np.uint64),
                                                            b.view(np.uint64)),
                      "sources: the native reader differs from the csv reader on imu.csv")
                log(f"sources: imu.csv ({a.shape[0]} rows) read by the native library bitwise "
                    f"as by the csv reader")
    sources_live(torch, pkg, K)


# ---------------------------------------------------------------------------
# phase train: the XFeat trainer (models/train_xfeat.py), float32, TF32 off
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SIZE = 8, 256  # the trainer CLI's defaults
# (b): from scratch, 200 steps, a 32-pair pool refreshed by 8 every 50 steps
TRAIN_RUN = dict(steps=200, batch=TRAIN_BATCH, size=TRAIN_SIZE, lr=1e-3, pool_pairs=32,
                 refresh_every=50, refresh_n=8, seed=0)
TRAIN_WINDOW = 20  # steps averaged at each end of (b)'s loss curve
TRAIN_CLI = ["--steps", "20", "--pool", "8"]  # (e), the CLI's other defaults
# (a) card against CPU, float32, one step from the committed weights: each
# tensor's largest error over its largest magnitude (cuDNN's and oneDNN's
# float32 convolutions round differently; the loss's softmax at temperature
# 0.1 and the batch-statistics backward amplify that)
# (four card runs: loss and aux 2.8e-7, the worst gradient 5.1e-4 in
# block1_0's kernel, median 3.8e-6 to 4.7e-6, statistics 5.1e-7). The same
# step with TF32 on is the control and must break at least one limit (it
# read loss 2.7e-5, gradient 1.0e-1, statistics 1.5e-3; the loss limit was
# then cut from 1e-4 to 1e-5 so that it catches TF32 too).
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-3, "stats": 1e-4}
TRAIN_PROFILE_STEPS = 3
TRAIN_OPT_TOL = 1e-12  # (a) the optimizer, card against CPU, from the same float64 gradients
FROZEN_TOL = {"precision": 0.01, "matches": 1.0}  # (c) card against CPU, per distribution
FROZEN_GATES = {"hard": 0.60, "mild": 0.52, "matches": 60}  # tests/test_xfeat_frozen_eval.py


def _rel_err(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def train_step_card_vs_cpu(torch, tx):
    """(a): one batch_loss and backward from the committed weights on the
    card and on the CPU, the same seeded batch at the CLI's width, and the
    control: the card's step with TF32 on, which the limits must catch; then
    the optimizer on both from the same float64 gradients."""
    from msckf_tpu_torch.models.xfeat import load_xfeat_npz
    from msckf_tpu_torch.ops.precision import set_f32_matmuls

    t0 = time.perf_counter()
    pool = tx.PairPool(np.random.default_rng(0), TRAIN_BATCH, TRAIN_SIZE)
    batch = pool.draw(TRAIN_BATCH)
    log(f"train (a): a {TRAIN_BATCH}-pair pool at {TRAIN_SIZE} x {TRAIN_SIZE} in "
        f"{time.perf_counter() - t0:.1f} s on the host")
    res = {}
    for run, dev in (("tf32", DEVICE), (DEVICE, DEVICE), ("cpu", "cpu")):
        model = load_xfeat_npz(str(WEIGHTS), device=dev)
        inputs = [torch.as_tensor(a, device=dev) for a in batch]
        if run == "tf32":  # batch_loss's body, past its with_f32_matmuls
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                loss, aux = tx.batch_loss.__wrapped__(model, *inputs)
                loss.backward()
            finally:
                set_f32_matmuls()
        else:
            loss, aux = tx.batch_loss(model, *inputs)
            loss.backward()
        res[run] = (loss, aux, {n: p.grad for n, p in model.named_parameters()},
                    dict(model.named_buffers()))
    p0 = [p.detach().double().numpy() for p in model.parameters()]  # the CPU model's
    lc, ac, gc, sc = res["cpu"]

    def errors(run):
        lg, ag, gg, sg = res[run]
        errs = {"loss": _rel_err(lg, lc)}
        errs.update({f"aux {k}": _rel_err(ag[k], ac[k]) for k in ac})
        return (errs, {n: _rel_err(gg[n], gc[n]) for n in gc},
                {n: _rel_err(sg[n], sc[n]) for n in sc})

    ctl = [max(e.values()) for e in errors("tf32")]
    broken = [k for k, e in zip(("loss", "grad", "stats"), ctl) if e > TRAIN_TOL[k]]
    log(f"train (a): the control, the card's step with TF32 on, against the CPU: loss and aux "
        f"{ctl[0]:.3e}, worst gradient {ctl[1]:.3e}, statistics {ctl[2]:.3e}; over the "
        f"limits: {', '.join(broken) or 'none'}")
    check(broken, "train (a): the step with TF32 on stays within every limit, so the "
          "limits would not catch it")
    errs, grad_errs, stat_errs = errors(DEVICE)
    worst_loss = max(errs.values())
    worst_g = max(grad_errs, key=grad_errs.get)
    worst_s = max(stat_errs, key=stat_errs.get)
    log(f"train (a): one step at batch {TRAIN_BATCH}, {TRAIN_SIZE} x {TRAIN_SIZE}, float32, "
        f"card against CPU: loss {float(lc.detach()):.6f}, aux "
        + ", ".join(f"{k} {float(v.detach()):.6f}" for k, v in ac.items())
        + "; relative errors " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"train (a): gradients of {len(gc)} parameters: largest relative error "
        f"{grad_errs[worst_g]:.3e} ({worst_g}), median {np.median(list(grad_errs.values())):.3e}; "
        f"new batch statistics of {len(sc)} buffers: largest {stat_errs[worst_s]:.3e} "
        f"({worst_s})")
    check(worst_loss <= TRAIN_TOL["loss"],
          f"train (a): loss or aux differs by {worst_loss:.3e} (limit {TRAIN_TOL['loss']})")
    check(grad_errs[worst_g] <= TRAIN_TOL["grad"],
          f"train (a): the gradient of {worst_g} differs by {grad_errs[worst_g]:.3e} "
          f"(limit {TRAIN_TOL['grad']})")
    check(stat_errs[worst_s] <= TRAIN_TOL["stats"],
          f"train (a): the batch statistics {worst_s} differ by {stat_errs[worst_s]:.3e} "
          f"(limit {TRAIN_TOL['stats']})")

    # the optimizer chain on both devices from identical float64 gradients:
    # three steps of a three-step schedule, the global norm above the clip
    # at the first and below it after
    rng = np.random.default_rng(1)
    grads = [[rng.normal(size=a.shape) * sc / np.sqrt(a.size * len(p0)) for a in p0]
             for sc in (3.0, 0.5, 0.2)]
    finals = {}
    for dev in (DEVICE, "cpu"):
        ps = [torch.tensor(a, device=dev, requires_grad=True) for a in p0]
        opt = tx.ClippedAdamW(ps, 1e-3, len(grads))
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = torch.tensor(g, device=dev)
            opt.step()
        finals[dev] = ps
    opt_err = max(float((a.detach().cpu() - b.detach()).abs().max())
                  for a, b in zip(finals[DEVICE], finals["cpu"]))
    log(f"train (a): ClippedAdamW, 3 steps on {len(p0)} float64 tensors from the same "
        f"gradients: card against CPU within {opt_err:.3e}")
    check(opt_err <= TRAIN_OPT_TOL,
          f"train (a): the optimizer differs by {opt_err:.3e} (limit {TRAIN_OPT_TOL})")


def phase_train(torch):
    """The XFeat trainer on the card: (a) a step and the optimizer against
    the CPU, (b) a training run from scratch, (c) the frozen benchmark
    against the CPU, (d) a weights round trip, (e) the CLI."""
    import tempfile

    from msckf_tpu_torch.models import frontend_eval as fe
    from msckf_tpu_torch.models import train_xfeat as tx
    from msckf_tpu_torch.models.xfeat import detect_and_compute, load_xfeat_npz

    train_step_card_vs_cpu(torch, tx)

    # (b) from scratch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, tlog = tx.train(**TRAIN_RUN, device=DEVICE)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - start_bytes
    losses = tlog.losses
    steps, imgs = TRAIN_RUN["steps"], 2 * TRAIN_RUN["batch"]
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"train (b): {int(np.sum(~np.isfinite(losses)))} non-finite losses")
    first, last = float(losses[:TRAIN_WINDOW].mean()), float(losses[-TRAIN_WINDOW:].mean())
    log(f"train (b): {steps} steps from scratch (batch {TRAIN_RUN['batch']}, "
        f"{TRAIN_RUN['size']} x {TRAIN_RUN['size']}, pool {TRAIN_RUN['pool_pairs']}): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first {TRAIN_WINDOW} {first:.4f}, "
        f"of the last {last:.4f} ({last / first:.3f}x)")
    check(last < 0.8 * first, f"train (b): no learning: {first:.4f} -> {last:.4f}")
    log(f"train (b): the loop {tlog.seconds:.2f} s: {steps / tlog.seconds:.2f} steps/s, "
        f"{steps * imgs / tlog.seconds:.1f} images/s; the pool's draws and refreshes "
        f"{tlog.pool_seconds:.2f} s on the host ({tlog.pool_seconds / tlog.seconds * 100:.1f} % "
        f"of the loop); the call {call_s:.1f} s with the pool's generation; peak allocation "
        f"{peak / 2**20:.1f} MiB")
    pool = tx.PairPool(np.random.default_rng(2), TRAIN_RUN["batch"], TRAIN_RUN["size"])
    batch = [torch.as_tensor(a, device=DEVICE) for a in pool.draw(TRAIN_RUN["batch"])]
    timed = copy.deepcopy(model)
    opt = tx.ClippedAdamW(timed.parameters(), TRAIN_RUN["lr"], 1000)
    step_ms = time_ms(torch, lambda: tx.train_step(timed, opt, *batch), reps=20)
    # the convolutions' operations: the forward's, counted by conv_flops on
    # an eval-mode copy, and twice that backward (input and weight gradients)
    x = torch.cat(batch[:2])[:, None]
    flops = 3.0 * conv_flops(torch, copy.deepcopy(timed).eval(), x)[0]
    bound, _ = bound_ms(0.0, flops, "float32")
    log(f"train (b): one step by CUDA events (no draw, inputs on the card): {step_ms:.3f} ms, "
        f"{1e3 / step_ms:.1f} steps/s, {imgs * 1e3 / step_ms:.0f} images/s; its convolutions "
        f"{flops / 1e9:.2f} GFLOP, bound {bound:.3f} ms (float32, 67 TFLOP/s), "
        f"{bound / step_ms * 100:.1f} % of the step")

    def steps():
        for _ in range(TRAIN_PROFILE_STEPS):
            tx.train_step(timed, opt, *batch)

    profile_window(torch, steps, TRAIN_PROFILE_STEPS, "train", unit="step")

    # (c) the frozen benchmark with the committed weights, card and CPU
    frozen = {}
    for dev in (DEVICE, "cpu"):
        m = load_xfeat_npz(str(WEIGHTS), device=dev)
        t0 = time.perf_counter()
        frozen[dev] = {h: fe.frozen_match_precision(m, hard=h == "hard") for h in ("hard", "mild")}
        log(f"train (c): frozen benchmark on {dev}: " + ", ".join(
            f"{h} {p:.4f} ({n:.2f} matches/pair)" for h, (p, n) in frozen[dev].items())
            + f" in {time.perf_counter() - t0:.1f} s")
    for h in ("hard", "mild"):
        (pg, ng), (pc, nc) = frozen[DEVICE][h], frozen["cpu"][h]
        check(abs(pg - pc) <= FROZEN_TOL["precision"] and abs(ng - nc) <= FROZEN_TOL["matches"],
              f"train (c): {h}: card {pg:.4f} ({ng:.2f}) against CPU {pc:.4f} ({nc:.2f})")
        check(pg >= FROZEN_GATES[h] and ng >= FROZEN_GATES["matches"],
              f"train (c): {h}: {pg:.4f} ({ng:.2f} matches/pair) under the gates")

    with tempfile.TemporaryDirectory() as tmp:
        # (d) the trained weights through an .npz and back, on the card
        path = f"{tmp}/trained.npz"
        tx.save_npz_params(path, model)
        back = load_xfeat_npz(path, device=DEVICE)
        with np.load(fe.FIXTURE_V1) as data:
            frame = torch.as_tensor(data["hard_img1"][0].astype(np.float32), device=DEVICE)
        a = detect_and_compute(model, frame, top_k=fe.TOP_K)
        b = detect_and_compute(back, frame, top_k=fe.TOP_K)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              "train (d): the reloaded weights' detect_and_compute differs from the model's")
        log(f"train (d): save_npz_params -> load_xfeat_npz on the card: detect_and_compute "
            f"bitwise the trained model's ({int(a[3].sum())} valid keypoints)")

        # (e) the CLI, in-process, on the card
        out = f"{tmp}/cli/xfeat.npz"
        t0 = time.perf_counter()
        tx.main([*TRAIN_CLI, "--out", out])
        cli_s = time.perf_counter() - t0
        m = load_xfeat_npz(out, device=DEVICE)
        check(all(torch.isfinite(t).all() for t in m.state_dict().values()),
              "train (e): the CLI's weights are not finite")
        log(f"train (e): train_xfeat.main({' '.join(TRAIN_CLI)}) in {cli_s:.1f} s; its "
            f"weights load on the card")


# ---------------------------------------------------------------------------
# phase 15: scale-out (the meshes, the multi-process run, sharded XFeat, the
# runner under torchrun, the DCP pair)
# ---------------------------------------------------------------------------

SCALEOUT_CAPS = dict(f_max=192, u_max=32, k_max=256, desc_dim=16)  # the runner's --batch
SCALEOUT_TICKS = 300  # the runner's --batch run of phase runner
SCALEOUT_SEED0 = 100  # the runner's first seed
SCALEOUT_CHUNK = 8  # frames a chunk of the streamed form
SCALEOUT_DEMO_ROWS = 16  # rows a rank of the two-process demo
SCALEOUT_SHARDMAP_FRAMES = 12  # frames of the shard-map and DCP runs
SCALEOUT_ALONE_FRAMES = 10  # frames of (f)'s timings with nothing beside them
SCALEOUT_IMAGES = 8  # 640 x 480 frames of the rendered circle through sharded XFeat
# float32, two shards of 16 against one launch of 32 (trajectories and the
# runner's final errors): the batched library products (cuBLAS) may round by
# batch shape, the kernels do not. Sound runs read 7.3e-12 and 9.4e-13 m; a
# row filtered on another row's data is off by ~1e-4 m or more
SCALEOUT_GAP = 1e-9
XFEAT_SHARD_TOL = 5e-4  # the JAX package's own, tests/test_xfeat_sharded.py:28
SCALEOUT_CHILD_S = 420  # the children's deadline, from the phase's start

# one rank of the runner under the torchrun environment contract
_RUNNER_RANK = """
import json
from msckf_tpu_torch import runner
errs = runner.main(%r)
print("ERRS " + json.dumps({"errs": list(errs), "seconds": errs.seconds}), flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(label, argvs, envs, tmp):
    """One process a rank, all at once, each one's output to a file."""
    import os

    procs = []
    for i, (argv, env) in enumerate(zip(argvs, envs)):
        path = tmp / f"{label.replace(' ', '_')}.{i}.log"
        with open(path, "w") as f:
            procs.append((subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=f,
                                           stderr=subprocess.STDOUT, text=True,
                                           env={**os.environ, **env}), path))
    return label, procs


def wait_ranks(ranks, deadline):
    """The ranks' outputs once all have exited; a rank that fails or
    outlives ``deadline`` (perf_counter) fails the phase, every rank's
    output logged."""
    label, procs = ranks
    late = False
    for p, _ in procs:
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            late = True
            break
    if late:
        for p, _ in procs:
            p.kill()
            p.wait()
    outs = [path.read_text() for _, path in procs]
    if late or any(p.returncode != 0 for p, _ in procs):
        for i, out in enumerate(outs):
            log(f"scaleout {label}: rank {i} output:\n{out[-3000:]}")
    check(not late, f"scaleout {label}: a rank outlived its deadline")
    for i, (p, _) in enumerate(procs):
        check(p.returncode == 0, f"scaleout {label}: rank {i} exited {p.returncode}")
    return outs


def phase_scaleout(torch, pkg, K):
    """Scale-out on the one card: (a) sharded_run_sequence over a two-shard
    mesh of the card, shardmap_run_sequence and the streamed form; (b) the
    multi-process functions at world size 1 over NCCL; (c) two processes on
    the card over gloo: the demo and the runner under the torchrun
    environment contract; (d) sharded XFeat, mesh (1, 1) over NCCL and
    (1, 2) and (2, 1) over two gloo ranks; (e) the DCP pair mid-sequence;
    (f) each form's wall time. The children start first and run beside
    (a), (b) and (e)."""
    import tempfile

    from msckf_tpu_torch.data.rendered import generate_rendered_circle
    from msckf_tpu_torch.data.stream import to_device
    from msckf_tpu_torch.data.synthetic import generate_circle_sequence
    from msckf_tpu_torch.filter.state import state_to_numpy
    from msckf_tpu_torch.filter.streamed import run_batched_streamed
    from msckf_tpu_torch.models.xfeat import batched_detect_and_compute, load_xfeat_npz
    from msckf_tpu_torch.parallel import multihost as mh
    from msckf_tpu_torch.parallel import multihost_demo as demo
    from msckf_tpu_torch.parallel import xfeat_sharded as xs
    from msckf_tpu_torch.parallel.batched import (
        data_mesh, sharded_run_sequence, shardmap_run_sequence,
    )
    from msckf_tpu_torch.utils.checkpoint import load_state_dcp, save_state_dcp

    start = time.perf_counter()
    card = gpu_name_and_power()
    cfg = pkg.reference_experiment_config(**SCALEOUT_CAPS)
    dcfg = pkg.batched_dispatch(cfg)
    host = pkg.circle_streams(cfg, range(SCALEOUT_SEED0, SCALEOUT_SEED0 + BATCH),
                              max_ticks=SCALEOUT_TICKS)
    std = to_device(host, cfg, DEVICE)
    C, Bt = std.frames["imu_ts"].shape[1:3]
    Bp = std.prefix["imu_ts"].shape[1]
    half = BATCH // 2
    card0 = "cuda:0" if DEVICE == "cuda" else DEVICE
    seq_img = generate_rendered_circle(rng=np.random.default_rng(0), n_ticks=90, width=640,
                                       height=480, fxy=320.0, camera_height=4.0)
    images = seq_img.images[:SCALEOUT_IMAGES]
    check(images.shape == (SCALEOUT_IMAGES, 480, 640), f"scaleout: images {images.shape}")
    walls = {}

    def rows(d, r):
        return {k: v[r] for k, v in d.items()}

    def states(n, r=slice(None)):
        return pkg.batched_initial_state(cfg, n, std.R_init[r], device=DEVICE)

    def timed(label, fn):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        return out, K.launch_counts()

    def same_outputs(label, a, b):
        for name, x, y in zip(a._fields, a, b):
            x, y = (torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v.cpu()
                    for v in (x, y))
            check(same_bits(torch, x, y), f"{label}: output {name} differs")

    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        np.save(tmp / "images.npy", images)
        children = []
        try:
            # (c) and (d)'s processes first: they run beside (a), (b) and (e)
            port = _free_port()
            children.append(start_ranks("demo", [
                ["-m", "msckf_tpu_torch.parallel.multihost_demo", "--coordinator",
                 f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i),
                 "--rows", str(SCALEOUT_DEMO_ROWS), "--device", DEVICE, "--backend", "gloo"]
                for i in range(2)], [{}] * 2, tmp))
            runner_argv = ["--batch", str(BATCH), "--max_frames", str(SCALEOUT_TICKS),
                           "--device", DEVICE, "--data_root", tmp_s]
            port = _free_port()
            children.append(start_ranks("runner", [["-c", _RUNNER_RANK % runner_argv]] * 2, [
                {"RANK": str(i), "LOCAL_RANK": str(i), "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)} for i in range(2)], tmp))
            children.append(start_ranks("runner one process",
                                        [["-c", _RUNNER_RANK % runner_argv]], [{}], tmp))
            port = _free_port()
            children.append(start_ranks("xfeat", [
                ["-m", "msckf_tpu_torch.parallel.xfeat_sharded", "--coordinator",
                 f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i),
                 "--images", str(tmp / "images.npy"), "--weights", str(WEIGHTS),
                 "--meshes", "1x2,2x1", "--top_k", str(IMAGE_TOP_K), "--out", str(tmp / "xfeat"),
                 "--device", DEVICE, "--backend", "gloo"] for i in range(2)], [{}] * 2, tmp))

            # (a) two shards of the card, 16 + 16 rows
            mesh2 = data_mesh(devices=[card0, card0])
            sharded, launches = timed(f"sharded 2 x {half}", lambda: sharded_run_sequence(
                cfg, mesh2, assume_camera=True)(states(BATCH), std.prefix, std.frames))
            pred = predicted_batched_launches(K, dcfg, C, Bt, Bp)
            for k in path_kernels(dcfg):
                check(launches[k] > 0, f"scaleout (a): kernel {k} never launched")
            for k, v in launches.items():
                check(v == 2 * pred[k], f"scaleout (a): {k} launched {v} times, two shards of "
                                        f"one per call site and frame predict 2 x {pred[k]}")
            for i in range(2):
                r = slice(i * half, (i + 1) * half)
                ref, _ = timed(f"batched {half} rows", lambda: pkg.batched_run_sequence(
                    cfg, states(half, r), rows(std.prefix, r), rows(std.frames, r),
                    assume_camera=True, device=DEVICE))
                label = f"scaleout (a) shard {i}"
                same_state(label, torch.utils._pytree.tree_map(lambda x: x[r], sharded[0]), ref[0])
                same_outputs(label, type(ref[1])(*(x[r] for x in sharded[1])), ref[1])
                same_outputs(label, type(ref[2])(*(x[r] for x in sharded[2])), ref[2])
            whole, _ = timed(f"batched {BATCH} rows", lambda: pkg.batched_run_sequence(
                cfg, states(BATCH), std.prefix, std.frames, assume_camera=True, device=DEVICE))
            diag_a, diag_b = (state_to_numpy(x[0]) for x in (sharded, whole))
            for k in ("diag.n_gating_rejected", "diag.n_epipolar_rejected",
                      "diag.n_homography_rejected", "diag.n_track_overflow",
                      "diag.n_update_overflow"):
                check(np.array_equal(diag_a[k], diag_b[k]), f"scaleout (a): {k} differs between "
                                                            f"two shards and one launch of {BATCH}")
            gaps = {}
            for name in ("p_WI", "v_WI", "R_WI", "sigma_pos", "n_cams", "n_tracks"):
                a, b = (getattr(x[2], name).double().cpu().numpy() for x in (sharded, whole))
                gaps[name] = float(np.abs(a - b).max())
            check(gaps["n_cams"] == 0 and gaps["n_tracks"] == 0,
                  f"scaleout (a): per-tick counts differ {gaps}")
            check(max(gaps[n] for n in ("p_WI", "v_WI", "R_WI")) <= SCALEOUT_GAP,
                  f"scaleout (a): two shards against one launch of {BATCH}: gaps {gaps}")
            p = sharded[0].imu.p_WI.double().cpu().numpy()
            gt = generate_circle_sequence(
                rng=np.random.default_rng(SCALEOUT_SEED0)).poses_t[host.n_ticks - 1]
            err = np.linalg.norm(p - gt, axis=-1)
            check(np.isfinite(err).all() and (err < 0.2).all(),
                  f"scaleout (a): final errors {np.round(err, 4).tolist()} m")
            log(f"scaleout (a): sharded_run_sequence over data_mesh([{card0}, {card0}]), "
                f"{half} + {half} of {BATCH} seeds x {C} frames x {Bt} ticks (+{Bp}), float32, the "
                f"runner's --batch capacities: each shard's rows bitwise batched_run_sequence of "
                f"those rows alone; against one launch of {BATCH}: counters and per-tick counts "
                f"equal, largest gaps p {gaps['p_WI']:.3g} m, v {gaps['v_WI']:.3g}, R "
                f"{gaps['R_WI']:.3g}, sigma_pos {gaps['sigma_pos']:.3g} (limit {SCALEOUT_GAP}); "
                f"final errors {err.min():.4f} to {err.max():.4f} m; launches "
                f"{ {k: v for k, v in launches.items() if v} } (= 2 x one per call site and "
                f"frame)")

            two = slice(0, 2)
            short = {k: v[:, :SCALEOUT_SHARDMAP_FRAMES] for k, v in std.frames.items()}
            sm, sm_launches = timed("shardmap 2 x 1", lambda: shardmap_run_sequence(cfg, mesh2)(
                states(2, two), rows(std.prefix, two), rows(short, two)))
            for k in path_kernels(cfg):
                check(sm_launches[k] > 0, f"scaleout (a) shardmap: kernel {k} never launched")
            singles = []
            for b in range(2):
                single, _ = timed(f"single {b}", lambda: pkg.run_sequence(
                    cfg, pkg.make_initial_state(cfg, std.R_init[b], device=DEVICE),
                    rows(std.prefix, b), rows(short, b), device=DEVICE))
                singles.append(single)
                label = f"scaleout (a) shardmap sequence {b}"
                same_state(label, torch.utils._pytree.tree_map(lambda x: x[b], sm[0]), single[0])
                same_outputs(label, _seq(sm[1], b), single[1])
                same_outputs(label, _seq(sm[2], b), single[2])
            log(f"scaleout (a): shardmap_run_sequence over the same mesh, one sequence a shard in "
                f"its own host thread, {SCALEOUT_SHARDMAP_FRAMES} frames, unbatched with every "
                f"default kernel "
                f"{ {k: v for k, v in sm_launches.items() if v} }: each bitwise its own "
                f"run_sequence")

            streamed, _ = timed("streamed sharded", lambda: run_batched_streamed(
                cfg, states(BATCH), host.prefix, host.frames, chunk_frames=SCALEOUT_CHUNK,
                assume_camera=True, sharding=mesh2))
            same_state("scaleout (a) streamed", streamed[0], sharded[0])
            same_outputs("scaleout (a) streamed", streamed[1], sharded[1])
            same_outputs("scaleout (a) streamed", streamed[2], sharded[2])
            log(f"scaleout (a): run_batched_streamed(sharding=the mesh), chunks of "
                f"{SCALEOUT_CHUNK} frames: bitwise the sharded run")

            # (b) world size 1 over NCCL, and (d)'s mesh (1, 1)
            mh.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
            try:
                check(torch.distributed.get_backend() == ("nccl" if DEVICE == "cuda" else "gloo"),
                      f"scaleout (b): backend {torch.distributed.get_backend()}")
                gmesh = mh.global_data_mesh(device=DEVICE)
                local = [mh.shard_global_batch(t, gmesh) for t in (states(BATCH), std.prefix,
                                                                     std.frames)]
                check(mh.local_batch_slice(BATCH) == (0, BATCH), "scaleout (b): local slice")
                mhout, _ = timed("multihost world 1", lambda: mh.multihost_run_sequence(
                    cfg, gmesh, assume_camera=True)(*local))
                same_state("scaleout (b)", mhout[0], whole[0])
                same_outputs("scaleout (b)", mhout[2], whole[2])
                gathered = mh.gather_global(mhout[2], gmesh)
                same_outputs("scaleout (b) gather_global", gathered, whole[2])
                log(f"scaleout (b): init_distributed at world size 1 over "
                    f"{torch.distributed.get_backend()}, global_data_mesh {gmesh}, "
                    f"shard_global_batch, multihost_run_sequence of {BATCH} rows: bitwise "
                    f"batched_run_sequence; gather_global (an all-gather of a group of one) "
                    f"returns the same bits")

                model = load_xfeat_npz(str(WEIGHTS), device=DEVICE)
                imgs = torch.as_tensor(images, device=DEVICE)
                ref_x, _ = timed("xfeat unsharded", lambda: batched_detect_and_compute(
                    model, imgs, top_k=IMAGE_TOP_K))
                xmesh = xs.xfeat_mesh(1, 1, device=DEVICE)
                sp = xs.shard_params(model, xmesh)
                got_x, _ = timed("xfeat mesh 1x1", lambda: xs.batched_detect_and_compute(
                    sp, imgs, top_k=IMAGE_TOP_K, mesh=xmesh))
                for name, a, b in zip(("kpts", "desc", "scores", "valid"), got_x, ref_x):
                    check(same_bits(torch, a, b), f"scaleout (d) mesh (1, 1): {name} differs")
                log(f"scaleout (d): mesh (1, 1) over {torch.distributed.get_backend()}, "
                    f"{SCALEOUT_IMAGES} frames of 640 x 480, top-{IMAGE_TOP_K}: bitwise the "
                    f"unsharded batched_detect_and_compute ({int(ref_x[3].sum())} valid keypoints)")
            finally:
                torch.distributed.destroy_process_group()

            # (e) the DCP pair mid-sequence, on the card
            hf = SCALEOUT_SHARDMAP_FRAMES // 2
            state = pkg.make_initial_state(cfg, std.R_init[0], device=DEVICE)
            state, _ = pkg.propagate_prefix(cfg, state, rows(std.prefix, 0))
            state, _ = pkg.run_filter(cfg, state, {k: v[0, :hf] for k, v in short.items()})
            path = str(tmp / "dcp")
            save_state_dcp(path, state)
            restored = load_state_dcp(path, cfg, device=DEVICE)
            same_state("scaleout (e): the restored state", restored, state)
            final, _ = pkg.run_filter(cfg, restored, {k: v[0, hf:] for k, v in short.items()})
            same_state("scaleout (e): the resumed run", final, singles[0][0])
            log(f"scaleout (e): save_state_dcp after frame {hf} of {SCALEOUT_SHARDMAP_FRAMES} (a "
                f"directory of "
                f"{sum(f.stat().st_size for f in Path(path).iterdir())} bytes), load_state_dcp "
                f"on the card, continued: every leaf of the final state bitwise the "
                f"uninterrupted run")

            # (c) and (d): the children
            deadline = start + SCALEOUT_CHILD_S
            one = json.loads(wait_ranks(children[2], deadline)[0].split("ERRS ")[-1]
                             .splitlines()[0])
            outs = wait_ranks(children[0], deadline)
            digests = []
            for i, out in enumerate(outs):
                m = [ln for ln in out.splitlines() if ln.startswith(f"MULTIHOST process {i}/2 ")]
                check(len(m) == 1 and f"local_rows={SCALEOUT_DEMO_ROWS}" in m[0],
                      f"scaleout (c) demo: rank {i} printed no MULTIHOST line")
                digests.append(m[0].split("digest=")[-1])
            cfg_d, std_d = demo.demo_inputs(40)
            dstates, dpre, dfr = (torch.utils._pytree.tree_map(lambda x: x.to(DEVICE), t)
                                  for t in demo.demo_batch(cfg_d, std_d, SCALEOUT_DEMO_ROWS))
            dfinal, _, _ = pkg.batched_run_sequence(cfg_d, dstates, dpre, dfr, device=DEVICE)
            want = demo.digest(dfinal.imu.p_WI.cpu().numpy())
            check(digests == [want, want], f"scaleout (c) demo: digests {digests}, one process "
                                           f"{want}")
            log(f"scaleout (c): multihost_demo, two processes on the card over gloo, "
                f"{SCALEOUT_DEMO_ROWS} rows each: both ranks' rows bitwise the one-process batched "
                f"run of the same {SCALEOUT_DEMO_ROWS} rows (digest {want})")

            outs = wait_ranks(children[1], deadline)
            check(f"batched VIO: {BATCH} sequences on 2 device(s)" in outs[0],
                  "scaleout (c) runner: rank 0 printed no report on 2 devices")
            ranks = [json.loads(out.split("ERRS ")[-1].splitlines()[0]) for out in outs]
            gap = float(np.abs(np.array(ranks[0]["errs"]) - np.array(one["errs"])).max())
            check(ranks[0]["errs"] == ranks[1]["errs"], "scaleout (c) runner: the ranks' "
                                                        "gathered errors differ")
            check(gap <= SCALEOUT_GAP, f"scaleout (c) runner: rank 0's errors {gap:.3g} m from "
                                       f"the one-process run's")
            log(f"scaleout (c): runner --batch {BATCH} --max_frames {SCALEOUT_TICKS} under the "
                f"torchrun environment contract, two ranks on the card over gloo: rank 0's "
                f"gathered errors within {gap:.3g} m of the one-process runner's (limit "
                f"{SCALEOUT_GAP}); timed runs {ranks[0]['seconds']:.3f} s (the slower rank) "
                f"against {one['seconds']:.3f} s in one process")

            outs = wait_ranks(children[3], deadline)
            for mesh in ("1x2", "2x1"):
                with np.load(tmp / "xfeat" / f"mesh_{mesh}.npz") as d:
                    got = [d[k] for k in ("kpts", "desc", "scores", "valid")]
                want_x = [x.cpu().numpy() for x in ref_x]
                label = f"scaleout (d) mesh {mesh}"
                check(np.array_equal(got[0], want_x[0]) and np.array_equal(got[3], want_x[3]),
                      f"{label}: keypoint slots or validity differ from the unsharded call")
                errs = {n: float(np.abs(g - w).max())
                        for n, g, w in zip(("desc", "scores"), got[1:3], want_x[1:3])}
                check(max(errs.values()) <= XFEAT_SHARD_TOL, f"{label}: {errs}")
                log(f"{label}, two gloo ranks on the card: every keypoint slot and validity "
                    f"equal, descriptors within {errs['desc']:.3g}, scores within "
                    f"{errs['scores']:.3g} of the unsharded call (limit {XFEAT_SHARD_TOL})")
        finally:
            for _, procs in children:
                for p, _ in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()

    log("scaleout (f): wall times on " + card + " (host clock around work that ends in "
        "torch.cuda.synchronize(); the two shards and the two ranks share one card and its host, "
        "so these are no scaling figures): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items()))

    # (f) the same rows again with nothing beside them, over the first
    # SCALEOUT_ALONE_FRAMES frames: one launch; the two shards interleaved
    # from one host thread (sharded_run_sequence); and the two shards each
    # from a host thread of its own, the layout the port does not take
    # (threads share the interpreter lock)
    first = {k: v[:, :SCALEOUT_ALONE_FRAMES] for k, v in std.frames.items()}

    def threaded():
        outs = [None, None]
        threads = [threading.Thread(target=lambda i=i, r=r: outs.__setitem__(
            i, pkg.batched_run_sequence(cfg, states(half, r), rows(std.prefix, r), rows(first, r),
                                        assume_camera=True, device=DEVICE)))
            for i, r in enumerate((slice(0, half), slice(half, BATCH)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        check(all(o is not None for o in outs), "scaleout (f): a shard's thread failed")

    walls.clear()
    timed(f"one launch of {BATCH}", lambda: pkg.batched_run_sequence(
        cfg, states(BATCH), std.prefix, first, assume_camera=True, device=DEVICE))
    timed(f"2 x {half} interleaved, one thread", lambda: sharded_run_sequence(
        cfg, mesh2, assume_camera=True)(states(BATCH), std.prefix, first))
    timed(f"2 x {half}, a thread a shard", threaded)
    log("scaleout (f): alone on " + card + ", " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items()) + f" ({SCALEOUT_ALONE_FRAMES} frames; the "
        f"host issues every launch, so a process drives its cards no faster than one card)")
    log(f"scaleout: the children (the demo, the runner's two ranks and its one-process run, "
        f"sharded XFeat) ran beside "
        f"(a), (b) and (e); the phase took {time.perf_counter() - start:.1f} s")


def profile_window(torch, run, n_frames: int, label: str, unit: str = "frame"):
    """Device busy share and the largest device-time items over one run of
    ``n_frames`` camera frames, or other ``unit``s (torch.profiler, device
    activity only: the host's op events would cost more to record and sort
    than the run; a warm-up run first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        log(f"{label} profile: the profiler recorded no device time; busy share not measured")
        return
    C, u = n_frames, unit
    n_kernels = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.device_time_total)[:8]
    log(f"{label} profile: {C} {u}s, {wall_ms / C:.3f} ms/{u} under the profiler, device "
        f"busy {busy_ms / C:.3f} ms/{u} ({busy_ms / wall_ms * 100:.1f}% busy, "
        f"{100 - busy_ms / wall_ms * 100:.1f}% idle), {n_kernels / C:.0f} device ops/{u} "
        f"(the profile took {time.perf_counter() - start:.1f} s)")
    for e in top:
        log(f"{label} profile:   {e.device_time_total / 1e3 / C:.4f} ms/{u}  "
            f"{e.count / C:.1f}/{u}  {e.key[:90]}")


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
        # registers of every kernel; for the verification, triage, P15 and
        # propagation kernels also the entry each line belongs to, its shared
        # memory and spills
        detail = False
        for line in build_log.read_text().splitlines():
            if line.startswith("=="):
                detail = line.split()[-1] in ("verification.cu", "triage.cu", "p15_recurrence.cu",
                                              "propagate_block.cu")
            if (line.startswith("==") or "registers" in line
                    or (detail and ("Compiling entry" in line or "spill" in line))):
                log("   " + line.strip())

    cfg = pkg.reference_experiment_config()
    start = time.perf_counter()

    def phase(name):
        log(f"== {name} (at {time.perf_counter() - start:.1f} s)")

    kernel_rows = None
    if "kernels" in phases:
        phase("kernels")
        kernel_rows = phase_kernels(torch, K, cfg, np.random.default_rng(0))
        batched_rows = phase_kernels_batched(torch, K, cfg, np.random.default_rng(1))
        K.reset_launches()  # the comparisons above are not the main path's launches
    seq = generate_circle_sequence(rng=np.random.default_rng(0), desc_dim=10)
    if "parity" in phases:
        phase("parity")
        phase_parity(torch, pkg, K, seq, "default")
        phase_parity(torch, pkg, K, seq, "fused", update_kernel="fused")
        phase_parity(torch, pkg, K, seq, "plain triage", use_pallas_triage=False)
        # 2M = 80 and D = 246: shapes past the earlier kernels' card-only limits
        phase_parity(torch, pkg, K, seq, "default, n_cam_slots=41 m_max=40", n_cam_slots=41,
                     m_max=40)
        phase_parity(torch, pkg, K, seq, "fused, n_cam_slots=41 m_max=40", update_kernel="fused",
                     n_cam_slots=41, m_max=40)
        phase_parity_batched(torch, pkg, K)
    # each kernel's launches come from the driven run of its path
    launches = dict.fromkeys(K.LAUNCHES)
    driven = {}
    if "main" in phases:
        check(kernel_rows is not None, "the main phase needs the kernels phase")
        phase("main")
        driven["default"] = phase_main(torch, pkg, K, seq)
        launches.update({k: v for k, v in driven["default"][2].items() if v})
    if "fused" in phases:
        check(kernel_rows is not None, "the fused phase needs the kernels phase")
        phase("fused")
        driven["fused"] = phase_driven(torch, pkg, K, seq, "fused", profile=True,
                                       update_kernel="fused")
        launches["update_terms_fused"] = driven["fused"][2]["update_terms_fused"]
    if "plain" in phases:
        check(kernel_rows is not None, "the plain phase needs the kernels phase")
        phase("plain")
        driven["plain triage"] = phase_driven(torch, pkg, K, seq, "plain triage",
                                              use_pallas_triage=False)
    if driven:
        phase("rates")
        compare_rates(torch, kernel_rows, driven)
    if "xla" in phases:
        phase("xla")
        phase_xla(torch, pkg, K, seq)
    batched_launches = dict.fromkeys(K.LAUNCHES)
    batched_f64 = None
    if "batched" in phases:
        check(kernel_rows is not None, "the batched phase needs the kernels phase")
        phase("batched")
        single = driven["default"][:2] + driven["default"][3:4] if "default" in driven else None
        batched_launches, batched_f64 = phase_batched(torch, pkg, K, seq, single)
    if "solvers" in phases:
        phase("solvers")
        phase_solvers(torch, pkg, K, seq)
    if "images" in phases:
        phase("images")
        phase_images(torch, pkg, K, driven["default"][:2] if "default" in driven else None)
    if "runner" in phases:
        phase("runner")
        phase_runner(torch, pkg, K)
    sources = None
    if "sources" in phases:
        def sources():
            phase("sources")
            phase_sources(torch, pkg, K)
    if "island" in phases:
        # phase sources runs while the island's classic runs go on: they
        # are the island phase's longest part and leave the card idle
        phase("island")
        phase_island(torch, pkg, K, seq, driven, batched_f64, beside=sources)
    elif sources is not None:
        sources()
    if "train" in phases:
        phase("train")
        phase_train(torch)
    if "scaleout" in phases:
        phase("scaleout")
        phase_scaleout(torch, pkg, K)
    log(f"== done (at {time.perf_counter() - start:.1f} s)")

    if kernel_rows is not None:
        src = {
            "batched_gating_gamma": ("gating.cu", 103),
            "verification_scores": ("verification.cu", 626),
            "p15_recurrence_fused": ("p15_recurrence.cu", 951),
            "propagate_block_fused": ("propagate_block.cu", 1020),
            "triage_refresh_fused": ("triage.cu", 771),
            "update_terms_fused": ("update_terms.cu", 303),
        }
        # the batched forms: the JAX custom_vmap rules, and pallas_call's own
        # batching rule for the P15 recurrence
        batched_src = {
            "batched_gating_gamma": 258, "verification_scores": 737,
            "p15_recurrence_fused": 970, "propagate_block_fused": 1197,
            "triage_refresh_fused": 911, "update_terms_fused": 544,
        }

        def entry(name, row, launched, line_no, label):
            extra = {"matmul_ms": row["matmul"]} if row.get("matmul") is not None else {}
            return {
                "name": label,
                "route": "cuda",
                "source": f"msckf_tpu_torch/csrc/{src[name][0]}",
                "replaces": f"msckf_tpu/ops/pallas_kernels.py:{line_no}",
                "launches": launched,
                "max_abs_err": row["err"],
                "ms": row["ms"],
                "plain_ms": row["plain"],
                "bound_ms": row["bound"],
                "bound_by": row["by"],
                "library_ms": row["lib"],
                "dev_ms": row["dev"],
                **extra,
            }

        line = {"kernels": [
            entry(name, row, launches[name], src[name][1], name)
            for name, row in kernel_rows.items()
        ] + [
            entry(name, row, batched_launches[name], batched_src[name],
                  f"{name} (batched, B={row['B']})")
            for name, row in batched_rows.items()
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
