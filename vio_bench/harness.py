"""One run of one benchmark cell: set-up, the measured window, the check of
what the window produced against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is found by name: ``BENCHMARK.json`` names the cell's configuration
and traffic; ``vio_bench/configs/<config>.json`` holds the filter settings
and the comparison's limits, ``vio_bench/traffic/<traffic>.json`` the
traffic parameters, ``vio_bench/metrics/<metric>.json`` each per-layer
metric's reader.

The window drives the program's batched camera-frame step,
``msckf_tpu_torch.parallel.batched.batched_frame_step``, over all rows in
lockstep, one step after another with no host sync, for ``--seconds``;
then one ``torch.cuda.synchronize()`` closes it.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path

import torch

from vio_bench.compare import compare, flatten, from_program, rows_of
from vio_bench.reference.filter import Reference, State
from vio_bench.traffic.generator import load_traffic, make_traffic

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "msckf_tpu"}
# steps sampled from the first SAMPLE_SPAN steps of the window, rows
# compared at each, and rows run from the raw inputs through the set-up
SAMPLE_STEPS, SAMPLE_SPAN, STEP_ROWS, START_ROWS = 4, 24, 8, 4
# a decision whose distance from its threshold is under this many times
# its gap between the program's precision and float64 could go either way
# at the program's precision; such a step is set aside
AMBIGUOUS_RATIO = 8.0
TRACED_STEPS = 4
GAPS = ("state_gap", "cov_gap", "feat_gap")


class BenchError(RuntimeError):
    pass


def load_cell(name: str) -> dict:
    """The cell's file ``vio_bench/workloads/<name>.json`` (configuration,
    traffic, chips), which must agree with its entry in BENCHMARK.json, and
    the metrics BENCHMARK.json gives it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if name not in cells or not path.is_file():
        raise BenchError(f"no workload {name!r} in BENCHMARK.json and {path.parent}")
    cell = json.loads(path.read_text())
    for key in ("config", "traffic", "chips"):
        if cell[key] != cells[name][key]:
            raise BenchError(f"workload {name!r}: {key} differs from BENCHMARK.json")
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if name in m.get("workloads", [name])]
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    return cell


def load_config(name: str) -> dict:
    path = BENCH_DIR / "configs" / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def process_start() -> float:
    """The wall-clock time this process started (from /proc), or now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        import os
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


# --------------------------------------------------------------------------
# the program side
# --------------------------------------------------------------------------


class Program:
    """The system under test, loaded from the checkout: the configuration,
    the batched initial state, the prefix and the batched frame step."""

    def __init__(self, filt: dict, device):
        try:
            from msckf_tpu_torch.config import reference_experiment_config
            from msckf_tpu_torch.filter.msckf import propagate_prefix
            from msckf_tpu_torch.parallel import batched
        except ImportError as e:
            raise BenchError(f"the program (msckf_tpu_torch) is not in the checkout: {e}") from e
        self.cfg = reference_experiment_config(**filt)
        self.device = torch.device(device)
        self._batched = batched
        cfg_d = batched.batched_dispatch(self.cfg)
        self._prefix = torch.func.vmap(lambda s, p: propagate_prefix(cfg_d, s, p)[0])

    def start(self, traffic) -> object:
        states = self._batched.batched_initial_state(
            self.cfg, traffic.R_init.shape[0], R_init=traffic.R_init.to(self.cfg.jdtype),
            device=self.device)
        return self._prefix(states, traffic.prefix)

    def step(self, states, frame: dict):
        states, _ = self._batched.batched_frame_step(
            self.cfg, states, frame, dispatch_auto=True, assume_camera=True, device=self.device)
        return states


def broken_step(step, fault: str):
    """The program's step with one of the faults the check must catch."""
    def unchanged(states, frame):
        return states

    def half(states, frame):
        new = step(states, frame)
        B = new.P.shape[0]
        keep = torch.arange(B, device=new.P.device) >= B // 2
        return torch.utils._pytree.tree_map(
            lambda a, b: torch.where(keep.reshape((B,) + (1,) * (a.ndim - 1)), a, b), states, new)

    def alter(states, frame):
        new = step(states, frame)
        return dataclasses.replace(new, imu=dataclasses.replace(
            new.imu, p_WI=new.imu.p_WI + 1e-3))

    def some_rows(states, frame):  # a slip confined to the last quarter of the rows
        new = step(states, frame)
        B = new.P.shape[0]
        hit = (torch.arange(B, device=new.P.device) >= B - B // 4).unsqueeze(1)
        return dataclasses.replace(new, imu=dataclasses.replace(
            new.imu, p_WI=torch.where(hit, new.imu.p_WI + 1e-3, new.imu.p_WI)))

    return {"unchanged": unchanged, "half": half, "alter": alter, "some_rows": some_rows}[fault]


def frame_at(frames: dict, j: int) -> dict:
    return {k: v[:, j] for k, v in frames.items()}


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def cast_state(st: State, dtype, device) -> State:
    def c(x):
        return x.to(device=device, dtype=dtype) if torch.is_tensor(x) and x.is_floating_point() else x

    out = dataclasses.replace(
        st, **{f: c(getattr(st, f)) for f in ("R", "p", "v", "bg", "ba", "ts", "P")})
    out.cams = [{k: c(v) for k, v in cam.items()} for cam in st.cams]
    out.feats = {}
    for fid, f in st.feats.items():
        out.feats[fid] = dataclasses.replace(
            f, **{n: [c(x) for x in getattr(f, n)] for n in ("kps", "descs", "scores", "bases", "dirs")},
            cam_ids=list(f.cam_ids), idp_base=c(f.idp_base), idp_m=c(f.idp_m),
            idp_rho=c(f.idp_rho))
    return out


class Control:
    """The reference in a lower precision, put in the program's place:
    ``"float32"``, or ``"tf32"`` (float32 with TF32 matrix products, on the
    card)."""

    def __init__(self, kind: str, filt: dict):
        dev = "cuda" if kind == "tf32" else "cpu"
        self.kind = kind
        self.ref = Reference(filt, dtype=torch.float32, device=dev)

    def _run(self, fn):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.kind == "tf32"
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def step(self, st: State, frame: dict) -> State:
        def go():
            s = cast_state(st, self.ref.dt, self.ref.dev)
            self.ref.frame_step(s, frame)
            return cast_state(s, torch.float64, "cpu")
        return self._run(go)

    def from_start(self, prefix: dict, frames: list) -> State:
        def go():
            s = self.ref.initial_state(prefix["imu_acc"], prefix["pre_init"])
            self.ref.propagate_prefix(s, prefix)
            for fr in frames:
                self.ref.frame_step(s, fr)
            return cast_state(s, torch.float64, "cpu")
        return self._run(go)


def check_against_reference(filt, program_dtype, samples, starts, control=None, far=None):
    """``samples``: (prev row, next row, frame row) of the window's steps;
    ``starts``: (prefix row, set-up frame rows, row after set-up). Returns
    the numbers compared, how many step samples were set aside, the facts
    that differed, and each compared step sample's gaps. With ``far`` (a
    threshold for each of ``GAPS``), ``far_samples`` counts the compared
    step samples with a gap over its threshold: a fault confined to some
    rows shows in several samples, where float32's rare ill-conditioned
    track shows in one."""
    ref = Reference(filt, program_dtype=program_dtype)
    ctl = Control(control, filt) if control else None
    out = dict(mismatches=0, state_gap=0.0, cov_gap=0.0, feat_gap=0.0,
               start_mismatches=0, start_state_gap=0.0, start_cov_gap=0.0, start_feat_gap=0.0)
    aside = 0
    differ = []
    per_step = {k: [] for k in GAPS}

    def fold(c, prefix=""):
        if c["differ"]:
            differ.append(f"{prefix or 'step '}sample: " + ", ".join(c["differ"][:6]))
        out[prefix + "mismatches"] += c["mismatches"]
        for k in GAPS:
            out[prefix + k] = max(out[prefix + k], c[k])
            if not prefix:
                per_step[k].append(c[k])

    for prev, nxt, frame in samples:
        st = from_program(prev)
        got = ctl.step(st, frame) if ctl else from_program(nxt)
        ref.reset_margins()
        ref.frame_step(st, frame)
        if min(ref.margins.values()) < AMBIGUOUS_RATIO:
            aside += 1
            continue
        fold(compare(st, got))
    for prefix, frames, after in starts:
        ref.reset_margins()
        st = ref.initial_state(prefix["imu_acc"], prefix["pre_init"])
        ref.propagate_prefix(st, prefix)
        for fr in frames:
            ref.frame_step(st, fr)
        if min(ref.margins.values()) < AMBIGUOUS_RATIO:
            continue
        got = ctl.from_start(prefix, frames) if ctl else from_program(after)
        fold(compare(st, got), "start_")
    for k in GAPS:
        out[f"median_{k}"] = statistics.median(per_step[k]) if per_step[k] else math.inf
    if far:
        out["far_samples"] = sum(any(gs[k] > far[k] for k in far)
                                 for gs in (dict(zip(GAPS, t)) for t in zip(*per_step.values())))
    return out, aside, differ, per_step


def batch_faults(states, expected_ticks: int) -> torch.Tensor:
    """Rows (bool, one a row) that are not finite, overflowed a buffer, or
    did not advance by the ticks the window fed them."""
    flat = flatten(states)
    B = states.P.shape[0]
    bad = torch.zeros(B, dtype=torch.bool, device=states.P.device)
    for v in flat.values():
        if v.is_floating_point():
            bad |= ~torch.isfinite(v.reshape(B, -1)).all(1)
    bad |= (flat["diag.n_track_overflow"] + flat["diag.n_update_overflow"]) != 0
    bad |= flat["imu.step_id"] != expected_ticks
    return bad


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             rows=None, laps=None, span=SAMPLE_SPAN, fault=None, control=None,
             t_start=None) -> dict:
    """One run of ``workload``; returns the result dict (the ``checks`` key
    last). ``rows``, ``laps``, ``span``, ``fault`` and ``control`` are for
    the tests and the control runs: fewer rows or laps, sampled steps from
    a shorter stretch, a broken step, or the reference in a lower precision
    in the program's place."""
    t_start = process_start() if t_start is None else t_start
    cell = load_cell(workload)
    conf = load_config(cell["config"])
    filt = conf["filter"]
    limits = conf["limits"]
    p = load_traffic(cell["traffic"])
    if laps is not None:
        p = dict(p, laps=laps)
    rows = p["rows"] if rows is None else rows
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    prog = Program(filt, dev)
    cfg = prog.cfg
    step = broken_step(prog.step, fault) if fault else prog.step
    traffic = make_traffic(p, rows, None, seed, cfg.jdtype, cfg.k_max, cfg.desc_dim, dev)
    frames = traffic.frames
    C = traffic.n_frames
    W = p["warmup_frames"]
    states = prog.start(traffic)
    for j in range(W):
        states = step(states, frame_at(frames, j))
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # device activity alone for the busy share; host ops besides for the
        # op each kernel was launched under (see ``vio_bench/trace.py``)
        dev_acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
        op_acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        for acts in (dev_acts, op_acts):  # the profilers' own start-up, outside the window
            with profile(activities=acts):
                states = step(states, frame_at(frames, W))
            W += 1
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    start_states = states
    setup_s = time.time() - t_start

    # the answers compared: STEP_ROWS rows at each of SAMPLE_STEPS steps drawn
    # from the first ``span`` steps of the window, and START_ROWS rows from
    # the start, all drawn from the seed; a fixed stretch of the stream, so
    # a faster program is judged on the same frames
    rng = random.Random(int(seed))
    sample_steps = sorted(rng.sample(range(W, W + span), min(SAMPLE_STEPS, span)))
    step_rows = {s: rng.sample(range(rows), min(rows, STEP_ROWS)) for s in sample_steps}
    start_rows = rng.sample(range(rows), min(rows, START_ROWS))
    kept = {}

    def advance(states, j):
        new = step(states, frame_at(frames, j))
        if j in step_rows:
            kept[j] = (states, new)  # references only: no work in the window
        return new

    # ---------------- the window
    notes = []
    j = W
    summary = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if trace:
        from vio_bench import trace as tr
        traced = min(TRACED_STEPS, (C - j) // 2)

        def traced_steps(states, j):
            for _ in range(traced):
                states = advance(states, j)
                j += 1
            if on_card:
                torch.cuda.synchronize()
            return states, j

        if on_card:
            torch.cuda.synchronize()
        with profile(activities=dev_acts) as prof:
            t_dev = time.perf_counter()
            states, j = traced_steps(states, j)
            dev_wall = time.perf_counter() - t_dev
        dev_events = tr.export_events(prof)  # before another profiler starts
        with profile(activities=op_acts) as prof:
            with torch.profiler.record_function(tr.WINDOW_MARK):
                states, j = traced_steps(states, j)
        op_events = tr.export_events(prof)
        del prof
    while (time.perf_counter() < deadline or j <= sample_steps[-1]) and j < C:
        states = advance(states, j)
        j += 1
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = j - W
    if j >= C:
        notes.append(f"the stream ran out after {steps} steps: the rate is over {window_s:.3f} s")
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded in the run: {', '.join(found)}")

    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    if trace:
        summary = tr.combine(dev_events, dev_wall, op_events, traced)
        del dev_events, op_events
        notes.append(f"traced {traced} steps: {summary.window_s:.4f} s with {summary.busy_s:.4f} s "
                     f"of device activity, recording it alone; {summary.ops_window_s:.4f} s "
                     f"recording host ops too")

    # ---------------- what the window produced, against the reference
    expected_ticks = int(traffic.prefix["imu_valid"][0].sum() + frames["imu_valid"][0, :j].sum())
    bad_rows = batch_faults(states, expected_ticks)
    n_bad = int(bad_rows.sum())
    samples = []
    for jj, (before, after) in sorted(kept.items()):
        rs = step_rows[jj]
        fr = {k: v[rs, jj].cpu() for k, v in frames.items()}
        for i, (a, b) in enumerate(zip(rows_of(flatten(before), rs), rows_of(flatten(after), rs))):
            samples.append((a, b, {k: v[i] for k, v in fr.items()}))
    after = rows_of(flatten(start_states), start_rows)
    pre = {k: v[start_rows].cpu() for k, v in traffic.prefix.items()}
    fr = {k: v[start_rows, :W].cpu() for k, v in frames.items()}
    starts = [({k: v[i] for k, v in pre.items()},
               [{k: v[i, w] for k, v in fr.items()} for w in range(W)], after[i])
              for i in range(len(start_rows))]
    del states, start_states, kept, traffic, frames
    if on_card:
        torch.cuda.empty_cache()
    low = cfg.jdtype if cfg.jdtype != torch.float64 else None
    t_check = time.perf_counter()
    nums, aside, differ, gaps = check_against_reference(filt, low, samples, starts, control,
                                                        limits.get("far"))
    notes += [f"differs from the reference: {d}" for d in differ[:8]]
    notes += [f"sampled {k}s: " + " ".join(f"{g:.2e}" for g in sorted(v)) for k, v in gaps.items()]
    notes.append(f"the reference took {time.perf_counter() - t_check:.1f} s for "
                 f"{len(samples)} sampled steps and {len(starts)} rows from the start; "
                 f"the window held {steps} steps in {window_s:.3f} s")
    compared = len(samples) - aside

    checks = {
        "rows_bad": (n_bad, 0),
        "compared": (compared, limits["min_compared"]),
        **{k: (nums[k], limits[k]) for k in nums},
    }
    correct = n_bad == 0 and compared >= limits["min_compared"] and all(
        nums[k] <= limits[k] for k in nums)
    if aside:
        notes.append(f"{aside} of {len(samples)} sampled steps set aside: a decision within "
                     f"{AMBIGUOUS_RATIO:g} x its rounding gap of its threshold")

    metrics = {}
    if trace:
        ctx = dict(filter=filt, rows=rows, dtype=filt["dtype"], block_ticks=p["camera_every"])
        for m in cell["per_layer"]:
            spec = json.loads((BENCH_DIR / "metrics" / f"{m['name']}.json").read_text())
            for key in ("unit", "layer", "moves", "source", "better"):
                if spec[key] != m[key]:
                    raise BenchError(f"metric {m['name']}: {key} differs from BENCHMARK.json")
            reader = importlib.import_module(f"vio_bench.readers.{spec['reader']}")
            value = reader.read(summary, ctx, **spec.get("args", {}))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"agg_frames_per_s": rows * steps / window_s, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": rows * steps, "failed": n_bad,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["notes"] = notes
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def emit(result: dict) -> None:
    """The notes, then the numbers compared beside their limits as the last
    lines of standard error; the result as the last line of standard
    output."""
    for n in result.get("notes", []):
        print(f"note: {n}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = {k: v for k, v in result.items() if k != "notes"}
    print(json.dumps(line, allow_nan=True), flush=True)


def cli(argv=None) -> int:
    import argparse

    t_start = process_start()
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"the cell needs {cell['chips']} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except BenchError as e:
        print(f"vio_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"vio_bench: modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
