"""The cost of each layer of the program's batched step in one cell, from
the program's spans, from the root of a checkout:

    python3 vio_bench/span_run.py --workload <name> --seed <n> [--rows <r>]

It makes the cell's set-up as ``vio_bench/run.py`` does, then runs the
steps of the window in passes, each over the same number of steps, with
one ``torch.cuda.synchronize()`` after each, in this order:

* untraced steps, tracing off and no profiler (before and after pass C);
* pass C, tracing on (``msckf_tpu_torch.utils.tracing``) and no profiler:
  the program's own host times a span and the allocator's peak;
* pass A, device activity alone recorded, tracing off: the device's idle
  share, device ms and launches a step, as ``--trace 1`` reads them;
* pass B, host ops and device activity recorded, tracing on: every kernel,
  launch and idle gap put down to its span (``vio_bench/spans.py``).

Passes A and B follow one step under each profiler, as ``--trace 1``'s do.

The last line of standard output is JSON: the per-layer metrics of
``vio_bench/metrics/`` that the passes give (the six the benchmark reports
and the nine read from spans), ``breakdown`` (``device_ops`` and
``idle_gaps`` as ``--trace 1`` gives them, ``spans`` with each span's
device ms, launches, host self ms and idle ms a step, ``idle_by_span``),
and the wall ms a step of each pass. It checks no answer: that is
``vio_bench/run.py``'s.
"""

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_CACHE = ROOT / ".vio_bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import importlib  # noqa: E402

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from vio_bench import spans as sp  # noqa: E402
from vio_bench import trace as tr  # noqa: E402
from vio_bench.harness import (  # noqa: E402
    BENCH_DIR, TRACED_STEPS, Program, frame_at, load_cell, load_config,
)
from vio_bench.traffic.generator import load_traffic, make_traffic  # noqa: E402


def run(workload: str, seed: int, rows=None, steps: int = TRACED_STEPS, device="cuda") -> dict:
    from msckf_tpu_torch.utils import tracing

    cell = load_cell(workload)
    filt = load_config(cell["config"])["filter"]
    p = load_traffic(cell["traffic"])
    rows = p["rows"] if rows is None else rows
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    prog = Program(filt, dev)
    traffic = make_traffic(p, rows, None, seed, prog.cfg.jdtype, prog.cfg.k_max,
                           prog.cfg.desc_dim, dev)
    frames = traffic.frames
    W = p["warmup_frames"]
    j = 0
    states = prog.start(traffic)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def go(n):
        nonlocal states, j
        for _ in range(n):
            states = prog.step(states, frame_at(frames, j))
            j += 1

    need = W + 2 + 5 * steps
    if traffic.n_frames < need:
        raise SystemExit(f"the stream holds {traffic.n_frames} steps; the passes need {need}")
    dev_acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    op_acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    go(W)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def timed():
        sync()
        t0 = time.perf_counter()
        go(steps)
        sync()
        return (time.perf_counter() - t0) * 1e3 / steps

    # the passes without a profiler first: in the steps after a profile one
    # step now and then took 340 to 720 ms on the H100's host, which would
    # read as the spans' cost
    wall = {"untraced_first": timed()}
    tracing.reset()
    tracing.enable()
    wall["C"] = timed()
    tracing.disable()
    snap = tracing.snapshot()
    tracing.reset()
    wall["untraced_last"] = timed()
    wall["untraced"] = (wall["untraced_first"] + wall["untraced_last"]) / 2

    with profile(activities=dev_acts):  # the profilers' own start-up
        go(1)
    tracing.enable()
    with profile(activities=op_acts):
        go(1)
    tracing.disable()
    with profile(activities=dev_acts) as prof:
        wall["A"] = timed()
    dev_events = tr.export_events(prof)
    tracing.enable()
    with profile(activities=op_acts) as prof:
        with record_function(tr.WINDOW_MARK):
            wall["B"] = timed()
    tracing.disable()
    op_events = tr.export_events(prof)
    del prof
    mem_peak = max(snap["mem_peak_bytes"], tracing.snapshot()["mem_peak_bytes"])
    tracing.reset()

    summary = tr.combine(dev_events, wall["A"] * steps / 1e3, op_events, steps)
    spans = sp.attribute(op_events, steps)
    host = snap["spans"]
    for name, row in spans["spans"].items():
        if name in host:
            row["host_self_ms"] = host[name]["host_self_ns"] / 1e6 / steps
    summary.spans = spans["spans"]
    summary.host_issue_ms = host["step"]["host_ns"] / 1e6 / host["step"]["calls"]
    summary.mem_peak_bytes = mem_peak

    # the cell's metrics in BENCHMARK.json, and those of vio_bench/metrics/
    # that BENCHMARK.json does not name yet
    named = {m["name"] for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    names = [m["name"] for m in cell["per_layer"]] + sorted(
        f.stem for f in (BENCH_DIR / "metrics").glob("*.json") if f.stem not in named)
    ctx = dict(filter=filt, rows=rows, dtype=filt["dtype"], block_ticks=p["camera_every"])
    metrics = {}
    for name in names:
        spec = json.loads((BENCH_DIR / "metrics" / f"{name}.json").read_text())
        reader = importlib.import_module(f"vio_bench.readers.{spec['reader']}")
        value = reader.read(summary, ctx, **spec.get("args", {}))
        if value is not None:
            metrics[name] = {"value": value, "unit": spec["unit"]}

    return {
        "workload": workload, "seed": seed, "rows": rows, "steps_a_pass": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "metrics": metrics,
        "wall_ms_per_step": wall,
        "kernel_ms_per_step_B": spans["kernel_ms"],
        "unattributed_ms_per_step_B": spans["unattributed_ms"],
        # the kernels' share outside every layer's span: under the step's
        # own span or under none
        "outside_layers_pct_B": 100 * (spans["unattributed_ms"] + spans["spans"].get(
            "step", {}).get("device_ms", 0.0)) / spans["kernel_ms"] if spans["kernel_ms"] else None,
        "breakdown": {**summary.breakdown(), "spans": spans["spans"],
                      "idle_by_span": spans["idle_by_span"]},
    }


def cli(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The per-span cost of one cell's batched step.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--steps", type=int, default=TRACED_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.workload, args.seed, args.rows, args.steps, args.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
