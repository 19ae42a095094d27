"""Reduction of ``torch.profiler`` traces of the window's traced steps to
what the per-layer readers take: device busy time, kernels and their
device time (with the program op each was launched under), launches,
and idle gaps labelled by the host op running when the device went idle.

The traced steps run twice under the profiler: once recording device
activity alone (kernels, copies and the runtime's launch calls, through
CUPTI), which leaves the host's pace as it is, for the busy and idle
share, the device time and the launches; once recording host ops too,
which slows the host's issue, for the op each kernel was launched under
and the host op behind each idle gap.

The trace is read from the profiler's Chrome-trace export, whose event
categories (``kernel``, ``gpu_memcpy``, ``gpu_memset``, ``cuda_runtime``,
``cuda_driver``, ``cpu_op``, ``user_annotation``) carry the timeline.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_MARK = "vio_bench.traced_steps"
OP_PREFIX = "msckf::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Kernel:
    name: str
    dur: float  # us
    op: str | None  # the program op it was launched under
    op_call: int | None  # which call of that op


@dataclass
class TraceSummary:
    steps: int
    window_s: float
    busy_s: float
    kernel_s: float
    launches: int
    kernels: list = field(default_factory=list)
    gaps: dict = field(default_factory=dict)  # host label -> idle seconds
    ops_window_s: float = 0.0  # the steps' wall time with host ops recorded

    def op_calls(self, op: str):
        """(device seconds, calls) of the kernels launched under ``op``."""
        ks = [k for k in self.kernels if k.op == op]
        return sum(k.dur for k in ks) / 1e6, len({k.op_call for k in ks})

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for k in self.kernels:
            by_name[k.name[:160]] += k.dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def export_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def combine(device_events: list, device_wall_s: float, op_events: list, steps: int
            ) -> TraceSummary:
    """The busy share, device time and launches from the device-only trace
    of ``steps`` steps that took ``device_wall_s`` by the host's clock (from
    the first launch to a sync after the last); kernels by op and the idle
    gaps' labels from the trace with host ops."""
    dev = summarize(device_events, steps, wall_s=device_wall_s)
    ops = summarize(op_events, steps)
    return dataclasses.replace(dev, launches=dev.launches or ops.launches, kernels=ops.kernels,
                               gaps=ops.gaps, ops_window_s=ops.window_s)


def summarize(events: list, steps: int, wall_s: float | None = None) -> TraceSummary:
    """The trace's steps lie within the window mark's span, or, given
    ``wall_s``, the whole trace is the steps and ``wall_s`` their time."""
    xs = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in xs if e.get("name") == WINDOW_MARK and e.get("cat") == "user_annotation"]
    if wall_s is not None:
        w0, w1 = -math.inf, math.inf
    elif marks:
        w0 = float(marks[0]["ts"])
        w1 = w0 + float(marks[0]["dur"])
    else:
        raise RuntimeError("the trace holds no window mark")

    # program ops by host thread, for the launch -> op attribution
    ops = defaultdict(list)
    cpu = defaultdict(list)
    for e in xs:
        if e.get("cat") == "cpu_op":
            iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
            cpu[e.get("tid")].append(iv)
            if e["name"].startswith(OP_PREFIX):
                ops[e.get("tid")].append(iv)
    op_index = {}
    for tid, ivs in ops.items():
        ivs.sort()
        op_index[tid] = ([s for s, _, _ in ivs], ivs)
    launch_op = {}
    launches = 0
    for e in xs:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or "LaunchKernel" not in e["name"]:
            continue
        ts = float(e["ts"])
        if w0 <= ts <= w1:
            launches += 1
        corr = (e.get("args") or {}).get("correlation")
        idx = op_index.get(e.get("tid"))
        if corr is None or idx is None:
            continue
        starts, ivs = idx
        # the outermost program op call that encloses the launch (the
        # program makes a few such calls a step, so the walk is short)
        best = None
        for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            s, end, name = ivs[i]
            if s <= ts <= end:
                best = (name, i)
        if best is not None:
            launch_op[corr] = (best[0][len(OP_PREFIX):], best[1])

    kernels, busy = [], []
    kernel_us = 0.0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        d = float(e.get("dur", 0))
        if s + d < w0 or s > w1:
            continue
        busy.append((max(s, w0), min(s + d, w1)))
        if e["cat"] == "kernel":
            kernel_us += d
            op, call = launch_op.get((e.get("args") or {}).get("correlation"), (None, None))
            kernels.append(Kernel(e["name"], d, op, call))
    merged = _merge(busy)
    busy_us = sum(e - s for s, e in merged)

    # idle gaps, labelled by the innermost host op running as each began
    main_tid = max(cpu, key=lambda t: len(cpu[t])) if cpu else None
    host = sorted(cpu.get(main_tid, []))
    host_starts = [s for s, _, _ in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1] if wall_s is None else []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = "python, between ops"
        i = bisect.bisect_right(host_starts, a) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        gaps[label] += (b - a) / 1e6
    window_s = (w1 - w0) / 1e6 if wall_s is None else wall_s
    return TraceSummary(steps=steps, window_s=window_s, busy_s=busy_us / 1e6,
                        kernel_s=kernel_us / 1e6, launches=launches, kernels=kernels,
                        gaps=dict(gaps))
