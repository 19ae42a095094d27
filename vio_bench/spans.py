"""Attribution of a profiled step's kernels, launches and idle gaps to the
program's spans.

The program marks its layers with spans (``msckf_tpu_torch/utils/
tracing.py``): with tracing on, each is a ``torch.profiler`` user
annotation ``msckf.<name>`` on the thread that runs it, on the clock of the
kernels. From a profile that records host ops and device activity (the
profiler's Chrome-trace export, as ``vio_bench/trace.py`` reads it):

* each kernel goes to the innermost span that encloses its launch call on
  the launching thread (found by the launch's correlation id), so a span's
  device time is its self time: kernels of a span opened inside it count
  there; a span's ``kinds`` split its device time by the kind of kernel
  (``KINDS``: hand-written, library GEMM and LU, PyTorch's copies, selects,
  products, sums, boolean ops, reductions, indexing, other elementwise);
* each launch call counts for the innermost span enclosing it;
* each idle gap of the device goes to the innermost span open on the main
  thread (the window mark's, or the one with the most spans) when the gap
  began.

Kernels and gaps under no span go to ``UNATTRIBUTED``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from vio_bench.trace import DEVICE_CATS, WINDOW_MARK, _merge

SPAN_PREFIX = "msckf."
UNATTRIBUTED = "(no span)"
# kernel kinds by a substring of the kernel's name, first match wins: the
# program's hand-written kernels, dense and LU library kernels, then
# PyTorch's elementwise kernels by their functor
KINDS = (
    ("hand-written", ("update_track_kernel", "gate_kernel", "update_partial_kernel",
                      "update_project_kernel", "update_s_kernel", "verification",
                      "p15_", "propagate_block", "triage")),
    ("gemm", ("gemm", "nvjet", "gemv", "cutlass")),
    ("lu", ("laswp", "getrf", "getrs", "trsm", "trsv", "lu_", "ipiv")),
    ("copy", ("direct_copy", "copy_kernel")),
    ("where", ("where_kernel",)),
    ("mul", ("MulFunctor",)),
    ("add", ("add<", "AddFunctor")),
    ("boolean", ("Bitwise", "Compare", "logical_", "bool")),
    ("reduce", ("reduce_kernel",)),
    ("index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise",)),
)


def kernel_kind(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


class _Spans:
    """The spans of one host thread, for innermost-enclosing lookups."""

    def __init__(self, intervals):
        self.ivs = sorted(intervals)
        self.starts = [s for s, _, _ in self.ivs]

    def at(self, t: float) -> str:
        # spans on one thread nest, so the enclosing span that started last
        # is the innermost
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            s, e, name = self.ivs[i]
            if e >= t:
                return name
        return UNATTRIBUTED


def attribute(events: list, steps: int) -> dict:
    """``spans``: for each span, device ms, launches, idle ms and device ms
    by kind of kernel (``kinds``) a step;
    ``idle_by_span``: [[span, idle ms a step]], largest first, with the
    gaps under no span; ``kernel_ms``: all kernels' ms a step;
    ``unattributed_ms``: the kernels' ms a step under no span. Over the
    window mark's span where the trace has one, else over the whole
    trace."""
    xs = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in xs if e.get("name") == WINDOW_MARK and e.get("cat") == "user_annotation"]
    if marks:
        w0 = float(marks[0]["ts"])
        w1 = w0 + float(marks[0]["dur"])
    else:
        w0 = w1 = None

    by_tid = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            s = float(e["ts"])
            by_tid[e.get("tid")].append((s, s + float(e.get("dur", 0)),
                                         e["name"][len(SPAN_PREFIX):]))
    threads = {tid: _Spans(ivs) for tid, ivs in by_tid.items()}
    main = marks[0].get("tid") if marks else max(by_tid, key=lambda t: len(by_tid[t]),
                                                  default=None)

    def inside(s, e):
        return w0 is None or (e >= w0 and s <= w1)

    launches = defaultdict(int)
    launch_span = {}
    for e in xs:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or "LaunchKernel" not in e["name"]:
            continue
        ts = float(e["ts"])
        spans = threads.get(e.get("tid"))
        name = spans.at(ts) if spans else UNATTRIBUTED
        if inside(ts, ts):
            launches[name] += 1
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch_span[corr] = name

    device_us = defaultdict(float)
    kinds_us = defaultdict(lambda: defaultdict(float))
    busy = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        d = float(e.get("dur", 0))
        if not inside(s, s + d):
            continue
        busy.append((s if w0 is None else max(s, w0), s + d if w1 is None else min(s + d, w1)))
        if e["cat"] == "kernel":
            name = launch_span.get((e.get("args") or {}).get("correlation"), UNATTRIBUTED)
            device_us[name] += d
            kinds_us[name][kernel_kind(e["name"])] += d

    idle_us = defaultdict(float)
    merged = _merge(busy)
    if merged:
        lo = merged[0][0] if w0 is None else w0
        hi = merged[-1][1] if w1 is None else w1
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        spans = threads.get(main)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                idle_us[spans.at(a) if spans else UNATTRIBUTED] += b - a

    per = 1e3 * max(steps, 1)  # us over the steps -> ms a step
    names = (set(device_us) | set(launches) | set(idle_us)) - {UNATTRIBUTED}
    table = {n: {"device_ms": device_us.get(n, 0.0) / per,
                 "launches": launches.get(n, 0) / max(steps, 1),
                 "idle_ms": idle_us.get(n, 0.0) / per,
                 "kinds": {k: us / per for k, us in sorted(kinds_us[n].items(),
                                                           key=lambda kv: -kv[1])}}
             for n in sorted(names)}
    return {
        "spans": table,
        "idle_by_span": [[n, us / per] for n, us in sorted(idle_us.items(), key=lambda kv: -kv[1])],
        "kernel_ms": sum(device_us.values()) / per,
        "unattributed_ms": device_us.get(UNATTRIBUTED, 0.0) / per,
    }
