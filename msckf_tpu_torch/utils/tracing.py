"""The port's spans and counters: what each layer of the frame step costs.

A span marks one layer of the frame step (``with span("triage"):`` or
``@span("triage")``). Tracing is off by default; then ``span`` returns a
no-op context after one global check, with no tensor op, no allocation and
no host sync. ``enable()`` turns it on, and each span then

* opens ``torch.profiler.record_function("msckf.<name>")``, so that under
  any ``torch.profiler`` run the span sits in the trace as a user
  annotation (on the device as ``gpu_user_annotation``), on the clock of
  the kernels launched inside it;
* adds its calls and its host nanoseconds to in-memory counters: inclusive
  time, and self time, which leaves out the time of the spans opened
  inside it.

A span opened under ``torch.func.vmap`` opens once a call, not once a row:
vmap runs the Python body once for the whole batch. A span given
``memory=True`` (the batched step's) also reads the CUDA allocator's peak
(``torch.cuda.max_memory_allocated``, a host-side statistic: no sync, no
reset) as it closes.

The counter registry holds always-on integer counters by group, such as
the kernels' launch counts (``ops/kernels.py``); they count whether or not
tracing is on.

``snapshot()`` hands out everything: ``spans`` (name -> calls, host_ns,
host_self_ns), ``mem_peak_bytes`` (the highest reading; 0 without one) and
``counters`` (group -> name -> count). ``reset()`` clears the spans and the
memory reading.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

PREFIX = "msckf."

_on = False
_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, list[int]] = {}  # name -> [calls, host ns, host self ns]
_mem_peak = 0
_counters: dict[str, dict[str, int]] = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Clear the spans' counts and the memory reading (not the counters)."""
    global _mem_peak
    with _lock:
        _spans.clear()
        _mem_peak = 0


def snapshot() -> dict:
    with _lock:
        return {
            "spans": {n: {"calls": c, "host_ns": t, "host_self_ns": s}
                      for n, (c, t, s) in _spans.items()},
            "mem_peak_bytes": _mem_peak,
            "counters": {g: dict(c) for g, c in _counters.items()},
        }


class _Off:
    """The context a span is while tracing is off; as a decorator it opens
    the span by name at each call, on or off as tracing is then."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped


class _OffSpans(dict):
    def __missing__(self, name):
        made = self[name] = _Off(name)
        return made


_OFF = _OffSpans()


class _On(_Off):
    __slots__ = ("memory", "rf", "t0", "child_ns")

    def __init__(self, name: str, memory: bool):
        super().__init__(name)
        self.memory = memory

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _mem_peak
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += dt
        self.rf.__exit__(*exc)
        mem = (torch.cuda.max_memory_allocated()
               if self.memory and torch.cuda.is_initialized() else 0)
        with _lock:
            row = _spans.get(self.name)
            if row is None:
                row = _spans[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += dt
            row[2] += dt - self.child_ns
            _mem_peak = max(_mem_peak, mem)
        return False


def span(name: str, memory: bool = False):
    """The span ``msckf.<name>``, as a context manager or a decorator; with
    ``memory``, it reads the allocator's peak as it closes."""
    if not _on:
        return _OFF[name]
    return _On(name, memory)


def counter_group(group: str, names) -> dict:
    """The registry's counters of ``group``, made at zero for ``names``: a
    dict whose values ``count`` raises."""
    with _lock:
        return _counters.setdefault(group, dict.fromkeys(names, 0))


def count(group: str, name: str, n: int = 1) -> None:
    # host threads may count at once (parallel/batched.py::shardmap_run_sequence)
    with _lock:
        _counters[group][name] += n


def reset_counters(group: str) -> None:
    with _lock:
        c = _counters[group]
        for k in c:
            c[k] = 0


def counters(group: str) -> dict:
    with _lock:
        return dict(_counters[group])
