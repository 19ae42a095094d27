"""The port's spans and counters (``utils/tracing.py``) on the batched frame
step, on the CPU: off, they leave no trace and change nothing; on, every
layer's span opens once a step under ``torch.func.vmap``, nested inside the
step's, with the calls the code implies.

Two rows of a short synthetic circle in float64 with the default batched
dispatch (hybrid update terms, Newton-Schulz gate) and a window of three
cameras, so each step runs every layer.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import to_device
from msckf_tpu_torch.filter.msckf import propagate_prefix
from msckf_tpu_torch.ops import kernels as K
from msckf_tpu_torch.utils import tracing

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=64, u_max=8, k_max=64, m_max=6, n_cam_slots=6,
            max_camera_states=3, min_parallax_deg=20.0, desc_dim=10)
STEPS = 4
# calls a batched step: the camera update and the prune's each triage,
# build terms (with the gate) and correct; the prune's update and the
# saturation are each a select of both branches
CALLS = {"step": 1, "frame": 1, "propagate": 2, "augment": 1, "match": 1, "verify": 1,
         "tracks": 1, "triage": 2, "update_terms": 2, "gate": 2, "correct": 2,
         "marginalize": 1, "prune": 1, "select": 2}


def _profiled(fn):
    """fn's result, and the (name, start ns, end ns) of the profiler's
    ``msckf.`` events while it ran."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(tracing.PREFIX)]


@pytest.fixture(scope="module")
def runs():
    """The same steps from the same start with tracing off and on: the
    final states, the spans' snapshot, and the profiler's ``msckf.`` events
    of one more step each way."""
    cfg = mt.reference_experiment_config(**CAPS)
    std = to_device(mt.circle_streams(cfg, (0, 1), max_ticks=160, n_world_points=80),
                    cfg, device="cpu")
    states = mt.batched_initial_state(cfg, 2, std.R_init, device="cpu")
    states = torch.func.vmap(
        lambda s, p: propagate_prefix(mt.batched_dispatch(cfg), s, p)[0])(states, std.prefix)
    frames = [{k: v[:, j] for k, v in std.frames.items()} for j in range(STEPS + 1)]

    def run():
        st = states
        for fr in frames[:STEPS]:
            st, _ = mt.batched_frame_step(cfg, st, fr, assume_camera=True, device="cpu")
        return st

    def one_more(st):
        return _profiled(lambda: mt.batched_frame_step(cfg, st, frames[STEPS],
                                                       assume_camera=True, device="cpu"))

    assert not tracing.enabled()
    tracing.reset()
    off = run()
    _, off_events = one_more(off)
    off_snap = tracing.snapshot()
    tracing.enable()
    try:
        on = run()
        snap = tracing.snapshot()
        _, on_events = one_more(on)
    finally:
        tracing.disable()
        tracing.reset()
    return dict(off=off, on=on, off_events=off_events, off_snap=off_snap, snap=snap,
                on_events=on_events)


def test_off_records_nothing(runs):
    assert runs["off_events"] == []
    assert runs["off_snap"]["spans"] == {} and runs["off_snap"]["mem_peak_bytes"] == 0


def test_states_are_bitwise_equal_on_and_off(runs):
    flat_off, _ = torch.utils._pytree.tree_flatten(runs["off"])
    flat_on, _ = torch.utils._pytree.tree_flatten(runs["on"])
    assert len(flat_off) == len(flat_on)
    for a, b in zip(flat_off, flat_on):
        assert torch.equal(a, b)


def test_every_span_opens_as_often_as_the_code_implies(runs):
    spans = runs["snap"]["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {n: STEPS * c for n, c in CALLS.items()}
    for s in spans.values():
        assert 0 <= s["host_self_ns"] <= s["host_ns"]
    # self times add up to the step's inclusive time: each nanosecond once
    assert sum(s["host_self_ns"] for s in spans.values()) == spans["step"]["host_ns"]
    assert runs["snap"]["mem_peak_bytes"] == 0  # no CUDA allocator on the CPU


def test_step_encloses_every_other_span(runs):
    events = runs["on_events"]
    assert {n[len(tracing.PREFIX):] for n, _, _ in events} == set(CALLS)
    ((_, t0, t1),) = [e for e in events if e[0] == tracing.PREFIX + "step"]
    for name, s, e in events:
        assert t0 <= s and e <= t1, name


def test_a_span_opens_once_a_call_under_vmap_and_as_a_decorator():
    @tracing.span("row")
    def row(x):
        with tracing.span("inner"):
            return x * 2

    tracing.enable()
    try:
        torch.func.vmap(row)(torch.ones(5, 3))
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert {n: s["calls"] for n, s in snap["spans"].items()} == {"row": 1, "inner": 1}
    assert tracing.span("row") is tracing.span("row")  # off: a shared no-op


def test_launch_counts_live_in_the_counter_registry():
    K.reset_launches()
    K._count("verification_scores")
    assert K.launch_counts() == tracing.snapshot()["counters"]["launches"]
    assert K.launch_counts()["verification_scores"] == 1 == K.LAUNCHES["verification_scores"]
    K.reset_launches()
    assert set(K.launch_counts().values()) == {0}
