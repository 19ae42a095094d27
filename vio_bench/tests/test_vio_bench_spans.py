"""The attribution of kernels, launches and idle gaps to the program's spans
(``vio_bench/spans.py``) on a hand-made Chrome-trace event list, and the
span readers on its result."""

import pytest

from vio_bench.readers import host_issue, memory, span_device
from vio_bench.spans import UNATTRIBUTED, attribute
from vio_bench.trace import TraceSummary, WINDOW_MARK

MAIN, OTHER = 1, 2
MUL = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::"
       "native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor")


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=MAIN):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, corr)


def _kernel(ts, dur, corr, name=None):
    return _x("kernel", name or f"k{corr}", ts, dur, tid=7, corr=corr)


# one step (us): step [0, 100] holds frame [5, 95], which holds update_terms
# [10, 40] with gate [20, 30] inside it; a launch outside every span at 98
EVENTS = [
    _x("user_annotation", WINDOW_MARK, 0, 200),
    _x("user_annotation", "msckf.step", 0, 100),
    _x("user_annotation", "msckf.frame", 5, 90),
    _x("user_annotation", "msckf.update_terms", 10, 30),
    _x("user_annotation", "msckf.gate", 20, 10),
    _x("cpu_op", "aten::mul", 21, 2),
    _launch(12, 1), _kernel(50, 10, 1),  # under update_terms, runs after it closed
    _launch(22, 2),  # under gate
    _kernel(60, 20, 2, "void (anonymous namespace)::gate_kernel<float>"),
    _launch(50, 3), _kernel(80, 5, 3, MUL),  # under frame
    _launch(3, 4), _kernel(96, 3, 4),  # under step alone
    _launch(150, 5), _kernel(150, 20, 5),  # under no span
    # a span on another thread does not hold the main thread's launches
    _x("user_annotation", "msckf.prune", 0, 200, tid=OTHER),
]


@pytest.fixture(scope="module")
def got():
    return attribute(EVENTS, steps=1)


def test_a_kernel_goes_to_the_innermost_span_around_its_launch(got):
    dev = {n: s["device_ms"] for n, s in got["spans"].items()}
    assert dev == pytest.approx({"update_terms": 0.010, "gate": 0.020, "frame": 0.005,
                                 "step": 0.003})
    assert {n: s["launches"] for n, s in got["spans"].items()} == {
        "update_terms": 1, "gate": 1, "frame": 1, "step": 1}
    assert got["kernel_ms"] == pytest.approx(0.058)
    kinds = {n: {k: round(ms, 6) for k, ms in s["kinds"].items()}
             for n, s in got["spans"].items()}
    assert kinds == {"update_terms": {"other": 0.010}, "gate": {"hand-written": 0.020},
                     "frame": {"mul": 0.005}, "step": {"other": 0.003}}


def test_a_gap_goes_to_the_span_open_as_it_began(got):
    # busy [50, 85], [96, 99], [150, 170] in the window [0, 200]: the gaps
    # from 0 and from 99 begin under step, the one from 85 under frame, the
    # one from 170 under no span
    idle = dict(got["idle_by_span"])
    assert idle == pytest.approx({"step": 0.050 + 0.051, "frame": 0.011, UNATTRIBUTED: 0.030})
    assert got["spans"]["frame"]["idle_ms"] == pytest.approx(0.011)
    assert [n for n, _ in got["idle_by_span"]] == ["step", UNATTRIBUTED, "frame"]


def test_kernels_outside_every_span_are_unattributed(got):
    assert got["unattributed_ms"] == pytest.approx(0.020)
    assert UNATTRIBUTED not in got["spans"]


def test_per_step_and_the_readers():
    two = attribute(EVENTS, steps=2)
    assert two["spans"]["gate"]["device_ms"] == pytest.approx(0.010)
    summary = TraceSummary(steps=2, window_s=1.0, busy_s=0.5, kernel_s=0.1, launches=5)
    # a run that recorded no spans gives no value
    for reader, args in ((span_device, {"spans": ["gate"]}), (host_issue, {}), (memory, {})):
        assert reader.read(summary, {}, **args) is None
    summary.spans = two["spans"]
    summary.host_issue_ms = 120.5
    summary.mem_peak_bytes = 2_500_000_000
    assert span_device.read(summary, {}, spans=["update_terms", "gate"]) == pytest.approx(0.015)
    assert span_device.read(summary, {}, spans=["select"]) is None
    assert host_issue.read(summary, {}) == 120.5
    assert memory.read(summary, {}) == 2.5
