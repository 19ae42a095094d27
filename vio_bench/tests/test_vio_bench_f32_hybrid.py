"""The cell ``vio_f32.mc2048`` (the float32 filter with the hybrid update
terms and the gating kernel, the runner's default batched
configuration): the reference follows the program from the raw inputs, a
sound small run on the CPU is correct, and each broken step and the TF32
control come out not correct."""

import pytest

from vio_bench.tests.test_vio_bench_harness import _run
from vio_bench.tests.test_vio_bench_reference import _run_both

CELL = "vio_f32.mc2048"


def test_reference_follows_the_program_in_float32():
    """The float32 hybrid program side by side with the float64 reference
    from the raw inputs: no decision differs, and the states stay within
    float32 rounding grown over the run."""
    worst, _, margin = _run_both("vio_f32")
    assert margin >= 8
    assert worst["mismatches"] == 0
    assert worst["state_gap"] < 1e-4
    assert worst["cov_gap"] < 1e-3


def test_sound_run_is_correct():
    r = _run(CELL, 2**33 + 7)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "some_rows"])
def test_a_broken_step_is_not_correct(fault):
    r = _run(CELL, 4321, fault=fault)
    assert not r["correct"], r["checks"]
    if fault == "some_rows":
        far = r["checks"]["far_samples"]
        assert far["value"] > far["limit"], r["checks"]


@pytest.mark.card
def test_tf32_control_is_not_correct(card):
    r = _run(CELL, 7, device="cuda", control="tf32", rows=64, laps=1)
    assert not r["correct"], r["checks"]
