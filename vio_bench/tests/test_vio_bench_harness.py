"""A run of a cell, driven on the CPU at a small size: a sound run is
correct and loads no JAX; each fault of the timed path, and the control in
a lower precision, comes out not correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL = dict(rows=36, laps=1, span=4)


def _run(workload, seed, device="cpu", fault=None, control=None, seconds=1.0, **size):
    from vio_bench.harness import run_cell

    return run_cell(workload, seed, seconds, False, device=device, fault=fault,
                    control=control, **(size or SMALL))


def test_sound_run_is_correct_and_loads_no_jax():
    code = (
        "import json, sys\n"
        "from vio_bench.harness import run_cell, forbidden_modules\n"
        "r = run_cell('vio_f32_fused.mc2048', 2**33 + 5, 1.0, False, device='cpu', rows=36, laps=1, span=4)\n"
        "print(json.dumps({'correct': r['correct'], 'found': forbidden_modules(),"
        " 'checks': r['checks']}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["found"] == []
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "some_rows"])
def test_a_broken_step_is_not_correct(fault):
    r = _run("vio_f32_fused.mc2048", 1234, fault=fault)
    assert not r["correct"], r["checks"]
    if fault == "some_rows":  # 1 mm in a quarter of the rows passes the medians and the widest gaps
        far = r["checks"]["far_samples"]
        assert far["value"] > far["limit"], r["checks"]


def test_float32_control_of_the_float64_cell_is_not_correct():
    r = _run("vio_f64.mc1280", 99, control="float32")
    assert not r["correct"], r["checks"]


@pytest.mark.card
def test_tf32_control_of_the_float32_cell_is_not_correct(card):
    r = _run("vio_f32_fused.mc2048", 7, device="cuda", control="tf32", rows=64, laps=1)
    assert not r["correct"], r["checks"]
