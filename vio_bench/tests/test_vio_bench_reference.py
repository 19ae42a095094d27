"""The plain reference against the program at test capacities, and the
reference's independence of the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vio_bench.compare import compare, flatten, from_program, rows_of
from vio_bench.reference.filter import Reference
from vio_bench.traffic.generator import load_traffic, make_traffic

ROOT = Path(__file__).resolve().parents[2]
ROWS, FRAMES = 2, 30  # 20 prefix ticks and 300 frame ticks a row


def _run_both(config: str):
    from msckf_tpu_torch.config import reference_experiment_config
    from msckf_tpu_torch.filter.msckf import propagate_prefix
    from msckf_tpu_torch.parallel.batched import (
        batched_dispatch, batched_frame_step, batched_initial_state)

    filt = json.loads((ROOT / "vio_bench" / "configs" / f"{config}.json").read_text())["filter"]
    cfg = reference_experiment_config(**filt)
    tr = make_traffic(dict(load_traffic("mc2048"), laps=1), ROWS, None, 31337, cfg.jdtype,
                      cfg.k_max, cfg.desc_dim, "cpu")
    states = batched_initial_state(cfg, ROWS, R_init=tr.R_init.to(cfg.jdtype), device="cpu")
    cd = batched_dispatch(cfg)
    states = torch.func.vmap(lambda s, q: propagate_prefix(cd, s, q)[0])(states, tr.prefix)
    low = cfg.jdtype if cfg.jdtype != torch.float64 else None
    ref = Reference(filt, program_dtype=low)
    refs = []
    for r in range(ROWS):
        st = ref.initial_state(tr.prefix["imu_acc"][r], tr.prefix["pre_init"][r])
        ref.propagate_prefix(st, {k: v[r] for k, v in tr.prefix.items()})
        refs.append(st)
    worst = dict(mismatches=0, state_gap=0.0, cov_gap=0.0, feat_gap=0.0)
    n_tracks = 0
    for j in range(FRAMES):
        states, _ = batched_frame_step(cfg, states, {k: v[:, j] for k, v in tr.frames.items()},
                                       assume_camera=True, device="cpu")
        got = rows_of(flatten(states), list(range(ROWS)))
        for r in range(ROWS):
            ref.frame_step(refs[r], {k: v[r, j] for k, v in tr.frames.items()})
            c = compare(refs[r], from_program(got[r]))
            worst["mismatches"] += c["mismatches"]
            for k in ("state_gap", "cov_gap", "feat_gap"):
                worst[k] = max(worst[k], c[k])
            n_tracks = max(n_tracks, len(refs[r].feats))
    return worst, n_tracks, min(ref.margins.values())


def test_reference_follows_the_program_in_float64():
    """Run side by side from the raw inputs over 320 ticks a row: the same
    tracks, cameras and rejections, and the states to float64 rounding."""
    worst, n_tracks, _ = _run_both("vio_f64")
    assert n_tracks > 50
    assert worst["mismatches"] == 0
    assert worst["state_gap"] < 1e-9
    assert worst["cov_gap"] < 1e-9
    assert worst["feat_gap"] < 1e-8


def test_reference_follows_the_program_in_float32():
    """The float32 program run side by side with the float64 reference
    from the raw inputs: no decision differs, and the states stay within
    float32 rounding grown over the run."""
    worst, _, margin = _run_both("vio_f32_fused")
    assert margin >= 8
    assert worst["mismatches"] == 0
    assert worst["state_gap"] < 1e-4
    assert worst["cov_gap"] < 1e-3


MODULES = ("vio_bench.reference.filter", "vio_bench.compare", "vio_bench.traffic.generator",
           "vio_bench.roofline", "vio_bench.trace")


@pytest.mark.parametrize("module", MODULES)
def test_reference_side_loads_nothing_of_the_program(module):
    code = (f"import sys; import {module}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.split()
    for name in ("jax", "jaxlib", "flax", "msckf_tpu", "msckf_tpu_torch"):
        assert name not in out


def test_covariance_gap_weighs_each_entry_by_its_variances():
    """A gap in a small-variance block reads as large as the same relative
    gap in a large one."""
    from vio_bench.compare import _cov_gap

    P = torch.diag(torch.tensor([1.0, 1e-10], dtype=torch.float64))
    Q = P.clone()
    Q[1, 1] *= 1.01
    assert abs(_cov_gap(P, Q) - 1e-2) < 1e-12
    Q = P.clone()
    Q[0, 0] *= 1.01
    assert abs(_cov_gap(P, Q) - 1e-2) < 1e-12
