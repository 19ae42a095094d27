"""The roofline arithmetic reproduces the bound column of the port's kernel
table at the main path's shapes (float32, one sequence)."""

import pytest

from vio_bench.roofline import call_dims, kernel_bound

CASES = [
    ("batched_gating_gamma", (128, 64), 0.000328, "bytes"),
    ("update_terms_fused", (128, 64, 192), 0.015590, "operations"),
    ("verification_scores", (768, 32), 0.000501, "bytes"),
    ("triage_refresh_fused", (768, 32), 0.000220, "bytes"),
    ("p15_recurrence_fused", (9,), 0.0000057, "bytes"),
    ("propagate_block_fused", (1,), 0.00000091, "bytes"),
]


@pytest.mark.parametrize("name,dims,want_ms,bound", CASES, ids=[c[0] for c in CASES])
def test_bound_column(name, dims, want_ms, bound):
    ms, what = kernel_bound(name, dims, "float32")
    assert what == bound
    assert ms == pytest.approx(want_ms, rel=5e-3)


def test_batch_scales_and_float64_doubles_bytes():
    one, _ = kernel_bound("verification_scores", (192, 32), "float32")
    many, _ = kernel_bound("verification_scores", (192, 32), "float32", B=512)
    f64, _ = kernel_bound("verification_scores", (192, 32), "float64", B=512)
    assert many == pytest.approx(512 * one)
    assert f64 == pytest.approx(2 * many)


def test_call_dims_of_the_cells():
    filt = dict(f_max=192, m_max=32, u_max=32, n_cam_slots=32)
    assert call_dims("verification_scores", filt, 10) == (192, 32)
    assert call_dims("p15_recurrence_fused", filt, 10) == (9,)
    assert call_dims("update_terms_fused", filt, 10) == (32, 64, 192)
