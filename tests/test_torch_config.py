"""The port's MSCKFConfig against the JAX package's: same fields, same
defaults, same derived tables."""

import dataclasses

import numpy as np
import pytest
import torch

import msckf_tpu.config as jcfg
import msckf_tpu_torch.config as tcfg

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.MSCKFConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.MSCKFConfig)]
    assert tf == jf


@pytest.mark.parametrize("overrides", [
    {},
    {"dtype": "float64", "f_max": 512, "u_max": 64, "k_max": 512},
    {"noise_input_rate": 200.0, "m_max": 8, "n_cam_slots": 8, "max_camera_states": 6},
    {"min_frames_to_be_lost": 0, "min_frames_to_be_tracked": 1},
])
def test_reference_experiment_config_matches(overrides):
    j = jcfg.reference_experiment_config(**overrides)
    t = tcfg.reference_experiment_config(**overrides)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.err_dim == j.err_dim
    np.testing.assert_array_equal(t.chi2_table_np, j.chi2_table_np)  # NaN at dof 0 in both
    assert np.isnan(t.chi2_table_np[0])
    np.testing.assert_array_equal(t.noise_cov_diag_np, j.noise_cov_diag_np)
    for name in ("K_np", "K_inv_np", "R_WC_np", "t_WC_np", "gravity_np"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_jdtype_and_presets():
    assert tcfg.MSCKFConfig().jdtype == torch.float32
    assert tcfg.MSCKFConfig(dtype="float64").jdtype == torch.float64
    assert tcfg.NOISE_PRESETS == jcfg.NOISE_PRESETS
