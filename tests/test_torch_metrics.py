"""The port's trajectory metrics, consistency statistics and classic
generator against the JAX package's.

``compute_metrics``, ``results_report``, ``rotation_angle``, ``euler_xyz``,
``nees_series``, ``nees_bounds`` and ``consistency_report`` on seeded
trajectories (rtol 1e-12, report strings equal), and the classic preset of
``data/synthetic.py`` bit for bit.
"""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from msckf_tpu.data import synthetic as jsyn
from msckf_tpu.utils import consistency as jcons
from msckf_tpu.utils import metrics as jmet

from msckf_tpu_torch.data import synthetic as tsyn
from msckf_tpu_torch.utils import consistency as tcons
from msckf_tpu_torch.utils import metrics as tmet

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-12


@pytest.fixture(scope="module")
def traj():
    """A seeded ground truth, an estimate drifting from it, and variances
    that are zero over the first ticks (before initialization)."""
    rng = np.random.default_rng(7)
    T = 300
    gt_R = Rotation.from_rotvec(np.cumsum(rng.normal(size=(T, 3)) * 0.02, axis=0)).as_matrix()
    gt_t = np.cumsum(rng.normal(size=(T, 3)) * 0.05, axis=0)
    gt_t[:5] = 0.0  # standing still: zero relative motion
    dR = Rotation.from_rotvec(rng.normal(size=(T, 3)) * 0.01).as_matrix()
    est_R = np.einsum("tij,tjk->tik", gt_R, dR)
    est_t = gt_t + np.cumsum(rng.normal(size=(T, 3)) * 0.003, axis=0)
    est_t[40] += 3.0  # a spike for the smoothing
    sig_rot = rng.uniform(1e-6, 1e-3, (T, 3))
    sig_pos = rng.uniform(1e-5, 1e-2, (T, 3))
    sig_rot[:10] = 0.0
    sig_pos[:10] = 0.0
    return gt_R, gt_t, est_R, est_t, sig_rot, sig_pos


def test_rotation_angle_and_euler(traj):
    gt_R, _, est_R, *_ = traj
    for R in (gt_R, est_R, np.einsum("tji,tjk->tik", gt_R, est_R)):
        np.testing.assert_allclose(tmet.rotation_angle(R), jmet.rotation_angle(R), rtol=RTOL)
        np.testing.assert_allclose(tmet.euler_xyz(R), jmet.euler_xyz(R), rtol=RTOL, atol=1e-15)
    # scipy's intrinsic "XYZ" is the convention both follow
    np.testing.assert_allclose(tmet.euler_xyz(gt_R[50:60]),
                               Rotation.from_matrix(gt_R[50:60]).as_euler("XYZ"), atol=1e-12)


def test_compute_metrics_and_report(traj):
    mt_ = tmet.compute_metrics(*traj)
    mj = jmet.compute_metrics(*traj)
    for f in dataclasses.fields(mj):
        a, b = getattr(mt_, f.name), getattr(mj, f.name)
        if isinstance(b, float):
            assert a == b, f.name
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-15, err_msg=f.name)
    assert mt_.consistency_fraction() == mj.consistency_fraction()
    assert mj.rte[40] < 10  # the spike was smoothed in both
    prof = {"sequence_s": 1.25, "ticks": 300, "camera_updates_per_s": 24.0}
    assert tmet.results_report(mt_, prof) == jmet.results_report(mj, prof)
    assert tmet.results_report(mt_) == jmet.results_report(mj)


def test_nees_and_consistency_report(traj):
    gt_R, gt_t, est_R, est_t, sig_rot, sig_pos = traj
    live = slice(10, None)
    np.testing.assert_allclose(
        tcons.nees_series(gt_R[live], gt_t[live], est_R[live], est_t[live], sig_rot[live],
                          sig_pos[live]),
        jcons.nees_series(gt_R[live], gt_t[live], est_R[live], est_t[live], sig_rot[live],
                          sig_pos[live]),
        rtol=RTOL)
    for alpha, dof in ((0.05, 6), (0.01, 3)):
        assert tcons.nees_bounds(alpha, dof) == jcons.nees_bounds(alpha, dof)
    rt = tcons.consistency_report(*traj)
    rj = jcons.consistency_report(*traj)
    assert rt.keys() == rj.keys()
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)
    assert 0 < rj["ate_within_3sigma"] < 1


def test_classic_generator_bit_identical():
    """The classic preset (the runner's --sequence classic), with and
    without the preset noise, equal bit for bit to the JAX generator's."""
    assert tsyn.classic_segments() == jsyn.classic_segments()
    for kwargs in ({}, dict(sigma_acc=0.005, sigma_gyro=0.0005, sigma_ba=5e-4, sigma_bg=5e-5)):
        a = tsyn.generate_classic_sequence(rng=np.random.default_rng(42), **kwargs)
        b = jsyn.generate_classic_sequence(rng=np.random.default_rng(42), **kwargs)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, list):
                assert len(x) == len(y) > 100, f.name
                for xi, yi in zip(x, y):
                    np.testing.assert_array_equal(xi, yi, err_msg=f.name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f.name)
