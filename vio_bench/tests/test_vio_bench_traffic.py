"""The benchmark's traffic generator against the frozen NumPy copy of the
port's synthetic source and stream preparation, draw for draw."""

import numpy as np
import torch

from vio_bench.tests.numpy_generator import build_stream, generate_sequence
from vio_bench.traffic.generator import Draws, load_traffic, make_traffic

ROWS, K_MAX, DESC_DIM = 2, 256, 16
# the accelerometer is a second difference of positions over dt = 5 ms: a
# position's float64 rounding (about 4e-16 m) divided by dt^2 is 1.8e-11,
# and the two generators place the parabola's samples by other formulas
ATOL = {"imu_acc": 1e-9}


def _draws(p, T, n_cam, seed=7):
    rng = np.random.default_rng(seed)
    P, Dp = p["world_points"], p["point_desc_dim"]
    return dict(
        point_u=rng.random((ROWS, P, 3)), desc_u=rng.random((ROWS, P, Dp)),
        n_gyro=rng.normal(size=(ROWS, T, 3)), n_acc=rng.normal(size=(ROWS, T, 3)),
        n_bg=rng.normal(size=(ROWS, T, 3)), n_ba=rng.normal(size=(ROWS, T, 3)),
        n_pixel=rng.normal(size=(ROWS, n_cam, P, 2)),
    )


def test_generator_matches_numpy_copy():
    p = dict(load_traffic("mc2048"), laps=1)
    probe = make_traffic(p, 1, None, 0, torch.float64, K_MAX, DESC_DIM, "cpu")
    T = probe.n_ticks
    n_cam = len(range(0, T, p["camera_every"]))
    d = _draws(p, T, n_cam)
    got = make_traffic(p, ROWS, Draws.from_arrays(*(torch.as_tensor(v) for v in d.values())),
                       0, torch.float64, K_MAX, DESC_DIM, "cpu")
    for r in range(ROWS):
        seq = generate_sequence(p, *(v[r] for v in d.values()))
        R_init, prefix, frames = build_stream(np.asarray(p["gravity"]), K_MAX, DESC_DIM, *seq)
        np.testing.assert_allclose(got.R_init[r].numpy(), R_init, rtol=0, atol=1e-13)
        pairs = [(got.prefix, prefix, k) for k in prefix] + [(got.frames, frames, k) for k in frames]
        for ours, theirs, name in pairs:
            have, want = ours[name][r].numpy(), theirs[name]
            assert have.shape == want.shape, name
            if want.dtype == bool:
                np.testing.assert_array_equal(have, want, err_msg=name)
            else:
                np.testing.assert_allclose(have, want, rtol=0, atol=ATOL.get(name, 1e-12),
                                           err_msg=name)
        assert got.frames["kp_valid"][r].sum() == frames["kp_valid"].sum()


def test_seed_fixes_the_draws_and_rows_differ():
    p = dict(load_traffic("mc2048"), laps=1)
    a = make_traffic(p, ROWS, None, 2**31 + 17, torch.float32, K_MAX, DESC_DIM, "cpu")
    b = make_traffic(p, ROWS, None, 2**31 + 17, torch.float32, K_MAX, DESC_DIM, "cpu")
    c = make_traffic(p, ROWS, None, 5, torch.float32, K_MAX, DESC_DIM, "cpu")
    for k, v in a.frames.items():
        assert torch.equal(v, b.frames[k]), k
    assert not torch.equal(a.frames["kp"], c.frames["kp"])
    assert not torch.equal(a.frames["kp"][0], a.frames["kp"][1])
    assert a.frames["kp"].dtype == torch.float32
    n_kp = a.frames["kp_valid"].sum(-1)
    assert int(n_kp.min()) > 0 and int(n_kp.max()) <= 128
