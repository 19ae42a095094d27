"""The port's visualization helpers (``msckf_tpu_torch/utils/viz.py``)
against the JAX package's, mirroring tests/test_viz.py.

* The matplotlib canvases draw and save, as the JAX package's do.
* rerun-sdk is not installed here: ``HAVE_RERUN`` is False in both
  packages, and ``stream_to_rerun`` and a ``LiveRerunStream`` without a sink
  raise ``ImportError``.
* ``LiveRerunStream`` with a recording sink, fed the numpy TickOutputs of a
  port run streamed in 2-frame chunks (the prefix block and each chunk, as
  ``run_sequence_streamed`` hands them to ``on_prefix`` and ``on_chunk``),
  makes the same calls with the same payloads as the JAX package's, one
  record a valid tick, the run's positions and counts in them.
* ``_rot_angles`` is the JAX package's on both of its branches.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from msckf_tpu.utils import viz as jviz

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.streamed import run_sequence_streamed
from msckf_tpu_torch.utils import viz as tviz

from tests.torch_fixtures import RecordingSink
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_camera_canvas(tmp_path):
    c = tviz.CameraImageCanvas()
    c.add_points(np.array([[100.0, 100.0], [300.0, 200.0]]), labels=[1, 2])
    c.add_covariance_ellipse(np.array([320.0, 240.0]), np.array([[40.0, 10.0], [10.0, 20.0]]))
    out = tmp_path / "cam.png"
    c.save(str(out))
    assert out.stat().st_size > 0


def test_canvas3d(tmp_path):
    c = tviz.Canvas3D(x_range=[-5, 5], y_range=[-5, 5], z_range=[0, 5])
    c.add_points(np.random.default_rng(0).normal(size=(50, 3)))
    R = Rotation.from_euler("xyz", [0.1, 0.2, 0.3]).as_matrix()
    c.add_pose(R, np.zeros(3))
    K = np.array([[180.0, 0, 320], [0, 180, 240], [0, 0, 1]])
    c.add_camera_frustum(R, np.array([1.0, 0, 1.0]), K, 640, 480)
    out = tmp_path / "world.png"
    c.save(str(out))
    assert out.stat().st_size > 0


def test_rerun_gated():
    assert tviz.HAVE_RERUN is jviz.HAVE_RERUN is False
    with pytest.raises(ImportError, match="rerun-sdk"):
        tviz.stream_to_rerun(np.zeros((2, 3)), np.tile(np.eye(3), (2, 1, 1)),
                             np.zeros((2, 3)), None)
    with pytest.raises(ImportError, match="rerun-sdk"):
        tviz.LiveRerunStream(np.eye(3)[None], np.zeros((1, 3)))


@pytest.fixture(scope="module")
def streamed():
    """(the circle's ground truth, the TickOutputs a streamed port run hands
    to its callbacks, the run's outputs)."""
    cfg = mt.reference_experiment_config(
        dtype="float64", f_max=64, u_max=8, k_max=64, m_max=8, n_cam_slots=8,
        max_camera_states=6, desc_dim=10, use_pallas_triage=False)
    seq = generate_circle_sequence(rng=np.random.default_rng(0), n_world_points=60)
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=60)
    pieces = []
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    _, pre, fr = run_sequence_streamed(cfg, state, st.prefix, st.frames, chunk_frames=2,
                                       device="cpu", on_prefix=pieces.append,
                                       on_chunk=lambda start, out: pieces.append(out))
    return seq, pieces, (pre, fr)


def _same_payload(a, b):
    assert type(a) is type(b) and a[0] == b[0]
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_live_stream_matches_jax(streamed):
    seq, pieces, (pre, fr) = streamed
    assert len(pieces) == 1 + -(-fr.valid.shape[0] // 2)
    port, jax_ = RecordingSink(), RecordingSink()
    tl = tviz.LiveRerunStream(seq.poses_R, seq.poses_t, sink=port)
    jl = jviz.LiveRerunStream(seq.poses_R, seq.poses_t, sink=jax_)
    for piece in pieces:
        tl.consume(piece)
        jl.consume(piece)
    assert len(port.calls) == len(jax_.calls) > 0
    for a, b in zip(port.calls, jax_.calls):
        assert a[:2] == b[:2]
        if a[0] == "set_time":
            assert a[2] == b[2]
        else:
            _same_payload(a[2], b[2])
    valid = np.concatenate([pre.valid, fr.valid.reshape(-1)])
    n = int(valid.sum())
    assert tl.tick == jl.tick == n
    logs = [c for c in port.calls if c[0] == "log"]
    assert len(logs) == 21 * n
    est = [c[2][1] for c in logs if c[1] == "world/estimated_trajectory"][-1]
    p = np.concatenate([pre.p_WI, fr.p_WI.reshape(-1, 3)])[valid]
    np.testing.assert_array_equal(est, p)
    counts = [c[2][1] for c in logs if c[1] == "msckf/features"]
    assert counts == np.concatenate([pre.n_tracks, fr.n_tracks.reshape(-1)])[valid].tolist()


def test_rot_angles_match_jax():
    rng = np.random.default_rng(4)
    Rs = list(Rotation.random(20, random_state=5).as_matrix())
    # the gimbal branch: pitch at +-90 degrees
    Rs += [Rotation.from_euler("xyz", [a, s * np.pi / 2, 0.0]).as_matrix()
           for a, s in zip(rng.uniform(-1, 1, 4), (1, -1, 1, -1))]
    for R in Rs:
        np.testing.assert_array_equal(tviz._rot_angles(R), jviz._rot_angles(R))
