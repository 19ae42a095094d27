"""Import and device rules of the PyTorch port.

* ``import msckf_tpu_torch`` loads neither jax nor flax, and no file of the
  port or chip_smoke.py imports jax, flax or the JAX package;
* entry points run on CUDA unless the caller passes ``device="cpu"``, and
  raise without a GPU instead of carrying on on the CPU: the filter's, the
  batched path's, and the image front-end's and image-in pipeline's;
* the one configuration the port does not take, the compensated
  correction island, raises NotImplementedError; the settings ported with
  the gain solvers, the Gauss-Newton triangulation and the XLA-only forms
  run on the single and the batched path;
* chip_smoke.py refuses to run without a GPU or without the package.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.msckf import frame_step
from msckf_tpu_torch.ops import kernels as K

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "msckf_tpu")


def test_import_leaves_jax_and_flax_out():
    code = (
        "import sys, msckf_tpu_torch, msckf_tpu_torch.filter.msckf, "
        "msckf_tpu_torch.ops.kernels, msckf_tpu_torch.data.stream, "
        "msckf_tpu_torch.parallel.batched, msckf_tpu_torch.pipeline, "
        "msckf_tpu_torch.models.xfeat, msckf_tpu_torch.models.frontend, "
        "msckf_tpu_torch.data.rendered; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msckf_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _port_files():
    files = sorted((REPO / "msckf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def test_no_file_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders


@pytest.fixture(scope="module")
def small():
    cfg = mt.reference_experiment_config(
        dtype="float64", f_max=64, u_max=8, k_max=64, m_max=8, n_cam_slots=8,
        max_camera_states=6, desc_dim=10, use_pallas_triage=False,
    )
    seq = generate_circle_sequence(rng=np.random.default_rng(0), n_world_points=60)
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=60)
    return cfg, st


def test_entry_points_raise_without_gpu(monkeypatch, small):
    cfg, st = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.make_initial_state(cfg, st.R_init)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_device(st, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.init_state(cfg)
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.run_sequence(cfg, state, std.prefix, std.frames)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.state_from_numpy(mt.state_to_numpy(state))
    final, _, _ = mt.run_sequence(cfg, state, std.prefix, std.frames, device="cpu")
    assert final.P.device.type == "cpu"


def test_batched_entry_points_raise_without_gpu(monkeypatch, small):
    cfg, st = small
    std = to_device(st, cfg, device="cpu")
    states = mt.batched_initial_state(cfg, 2, st.R_init, device="cpu")
    prefix = {k: torch.stack([v, v]) for k, v in std.prefix.items()}
    frames = {k: torch.stack([v, v]) for k, v in std.frames.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.batched_initial_state(cfg, 2, st.R_init)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.batched_run_sequence(cfg, states, prefix, frames)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.batched_frame_step(cfg, states, {k: v[:, 0] for k, v in frames.items()})
    final, _, _ = mt.batched_run_sequence(cfg, states, prefix, frames, device="cpu")
    assert final.P.device.type == "cpu" and final.P.shape[0] == 2


def test_image_entry_points_raise_without_gpu(monkeypatch):
    """The front-end's constructors and the image-in pipeline take the
    device rule: the GPU unless device="cpu", raising without one."""
    from msckf_tpu_torch.models.frontend import FeatureExtractor
    from msckf_tpu_torch.models.xfeat import init_params, load_xfeat_npz

    cfg = mt.reference_experiment_config(dtype="float64", f_max=64, u_max=8, k_max=64,
                                         m_max=8, n_cam_slots=8, max_camera_states=6)
    weights = str(REPO / "weights" / "xfeat_selfsup.npz")
    model = load_xfeat_npz(weights, device="cpu")
    state = mt.make_initial_state(cfg, np.eye(3), device="cpu")
    img = torch.as_tensor(np.random.default_rng(0).uniform(0, 255, (64, 64)),
                          dtype=torch.float32)
    ts = torch.tensor([0.005, 0.01], dtype=torch.float64)
    blk = dict(imu_ts=ts, imu_gyro=torch.zeros(2, 3, dtype=torch.float64),
               imu_acc=torch.tensor([[0.0, 0.0, 9.81]] * 2, dtype=torch.float64),
               imu_valid=torch.ones(2, dtype=torch.bool))
    prefix = dict({k: v[:1] for k, v in blk.items()}, pre_init=torch.zeros(1, dtype=torch.bool))
    frames = {k: v[None] for k, v in blk.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_xfeat_npz(weights)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureExtractor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.fused_frame_step(cfg, model, state, img, blk)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.run_sequence_images(cfg, model, state, prefix, frames, img[None])
    final, _ = mt.fused_frame_step(cfg, model, state, img, blk, top_k=32, device="cpu")
    assert final.P.device.type == "cpu"
    final, _, out = mt.run_sequence_images(cfg, model, state, prefix, frames, img[None],
                                           top_k=32, device="cpu")
    assert final.P.device.type == "cpu" and out.p_WI.shape == (1, 2, 3)
    assert FeatureExtractor(model, device="cpu").extract_features(img.numpy())[0].ndim == 2


def _small_variant(small, overrides):
    cfg, st = small
    return mt.reference_experiment_config(**{
        **{f: getattr(cfg, f) for f in ("dtype", "f_max", "u_max", "k_max", "m_max",
                                         "n_cam_slots", "max_camera_states", "desc_dim",
                                         "use_pallas_triage")},
        **overrides,
    })


@pytest.mark.parametrize("overrides", [
    {"gating_solver": "ns", "correction_dtype": "compensated"},
    {"correction_dtype": "compensated"},
])
def test_unported_configurations_raise(small, overrides):
    """The compensated correction island is the one setting left unported."""
    bad = _small_variant(small, overrides)
    st = small[1]
    std = to_device(st, bad, device="cpu")
    state = mt.make_initial_state(bad, st.R_init, device="cpu")
    frame = {k: v[0] for k, v in std.frames.items()}
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        frame_step(bad, state, frame, assume_camera=True)


@pytest.mark.parametrize("overrides", [
    {"gain_solver": "ns"},
    {"triangulation": "gn", "use_pallas_triage": True},
    {"gain_solver": "chol"},
    {"triangulation": "gn"},
    {"prune_path": "masked", "gain_solver": "ns"},
    {"use_pallas": False},
])
def test_gain_solver_gn_and_xla_settings_run_single_and_batched(small, overrides):
    """Settings that raised before the gain solvers, the Gauss-Newton
    triangulation and the XLA-only forms were ported: the single loop over
    the small stream, and the batched loop over two copies of it, which
    equals it (without the dispatch, so both run the same configuration).
    With use_pallas=False no kernel wrapper is called, and under gn not the
    triage kernel's."""
    cfg = _small_variant(small, overrides)
    st = small[1]
    std = to_device(st, cfg, device="cpu")
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if not cfg.use_pallas:  # the master switch: no kernel wrapper is called
            for name in K.LAUNCHES:
                mp.setattr(K, name, None)
        elif cfg.triangulation == "gn":
            mp.setattr(K, "triage_refresh_fused", None)
        single, _, out = mt.run_sequence(cfg, state, std.prefix, std.frames,
                                         assume_camera=True, device="cpu")
        states = mt.batched_initial_state(cfg, 2, st.R_init, device="cpu")
        batched, _, bout = mt.batched_run_sequence(
            cfg, states, {k: torch.stack([v, v]) for k, v in std.prefix.items()},
            {k: torch.stack([v, v]) for k, v in std.frames.items()}, dispatch_auto=False,
            assume_camera=True, device="cpu")
    assert torch.isfinite(single.P).all() and int(single.tracks.valid.sum()) > 0
    for b in range(2):
        np.testing.assert_allclose(batched.P[b].numpy(), single.P.numpy(), atol=1e-12)
        np.testing.assert_allclose(batched.imu.p_WI[b].numpy(), single.imu.p_WI.numpy(),
                                   atol=1e-12)
        np.testing.assert_array_equal(bout.n_tracks[b].numpy(), out.n_tracks.numpy())


def test_chip_smoke_refuses_without_gpu_or_package(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result line,
    both from the repository and alone in an empty directory."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
