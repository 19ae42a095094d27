"""Import and device rules of the PyTorch port.

* ``import msckf_tpu_torch`` loads neither jax nor flax (nor, with the
  trainer's modules, optax), and no file of the
  port or chip_smoke.py imports jax, flax or the JAX package; the runner
  and its modules load none of jax, the JAX package, pandas or OpenCV, and
  ``python -m msckf_tpu_torch.runner --help`` runs without them; the
  package and each module of the dataset-sources slice load none of jax,
  flax, pandas, OpenCV, matplotlib or rerun;
* entry points run on CUDA unless the caller passes ``device="cpu"``, and
  raise without a GPU instead of carrying on on the CPU: the filter's, the
  batched path's, the image front-end's and image-in pipeline's, the
  streamed runs', the checkpoint loaders', the runner's, the XFeat
  trainer's and the scale-out's (the meshes, the multi-process run);
* the compensated correction island, the last configuration ported, runs
  one frame of a float32 filter as the JAX package's does; any
  ``prune_path`` but "masked" is the "cond" prune, as in the JAX package;
  the settings
  ported with the gain solvers, the Gauss-Newton triangulation and the
  XLA-only forms run on the single and the batched path;
* chip_smoke.py refuses to run without a GPU or without the package.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import msckf_tpu as jx
from msckf_tpu.data.stream import build_stream as jax_build_stream
from msckf_tpu.data.stream import to_device as jax_to_device
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle
from msckf_tpu.filter.msckf import frame_step as jax_frame_step

import msckf_tpu_torch as mt
import msckf_tpu_torch.filter.update as port_update
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.filter.msckf import frame_step
from msckf_tpu_torch.ops import kernels as K

from tests.test_torch_modules import jax_state_from_numpy, jax_state_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "msckf_tpu")


PACKAGE_MODULES = (
    "msckf_tpu_torch", "msckf_tpu_torch.filter.msckf", "msckf_tpu_torch.ops.kernels",
    "msckf_tpu_torch.data.stream", "msckf_tpu_torch.parallel.batched",
    "msckf_tpu_torch.pipeline", "msckf_tpu_torch.models.xfeat",
    "msckf_tpu_torch.models.frontend", "msckf_tpu_torch.data.rendered",
    "msckf_tpu_torch.models.selfsup", "msckf_tpu_torch.models.train_xfeat",
    "msckf_tpu_torch.models.frontend_eval", "msckf_tpu_torch.parallel.multihost",
    "msckf_tpu_torch.parallel.multihost_demo", "msckf_tpu_torch.parallel.xfeat_sharded",
)
SOURCES_MODULES = ("msckf_tpu_torch", "msckf_tpu_torch.data.imageio",
                   "msckf_tpu_torch.data.native_io", "msckf_tpu_torch.data.photorealistic",
                   "msckf_tpu_torch.utils.viz", "msckf_tpu_torch.ops.camera",
                   "msckf_tpu_torch.ops.geometry", "msckf_tpu_torch.filter.propagation",
                   "msckf_tpu_torch.runner")
RUNNER_MODULES = ("msckf_tpu_torch.runner", "msckf_tpu_torch.filter.streamed",
                  "msckf_tpu_torch.utils.checkpoint", "msckf_tpu_torch.utils.metrics",
                  "msckf_tpu_torch.utils.consistency", "msckf_tpu_torch.data.parser")
# one fresh interpreter imports the three lists in turn and reports, after
# each import, the packages of the checked kinds then loaded: no list may
# load a package that a list before it may load (none of them loads pandas,
# OpenCV, matplotlib, rerun, jax, flax, optax or the JAX package)
_STAGES = (("sources", SOURCES_MODULES), ("package", PACKAGE_MODULES),
           ("runner", RUNNER_MODULES))
_WATCHED = ("jax", "flax", "optax", "msckf_tpu", "pandas", "cv2", "matplotlib", "rerun")


@pytest.fixture(scope="module")
def fresh_imports():
    code = (
        "import sys, importlib, json\n"
        "seen = {}\n"
        f"for stage, mods in {_STAGES!r}:\n"
        "    for m in mods:\n"
        "        importlib.import_module(m)\n"
        "        seen.setdefault(stage, {})[m] = sorted(\n"
        "            {n.split('.')[0] for n in sys.modules} & "
        f"set({_WATCHED!r}))\n"
        "print(json.dumps(seen))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_import_leaves_jax_and_flax_out(fresh_imports):
    bad = {m: set(v) & {"jax", "flax", "optax", "msckf_tpu"}
           for m, v in fresh_imports["package"].items()}
    assert list(fresh_imports["package"]) == list(PACKAGE_MODULES)
    assert not any(bad.values()), bad


def test_sources_modules_load_no_optional_package(fresh_imports):
    """In a fresh interpreter, the package, then each module of the
    dataset-sources slice: after each import, none of the packages the
    card's machine lacks (pandas, OpenCV, matplotlib, rerun) is loaded, nor
    jax or flax."""
    forbidden = {"jax", "flax", "msckf_tpu", "pandas", "cv2", "matplotlib", "rerun"}
    bad = {m: set(v) & forbidden for m, v in fresh_imports["sources"].items()}
    assert list(fresh_imports["sources"]) == list(SOURCES_MODULES)
    assert not any(bad.values()), bad


# an import hook that makes these packages missing, as on the machine with
# the GPU (no pandas, no OpenCV) and for the port in general (no JAX)
_BLOCK = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'msckf_tpu', 'pandas', 'cv2'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n"
)


def test_runner_modules_import_without_jax_pandas_or_cv2(fresh_imports):
    bad = {m: set(v) & {"jax", "flax", "msckf_tpu", "pandas", "cv2"}
           for m, v in fresh_imports["runner"].items()}
    assert list(fresh_imports["runner"]) == list(RUNNER_MODULES)
    assert not any(bad.values()), bad
    # and with those packages made unimportable, --help runs
    code = _BLOCK + (
        "import runpy\n"
        "sys.argv = ['msckf_tpu_torch.runner', '--help']\n"
        "runpy.run_module('msckf_tpu_torch.runner', run_name='__main__')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "--stream_chunk" in out.stdout and "--device" in out.stdout


def test_streamed_checkpoint_and_runner_raise_without_gpu(monkeypatch, small, tmp_path):
    from msckf_tpu_torch import runner
    from msckf_tpu_torch.filter.streamed import run_batched_streamed, run_sequence_streamed
    from msckf_tpu_torch.utils.checkpoint import load_state, save_state

    cfg, st = small
    state = mt.make_initial_state(cfg, st.R_init, device="cpu")
    states = mt.batched_initial_state(cfg, 2, st.R_init, device="cpu")
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    prefix = {k: np.stack([v, v]) for k, v in st.prefix.items()}
    frames = {k: np.stack([v, v]) for k, v in st.frames.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sequence_streamed(cfg, state, st.prefix, st.frames)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_batched_streamed(cfg, states, prefix, frames)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state(path, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(["--max_frames", "60", "--data_root", str(tmp_path)])
    assert load_state(path, cfg, device="cpu").P.device.type == "cpu"
    final, _, out = run_sequence_streamed(cfg, state, st.prefix, st.frames, chunk_frames=2,
                                          device="cpu")
    assert final.P.device.type == "cpu" and isinstance(out.p_WI, np.ndarray)


def _port_files():
    files = sorted((REPO / "msckf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                                 REPO / "tests" / "torch_fixtures.py"]
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


def test_trainer_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """The trainer takes the device rule too: train and its CLI raise
    without a GPU unless asked for the CPU, before any pool is generated."""
    from msckf_tpu_torch.models import train_xfeat

    def no_pool(*args, **kwargs):
        raise AssertionError("the pool was generated before the device was checked")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(train_xfeat, "PairPool", no_pool)
    out = str(tmp_path / "w.npz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_xfeat.train(steps=1, batch=1, size=32, pool_pairs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_xfeat.main(["--steps", "1", "--size", "32", "--batch", "1", "--pool", "1",
                          "--out", out])
    assert not (tmp_path / "w.npz").exists()


def test_scaleout_entry_points_raise_without_gpu(monkeypatch, small, tmp_path):
    """The meshes, the multi-process run and the DCP loader take the device
    rule: the GPU unless asked for the CPU, raising without one."""
    from msckf_tpu_torch.parallel import multihost as mh
    from msckf_tpu_torch.parallel.batched import data_mesh
    from msckf_tpu_torch.parallel.xfeat_sharded import xfeat_mesh
    from msckf_tpu_torch.utils.checkpoint import load_state_dcp, save_state_dcp

    cfg, st = small
    path = str(tmp_path / "dcp")
    save_state_dcp(path, mt.init_state(cfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (data_mesh, lambda: data_mesh(devices=["cuda:0", "cuda:0"]),
                 mh.global_data_mesh, lambda: xfeat_mesh(1, 1),
                 lambda: mh.init_distributed("127.0.0.1:1", 1, 0),
                 lambda: load_state_dcp(path, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert data_mesh(devices=["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2
    mesh = mh.global_data_mesh(device="cpu")
    assert xfeat_mesh(1, 1, device="cpu").mesh_dim_names == ("data", "model")
    assert mh.rank_device(mesh).type == "cpu"
    assert load_state_dcp(path, cfg, device="cpu").P.device.type == "cpu"


SMALL_FIELDS = ("dtype", "f_max", "u_max", "k_max", "m_max", "n_cam_slots",
                "max_camera_states", "desc_dim", "use_pallas_triage")


# the circle at the small capacities first updates in frame 5 (0-based)
UPDATE_TICKS, UPDATE_FRAME = 80, 5


def _small_variant(small, overrides, config=mt.reference_experiment_config):
    cfg, st = small
    return config(**{**{f: getattr(cfg, f) for f in SMALL_FIELDS}, **overrides})


@pytest.mark.parametrize("overrides", [
    {"gating_solver": "ns", "correction_dtype": "compensated"},
    {"correction_dtype": "compensated"},
])
def test_compensated_configurations_run(small, overrides, monkeypatch):
    """The compensated correction island runs: a float32 filter at the small capacities over the circle's first
    UPDATE_FRAME frames on the port's CPU lane, then the next frame, the
    first with a real update (A is not zero), from that state in both
    packages. The counts and masks are equal, and the state is the JAX
    package's within float32 round-off: 1e-4 of each field's scale (at
    least 1e-6). The float32 line-intersection triage sets that: the
    inverse depths differ by 5e-5 of theirs, the island's P by 4e-7."""
    overrides = {**overrides, "dtype": "float32"}
    cfg = _small_variant(small, overrides)
    seq = generate_circle_sequence(rng=np.random.default_rng(0), n_world_points=60)
    std = to_device(build_stream(
        cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
        seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=UPDATE_TICKS),
        cfg, device="cpu")
    C = UPDATE_FRAME
    state = mt.make_initial_state(cfg, std.R_init, device="cpu")
    state, _ = mt.propagate_prefix(cfg, state, std.prefix)
    state, _ = mt.run_filter(cfg, state, {k: v[:C] for k, v in std.frames.items()},
                             assume_camera=True)
    start = mt.state_to_numpy(state)

    updates = []
    island = port_update._correction_terms_compensated
    monkeypatch.setattr(port_update, "_correction_terms_compensated",
                        lambda c, P, A, cc: (updates.append(bool(torch.any(A != 0))),
                                             island(c, P, A, cc))[1])
    got, _ = frame_step(cfg, state, {k: v[C] for k, v in std.frames.items()},
                        assume_camera=True)
    assert updates == [True]

    jcfg = _small_variant(small, overrides, jx.reference_experiment_config)
    seq = jax_circle(rng=np.random.default_rng(0), n_world_points=60)
    jst = jax_to_device(jax_build_stream(
        jcfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
        seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores, max_ticks=UPDATE_TICKS), jcfg)
    want, _ = jax.jit(lambda s, f: jax_frame_step(jcfg, s, f, assume_camera=True))(
        jax_state_from_numpy(jcfg, start), {k: v[C] for k, v in jst.frames.items()})
    got, want = mt.state_to_numpy(got), jax_state_to_numpy(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, rtol=0,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-6), err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_prune_path_other_is_cond(small):
    """A prune_path other than "cond" and "masked" runs the "cond" prune,
    as the JAX package does: over the small stream with a window of three
    cameras, which saturates, every leaf of the final state and every
    output bit for bit the "cond" run's."""
    st = small[1]
    std = to_device(st, small[0], device="cpu")
    runs = {}
    for path in ("cond", "other"):
        cfg = _small_variant(small, {"max_camera_states": 3, "prune_path": path})
        stats = mt.FrameStats()
        state = mt.make_initial_state(cfg, st.R_init, device="cpu")
        runs[path] = mt.run_sequence(cfg, state, std.prefix, std.frames, assume_camera=True,
                                     device="cpu", stats=stats), stats
    (cond, _, cout), cstats = runs["cond"]
    (other, _, oout), ostats = runs["other"]
    assert cstats.prunes > 0 and ostats.prunes == cstats.prunes
    assert ostats.host_syncs == cstats.host_syncs
    a, b = mt.state_to_numpy(other), mt.state_to_numpy(cond)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(oout, cout):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


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
