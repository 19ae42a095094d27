"""The port's mesh helpers and the CPU stall's repair.

* ``parallel/batched.py::shard_batch`` splits the leading axis over a
  two-shard CPU mesh (``data_mesh(devices=["cpu", "cpu"])``) and refuses a
  batch that does not divide over it;
* the CPU stall (ROADMAP §3): in a fresh process with four PyTorch
  threads, the batched correction terms at the filter's size (D = 207,
  float64 island, B = 2 under ``torch.func.vmap``) finish inside the
  subprocess's 120 s timeout, with the one-thread results; before the
  LAPACK calls ran in one thread, MKL stalled there.

The sharded runs (``sharded_run_sequence`` against the JAX package's,
``shardmap_run_sequence``, ``run_batched_streamed(sharding=)``) are held in
tests/test_torch_batched.py, beside the batched run whose JAX compile they
share.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import msckf_tpu_torch as mt
from msckf_tpu_torch.filter.update import _correction_terms
from msckf_tpu_torch.parallel.batched import data_mesh, shard_batch

from tests.torch_fixtures import ROOT
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_shard_batch_splits_and_refuses_an_uneven_batch():
    mesh = data_mesh(devices=["cpu", "cpu"])
    tree = {"x": torch.arange(8.0).reshape(4, 2), "n": torch.tensor(3),
            "h": np.arange(4)}
    shards = shard_batch(tree, mesh)
    assert [s["x"].tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    assert [int(s["n"]) for s in shards] == [3, 3]
    assert [s["h"].tolist() for s in shards] == [[0, 1], [2, 3]]
    assert data_mesh(1, devices=["cpu", "cpu"]).size == 1
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch({"x": torch.zeros(3, 2)}, mesh)


def _island_inputs(D, B=2):
    rng = np.random.default_rng(5)
    G = rng.normal(size=(B, D, D)) / np.sqrt(D)
    P = G @ G.transpose(0, 2, 1) * 1e-2 + 1e-4 * np.eye(D)
    H = rng.normal(size=(B, 3 * D // 2, D))
    A = H.transpose(0, 2, 1) @ H * 1e2
    c = rng.normal(size=(B, D))
    return {k: x.astype(np.float32) for k, x in zip("PAc", (P, A, c))}


_FOUR_THREADS = """
import sys
import numpy as np
import torch
torch.set_num_threads(4)
sys.path.insert(0, {root!r})
import msckf_tpu_torch as mt
from msckf_tpu_torch.filter.update import _correction_terms
cfg = mt.reference_experiment_config()
with np.load({path!r}) as d:
    args = [torch.as_tensor(d[k]) for k in "PAc"]
out = torch.func.vmap(lambda P, A, c: _correction_terms(cfg, P, A, c))(*args)
assert torch.get_num_threads() == 4
np.savez({path!r}, delta=out[0].numpy(), P=out[1].numpy())
"""


def test_batched_correction_terms_run_with_four_threads(tmp_path):
    cfg = mt.reference_experiment_config()
    assert cfg.err_dim == 207 and cfg.correction_dtype == "float64"
    path = str(tmp_path / "island.npz")
    inputs = _island_inputs(cfg.err_dim)
    np.savez(path, **inputs)
    done = subprocess.run([sys.executable, "-c", _FOUR_THREADS.format(root=ROOT, path=path)],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    want = torch.func.vmap(lambda P, A, c: _correction_terms(cfg, P, A, c))(
        *(torch.as_tensor(inputs[k]) for k in "PAc"))
    with np.load(path) as got:
        for name, w in zip(("delta", "P"), want):
            assert np.isfinite(got[name]).all()
            np.testing.assert_allclose(got[name], w.numpy(), rtol=1e-4,
                                       atol=1e-6 * float(w.abs().max()), err_msg=name)
