"""The port's sharded XFeat (``parallel/xfeat_sharded.py``) against the JAX
package's on the CPU.

One launch of two processes over gloo (``python -m
msckf_tpu_torch.parallel.xfeat_sharded``) runs four 96 x 128 images at
``top_k=32`` through the mesh (1, 2), the channel-split convolutions with
their gathers, and then (2, 1), the images split over the ranks. Rank 0
writes each mesh's outputs; they are held to the JAX package's
``batched_detect_and_compute(..., mesh=xfeat_mesh(4, 2))`` on the virtual
CPU mesh at its own tolerance, 5e-4 (tests/test_xfeat_sharded.py:28), with
every keypoint slot and validity equal. Both packages read the committed
``weights/xfeat_selfsup.npz`` (the port by ``load_xfeat_npz``, which
tests/test_torch_xfeat.py holds to the converter). In one process every
mesh is one rank: ``shard_params`` then keeps every weight and the outputs
are bitwise the unsharded call's.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from msckf_tpu.models.train_xfeat import load_npz_params as jax_load_npz_params
from msckf_tpu.parallel import xfeat_sharded as jxs

from msckf_tpu_torch.models.xfeat import batched_detect_and_compute, load_xfeat_npz
from msckf_tpu_torch.parallel import xfeat_sharded as txs

from tests.torch_fixtures import ROOT, free_port, run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WEIGHTS = os.path.join(ROOT, "weights", "xfeat_selfsup.npz")
TOP_K = 32


def _images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 255, size=(4, 96, 128)).astype(np.float32)


def test_one_rank_mesh_is_the_unsharded_call():
    model = load_xfeat_npz(WEIGHTS, device="cpu")
    imgs = torch.as_tensor(_images())
    mesh = txs.xfeat_mesh(1, 1, device="cpu")
    got = txs.batched_detect_and_compute(txs.shard_params(model, mesh), imgs, top_k=TOP_K,
                                         mesh=mesh)
    want = batched_detect_and_compute(model, imgs, top_k=TOP_K)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_two_process_meshes_match_jax(tmp_path):
    np.save(tmp_path / "images.npy", _images())
    port = free_port()
    argv = ["-m", "msckf_tpu_torch.parallel.xfeat_sharded", "--coordinator",
            f"127.0.0.1:{port}", "--num_processes", "2", "--images",
            str(tmp_path / "images.npy"), "--weights", WEIGHTS, "--meshes", "1x2,2x1",
            "--top_k", str(TOP_K), "--out", str(tmp_path), "--device", "cpu",
            "--backend", "gloo"]
    outs = run_ranks([argv + ["--process_id", str(i)] for i in range(2)])
    assert all("mesh 1x2" in o and "mesh 2x1" in o for o in outs)

    params = jax_load_npz_params(WEIGHTS)
    jmesh = jxs.xfeat_mesh(4, 2)
    want = [np.asarray(x) for x in jxs.batched_detect_and_compute(
        jxs.shard_params(params, jmesh), jnp.asarray(_images()), top_k=TOP_K, mesh=jmesh)]
    for mesh in ("1x2", "2x1"):
        with np.load(tmp_path / f"mesh_{mesh}.npz") as d:
            got = [d[k] for k in ("kpts", "desc", "scores", "valid")]
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"{mesh} keypoints")
        np.testing.assert_array_equal(got[3], want[3], err_msg=f"{mesh} valid")
        for name, g, w in zip(("desc", "scores"), got[1:3], want[1:3]):
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-4, err_msg=f"{mesh} {name}")
        assert got[3].sum() > 0
