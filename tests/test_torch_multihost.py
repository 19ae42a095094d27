"""The port's multi-process scale-out (``parallel/multihost.py``) on the
CPU.

* The single-process form, as tests/test_multihost.py holds the JAX
  package's: ``init_distributed()`` stays single-process without a
  launcher's environment, ``local_batch_slice`` covers the whole batch, and
  ``multihost_run_sequence`` on ``global_data_mesh``'s one rank is bitwise
  ``batched_run_sequence`` (float32, ``use_pallas=False`` as there; four
  seeds and 100 ticks; every error under 1 m).
* Two real processes over gloo run the demo
  (``python -m msckf_tpu_torch.parallel.multihost_demo``, one row each):
  both print the JAX demo's ``MULTIHOST`` line, and their rows are bitwise
  equal to each other and to a one-process run of the row (the digest of
  the final positions). Both processes run under a hard timeout, so a hung
  rendezvous fails the test.
"""

import re

import numpy as np
import torch

import msckf_tpu_torch as mt
from msckf_tpu_torch.data.stream import to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.parallel import multihost as mh
from msckf_tpu_torch.parallel import multihost_demo as demo

from tests.torch_fixtures import free_port, run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_multihost_single_process_dp():
    assert mh.init_distributed() is False
    assert mh.local_batch_slice(8) == (0, 8)
    cfg = mt.reference_experiment_config(dtype="float32", f_max=64, u_max=16, k_max=64,
                                         desc_dim=16, use_pallas=False)
    B = 4
    host = mt.circle_streams(cfg, range(B), max_ticks=100, n_world_points=60)
    std = to_device(host, cfg, device="cpu")
    mesh = mh.global_data_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data",) and mh.rank_device(mesh) == torch.device("cpu")
    states = mt.batched_initial_state(cfg, B, std.R_init, device="cpu")
    final, pre, fr = mh.multihost_run_sequence(cfg, mesh)(
        *(mh.shard_global_batch(t, mesh) for t in (states, std.prefix, std.frames)))
    want = mt.batched_run_sequence(cfg, states, std.prefix, std.frames, device="cpu")
    for got, ref in ((final.P, want[0].P), (final.imu.p_WI, want[0].imu.p_WI),
                     (fr.p_WI, want[2].p_WI), (pre.sigma_pos, want[1].sigma_pos)):
        assert torch.equal(got, ref)
    gathered = mh.gather_global(fr, mesh)
    assert all(torch.equal(a, b) for a, b in zip(gathered, fr))
    p = final.imu.p_WI.double().numpy()
    seqs = [generate_circle_sequence(rng=np.random.default_rng(b), n_world_points=60)
            for b in range(B)]
    errs = [np.linalg.norm(p[b] - seqs[b].poses_t[host.n_ticks - 1]) for b in range(B)]
    assert np.all(np.isfinite(errs)) and max(errs) < 1.0


def test_two_process_gloo_demo():
    port = free_port()
    outs = run_ranks([["-m", "msckf_tpu_torch.parallel.multihost_demo",
                       "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                       "--process_id", str(i), "--device", "cpu", "--backend", "gloo"]
                      for i in range(2)])
    lines = []
    for i, out in enumerate(outs):
        m = re.search(r"MULTIHOST process (\d)/2 devices=2 local_rows=1 "
                      r"p_WI=\[([^\]]+)\] digest=([0-9a-f]+)", out)
        assert m, f"no MULTIHOST line in:\n{out[-2000:]}"
        assert int(m.group(1)) == i
        lines.append((np.array(m.group(2).split(), dtype=float), m.group(3)))
    (p0, d0), (p1, d1) = lines
    np.testing.assert_array_equal(p0, p1)
    assert d0 == d1 and np.all(np.isfinite(p0))

    # the same row in one process, on the CPU
    cfg, std = demo.demo_inputs(40)
    final, _, _ = mt.batched_run_sequence(cfg, *demo.demo_batch(cfg, std, 1), device="cpu")
    assert demo.digest(final.imu.p_WI.numpy()) == d0
