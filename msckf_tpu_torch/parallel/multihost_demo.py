"""Multi-process demo of the batched filter over ``torch.distributed``
(port of ``scripts/multihost_demo.py``).

Each process contributes its local rows of the trajectory batch, runs
``parallel/multihost.py``'s program on its own device and prints its
rows' final positions:

    python -m msckf_tpu_torch.parallel.multihost_demo --coordinator 127.0.0.1:9911 \\
        --num_processes 2 --process_id 0 --device cpu --backend gloo &
    python -m msckf_tpu_torch.parallel.multihost_demo --coordinator 127.0.0.1:9911 \\
        --num_processes 2 --process_id 1 --device cpu --backend gloo

Every row runs the same stream (the JAX demo's), so every process must
print the same row. The line is the JAX demo's, ``MULTIHOST process i/n
devices=n local_rows=k p_WI=[...]``, followed by ``digest=``, the SHA-256
of the local rows' final positions, so that two runs can be compared bit
for bit. ``--rows`` sets the rows a process (the JAX demo runs one a
device). On the CPU the demo sets one PyTorch intra-op thread itself.
"""

from __future__ import annotations

import argparse
import hashlib

import numpy as np
import torch

from msckf_tpu_torch.config import reference_experiment_config
from msckf_tpu_torch.data.stream import build_stream, to_device
from msckf_tpu_torch.data.synthetic import generate_circle_sequence
from msckf_tpu_torch.parallel import multihost as mh
from msckf_tpu_torch.parallel.batched import batched_initial_state


def demo_inputs(ticks: int):
    """The JAX demo's configuration and its one stream (host tensors)."""
    cfg = reference_experiment_config(
        dtype="float32", f_max=32, u_max=8, k_max=32, desc_dim=10,
        n_cam_slots=6, max_camera_states=4, m_max=6,
    )
    seq = generate_circle_sequence(rng=np.random.default_rng(0), n_world_points=40,
                                   desc_dim=10)
    st = build_stream(cfg, seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                      seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores,
                      max_ticks=ticks)
    return cfg, to_device(st, cfg, device="cpu")


def demo_batch(cfg, std, rows: int):
    """``rows`` copies of the stream and fresh states: (states, prefix,
    frames) on the host."""
    def rep(d):
        return {k: v.expand(rows, *v.shape).contiguous() for k, v in d.items()}

    states = batched_initial_state(cfg, rows, R_init=std.R_init, device="cpu")
    return states, rep(std.prefix), rep(std.frames)


def digest(p: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(p).tobytes()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--rows", type=int, default=1, help="rows of the batch a process")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)

    ok = mh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                             backend=args.backend, device=args.device)
    world = torch.distributed.get_world_size() if ok else 1
    if world != args.num_processes:
        raise RuntimeError(f"distributed init failed: world size {world}")
    try:
        cfg, std = demo_inputs(args.ticks)
        mesh = mh.global_data_mesh(device=args.device)
        n_global = world * args.rows
        _, per = mh.local_batch_slice(n_global)
        states, prefix, frames = (mh.shard_global_batch(t, mesh)
                                  for t in demo_batch(cfg, std, per))
        final, _, _ = mh.multihost_run_sequence(cfg, mesh)(states, prefix, frames)
        local = final.imu.p_WI.cpu().numpy()
        print(
            f"MULTIHOST process {torch.distributed.get_rank()}/{world} "
            f"devices={world} local_rows={local.shape[0]} "
            f"p_WI={np.array2string(local[0], precision=6, floatmode='fixed')} "
            f"digest={digest(local)}",
            flush=True,
        )
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
