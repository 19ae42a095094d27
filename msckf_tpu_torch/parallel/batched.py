"""Batched multi-sequence filtering on one card
(port of ``msckf_tpu/parallel/batched.py``, its single-device part).

B independent sequences run through one Python loop: ``torch.func.vmap``
maps the port's ``frame_step`` over a leading batch axis of the state and
the stream, as ``jax.vmap`` maps the JAX package's. Each kernel is a
``torch.library`` custom op whose vmap rule launches one batched kernel for
the whole batch (``ops/kernels.py``), and each ``lax.cond`` of the frame
step is a select of both branches, so the loop reads nothing on the host.

The multi-device functions of the JAX module (``data_mesh``,
``shard_batch``, ``shardmap_run_sequence``, ``sharded_run_sequence``) are
not ported (ROADMAP §1 item 10).
"""

from __future__ import annotations

import dataclasses

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.msckf import (
    FrameStats, TickOutput, frame_step, make_initial_state, propagate_prefix,
)
from msckf_tpu_torch.filter.state import FilterState
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls

_DEFAULT_NS_ITERS = next(
    f.default for f in dataclasses.fields(MSCKFConfig) if f.name == "gating_ns_iters"
)


def batched_dispatch(cfg: MSCKFConfig) -> MSCKFConfig:
    """The JAX package's kernel-switch overrides for the batched path.

    * The triage kernel goes off (``use_pallas_triage=False``).
    * ``gating_solver="auto"`` becomes the Newton-Schulz gate, ``"ns"``,
      with 12 iterations, unless the caller set ``gating_ns_iters``: the JAX
      package writes 12 over any value (ROADMAP §3), the port only over the
      default.
    * The correction island: the card has float64, so the clause behaves as
      the JAX package's does with x64 on. The float64 LU island stays; a
      float32 filter with ``correction_dtype="compensated"`` gets
      ``island_solver="ns"``, as in JAX (the compensated island itself is
      not ported and raises). A float32 chain (``dtype="float32"`` with
      ``correction_dtype="float32"``) takes ``batched_solver``: with
      ``"ns"``, the default, the vmap rule of ``ops/solve.py::gain_solve``
      solves the whole batch by Newton-Schulz with one residual gate and the
      batched LU as its fallback.

    The reasons for these overrides are TPU measurements recorded in the
    JAX module (batch 32 on a v5e: the triage kernel's batch grid runs as a
    sequential loop there, and the gating kernel's flattened grid paid more
    per update than the NS gate). They say nothing about the H100; the
    overrides are kept so that both packages run the same filter.
    """
    if cfg.use_pallas and cfg.use_pallas_triage:
        cfg = dataclasses.replace(cfg, use_pallas_triage=False)
    if cfg.gating_solver == "auto":
        iters = 12 if cfg.gating_ns_iters == _DEFAULT_NS_ITERS else cfg.gating_ns_iters
        cfg = dataclasses.replace(cfg, gating_solver="ns", gating_ns_iters=iters)
    if (cfg.correction_dtype == "compensated" and cfg.jdtype == torch.float32
            and cfg.island_solver != "ns"):
        cfg = dataclasses.replace(cfg, island_solver="ns")
    return cfg


def batched_initial_state(cfg: MSCKFConfig, batch: int, R_init=None,
                          device=None) -> FilterState:
    """A batch of fresh filter states (a leading axis on every leaf) on
    ``device`` (the GPU unless ``device="cpu"``). ``R_init``: one (3, 3)
    orientation for all, or (batch, 3, 3)."""
    one = make_initial_state(cfg, device=device)
    states = torch.utils._pytree.tree_map(
        lambda x: x.expand(batch, *x.shape).contiguous(), one
    )
    if R_init is not None:
        R = torch.as_tensor(R_init, dtype=cfg.jdtype, device=states.device)
        states = states.replace(
            imu=states.imu.replace(R_WI=R.expand(batch, 3, 3).contiguous()),
            initialized=torch.ones(batch, dtype=torch.bool, device=states.device),
        )
    return states


def _check_inputs(states: FilterState, streams, device) -> torch.device:
    dev = resolve_device(device)
    check_on_device(states.P, dev, "the filter states")
    for stream in streams:
        for name, x in stream.items():
            check_on_device(x, dev, f"stream field {name!r}")
    return dev


def _step(cfg: MSCKFConfig, assume_camera: bool):
    """The vmapped frame step: (states, frames) -> (states, TickOutput,
    per-sequence counts of camera steps, prunes and prune updates)."""

    def one(state, frame):
        tally = FrameStats()
        state, out = frame_step(cfg, state, frame, assume_camera, tally, batched=True)
        # a host count (the camera steps under assume_camera) becomes a
        # device tensor by a fill, not by a copy, which would synchronize
        counts = [
            n if isinstance(n, torch.Tensor)
            else torch.full((), n, dtype=torch.int64, device=state.device)
            for n in (getattr(tally, f) for f in FrameStats.DEVICE_COUNTS)
        ]
        return state, out, counts

    return torch.func.vmap(one)


@with_f32_matmuls
def batched_frame_step(cfg: MSCKFConfig, states: FilterState, frames: dict,
                       dispatch_auto: bool = True, assume_camera: bool = False,
                       device=None):
    """One camera-frame block for a batch of independent filters (a leading
    batch axis on the states and on every frame field) on ``device`` (the
    GPU unless ``device="cpu"``). Returns (states, TickOutput with leading
    (batch, B) axes)."""
    if dispatch_auto:
        cfg = batched_dispatch(cfg)
    _check_inputs(states, (frames,), device)
    states, out, _ = _step(cfg, assume_camera)(states, frames)
    return states, out


@with_f32_matmuls
def batched_run_sequence(cfg: MSCKFConfig, states: FilterState, prefix: dict, frames: dict,
                         dispatch_auto: bool = True, assume_camera: bool = False,
                         device=None, stats: FrameStats | None = None):
    """B sequences at once: the propagate-only prefix, then the camera-frame
    blocks, each vmapped over the leading batch axis of ``states``,
    ``prefix`` and ``frames`` (every field). Runs on ``device`` (the GPU
    unless ``device="cpu"``); the inputs must already live there.

    ``dispatch_auto=False`` skips ``batched_dispatch``. ``assume_camera``
    drops the per-frame ``has_camera`` select, which otherwise runs the
    camera step on every frame and selects it per sequence. ``stats``
    counts frames here and camera steps, prunes and prune updates per
    sequence as device tensors; the loop makes no host sync.

    Returns (final states, prefix TickOutput (batch, Bp, ...), frame
    TickOutput (batch, C, B, ...)).
    """
    if dispatch_auto:
        cfg = batched_dispatch(cfg)
    _check_inputs(states, (prefix, frames), device)
    states, pre_out = torch.func.vmap(lambda s, p: propagate_prefix(cfg, s, p))(states, prefix)
    step = _step(cfg, assume_camera)
    outs = []
    for j in range(frames["imu_ts"].shape[1]):
        states, out, counts = step(states, {k: v[:, j] for k, v in frames.items()})
        if stats is not None:
            stats.frames += 1
            for f, n in zip(FrameStats.DEVICE_COUNTS, counts):
                setattr(stats, f, getattr(stats, f) + n)
        outs.append(out)
    frame_out = TickOutput(*(torch.stack(list(x), dim=1) for x in zip(*outs)))
    return states, pre_out, frame_out
