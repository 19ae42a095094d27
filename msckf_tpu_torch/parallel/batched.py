"""Batched multi-sequence filtering, on one device or sharded over several
(port of ``msckf_tpu/parallel/batched.py``).

B independent sequences run through one Python loop: ``torch.func.vmap``
maps the port's ``frame_step`` over a leading batch axis of the state and
the stream, as ``jax.vmap`` maps the JAX package's. Each kernel is a
``torch.library`` custom op whose vmap rule launches one batched kernel for
the whole batch (``ops/kernels.py``), and each ``lax.cond`` of the frame
step is a select of both branches, so the loop reads nothing on the host.

The mesh functions are the single-process forms, one process driving
several devices as a JAX ``('data',)`` mesh does: ``data_mesh``,
``shard_batch`` (one shard of the leading axis per device),
``sharded_run_sequence`` (each shard vmapped on its device, the launches
interleaved frame by frame from one host thread) and
``shardmap_run_sequence`` (one unbatched sequence per device, one host
thread each). Trajectories are independent, so no shard reads another's
data. The loops are bound by the host's issue rate, and one process's
threads share one interpreter lock, so a process drives its cards no faster
than one card: ``parallel/multihost.py`` has the form that scales, one
process per card.
"""

from __future__ import annotations

import dataclasses
import threading

import torch
from torch.utils._pytree import tree_flatten, tree_map

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.msckf import (
    FrameStats, TickOutput, frame_step, make_initial_state, propagate_prefix, run_sequence,
)
from msckf_tpu_torch.filter.state import FilterState
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls
from msckf_tpu_torch.utils import tracing

_DEFAULT_NS_ITERS = next(
    f.default for f in dataclasses.fields(MSCKFConfig) if f.name == "gating_ns_iters"
)


def batched_dispatch(cfg: MSCKFConfig) -> MSCKFConfig:
    """The JAX package's kernel-switch overrides for the batched path.

    * The triage kernel goes off (``use_pallas_triage=False``).
    * ``gating_solver="auto"`` becomes the Newton-Schulz gate, ``"ns"``,
      with 12 iterations, unless the caller set ``gating_ns_iters``: the JAX
      package writes 12 over any value (ROADMAP §3), the port only over the
      default. A float32 filter takes the exact gate there (the gating
      kernel, ``filter/update.py``; ROADMAP §1).
    * The correction island: the card has float64, so the clause behaves as
      the JAX package's does with x64 on. The float64 LU island stays; a
      float32 filter with ``correction_dtype="compensated"`` gets
      ``island_solver="ns"``, as in JAX. The port's double-word island
      solves by the LU under vmap for either setting, with no host read. A
      float32 chain (``dtype="float32"`` with ``correction_dtype="float32"``)
      takes ``batched_solver``: with
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


def vmapped_frame_step(cfg: MSCKFConfig, assume_camera: bool, tally: bool = False):
    """The vmapped frame step, with ``cfg`` as given (no dispatch, no
    checks): (states, frames) -> (states, TickOutput), and with ``tally``
    after them the per-sequence counts of camera steps, prunes and prune
    updates (``FrameStats.DEVICE_COUNTS``)."""

    def one(state, frame):
        return frame_step(cfg, state, frame, assume_camera, batched=True)

    def counted(state, frame):
        stats = FrameStats()
        state, out = frame_step(cfg, state, frame, assume_camera, stats, batched=True)
        # a host count (the camera steps under assume_camera) becomes a
        # device tensor by a fill, not by a copy, which would synchronize
        return state, out, *(
            n if isinstance(n, torch.Tensor)
            else torch.full((), n, dtype=torch.int64, device=state.device)
            for n in (getattr(stats, f) for f in FrameStats.DEVICE_COUNTS)
        )

    return torch.func.vmap(counted if tally else one)


@with_f32_matmuls
def batched_frame_step(cfg: MSCKFConfig, states: FilterState, frames: dict,
                       dispatch_auto: bool = True, assume_camera: bool = False,
                       device=None):
    """One camera-frame block for a batch of independent filters (a leading
    batch axis on the states and on every frame field) on ``device`` (the
    GPU unless ``device="cpu"``). Returns (states, TickOutput with leading
    (batch, B) axes). The span ``step`` covers the call."""
    with tracing.span("step", memory=True):
        if dispatch_auto:
            cfg = batched_dispatch(cfg)
        _check_inputs(states, (frames,), device)
        return vmapped_frame_step(cfg, assume_camera)(states, frames)


def _run_shards(cfg: MSCKFConfig, shards, devices, assume_camera: bool,
                stats: FrameStats | None = None):
    """The batched loop over one or more shards, each a (states, prefix,
    frames) triple on its device: the vmapped prefix of each, then frame by
    frame the vmapped step of each shard in turn, so that the launches of
    several devices interleave. ``cfg`` as given (no dispatch). ``stats``
    (one shard only) counts as ``batched_run_sequence`` says. Returns one
    (states, prefix TickOutput, frame TickOutput) triple a shard."""
    for (states, prefix, frames), dev in zip(shards, devices):
        _check_inputs(states, (prefix, frames), dev)
    prefix_step = torch.func.vmap(lambda s, p: propagate_prefix(cfg, s, p))
    states, pre_outs = map(list, zip(*(prefix_step(st, pre) for st, pre, _ in shards)))
    step = vmapped_frame_step(cfg, assume_camera, tally=stats is not None)
    outs = [[] for _ in shards]
    for j in range(shards[0][2]["imu_ts"].shape[1]):
        for i, (_, _, frames) in enumerate(shards):
            states[i], out, *counts = step(states[i], {k: v[:, j] for k, v in frames.items()})
            outs[i].append(out)
        if stats is not None:
            stats.frames += 1
            for f, n in zip(FrameStats.DEVICE_COUNTS, counts):
                setattr(stats, f, getattr(stats, f) + n)
    return [
        (st, pre, TickOutput(*(torch.stack(list(x), dim=1) for x in zip(*o))))
        for st, pre, o in zip(states, pre_outs, outs)
    ]


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
    return _run_shards(cfg, [(states, prefix, frames)], [device], assume_camera, stats)[0]


# --------------------------------------------------------------------------
# several devices in one process (the JAX module's mesh functions)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The devices of a 1-D ``("data",)`` mesh in one process, in mesh
    order (the counterpart of a ``jax.sharding.Mesh`` over ``("data",)``).
    A device may appear more than once: two shards on one card run the
    split as several cards would."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def data_mesh(n_devices: int | None = None, devices=None) -> DataMesh:
    """A ``DataMesh`` over ``devices`` (e.g. ``["cpu", "cpu"]`` or
    ``["cuda:0", "cuda:1"]``), by default over the visible CUDA devices;
    ``n_devices`` keeps the first ones. Raises without a GPU unless every
    device is the CPU."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(tuple(devs))


def _batch_size(tree) -> int:
    return next(int(x.shape[0]) for x in tree_flatten(tree)[0] if x.ndim >= 1)


def shard_batch(tree, mesh: DataMesh) -> list:
    """The leading (batch) axis of every leaf of ``tree`` (tensors or numpy
    arrays) split into ``mesh.size`` equal shards in mesh order, each on its
    device; a 0-d leaf is copied to every device. Raises ``ValueError``
    where the batch does not divide by the mesh: uneven splits are never
    padded. Returns a list of trees, one a device."""
    n = mesh.size
    B = _batch_size(tree)
    if B % n:
        raise ValueError(f"batch {B} does not divide over {n} devices")
    per = B // n

    def shard(i, dev):
        def put(x):
            x = torch.as_tensor(x)
            return x.to(dev) if x.ndim == 0 else x[i * per:(i + 1) * per].contiguous().to(dev)
        return tree_map(put, tree)

    return [shard(i, dev) for i, dev in enumerate(mesh.devices)]


def _gather(shard_results: list, device: torch.device):
    """Per-shard result trees concatenated along the batch axis, in mesh
    order, on ``device``."""
    if len(shard_results) == 1:
        return shard_results[0]
    return tree_map(lambda *xs: torch.cat([x.to(device) for x in xs]), *shard_results)


def sharded_run_sequence(cfg: MSCKFConfig, mesh: DataMesh, assume_camera: bool = False):
    """``run(states, prefix, frames)``: ``batched_run_sequence`` (with
    ``batched_dispatch``) with the batch split over ``mesh``. The inputs
    are whole batched trees on any device; ``shard_batch`` places each
    shard on its device, where the vmapped loop runs, the shards' launches
    interleaved frame by frame from this thread (the loop makes no host
    sync). Each shard's rows are bitwise the batched loop's of those rows
    alone. Returns (final states, prefix TickOutput, frame TickOutput)
    concatenated in mesh order on the first device."""
    bcfg = batched_dispatch(cfg)

    @with_f32_matmuls
    def run(states, prefix, frames):
        shards = list(zip(*(shard_batch(t, mesh) for t in (states, prefix, frames))))
        results = _run_shards(bcfg, shards, mesh.devices, assume_camera)
        return _gather(results, mesh.devices[0])

    return run


def shardmap_run_sequence(cfg: MSCKFConfig, mesh: DataMesh):
    """``run(states, prefix, frames)`` with one sequence a device (batch ==
    mesh size): each device runs the UNBATCHED ``run_sequence``, with the
    single loop's native branches and every kernel of ``cfg``. Its branches
    read the device on the host, so each device gets a host thread
    (``shardmap-<i>``); an exception in any of them is raised here. The
    inputs are whole batched trees. Returns the results with a leading
    batch axis, concatenated on the first device."""

    def run(states, prefix, frames):
        if _batch_size(states) != mesh.size:
            raise ValueError(f"shardmap_run_sequence runs one sequence a device; the batch "
                             f"must be the mesh size {mesh.size}")
        shards = list(zip(*(shard_batch(t, mesh) for t in (states, prefix, frames))))
        for dev in set(mesh.devices):
            if dev.type == "cuda":
                # PyTorch loads its CUDA linear algebra on the first solve,
                # and two threads making that first call at once fail
                eye = torch.eye(1, device=dev)
                torch.linalg.solve_ex(eye, eye)
        results = [None] * mesh.size
        errors = [None] * mesh.size

        def work(i):
            try:
                one = [tree_map(lambda x: x[0], t) for t in shards[i]]
                out = run_sequence(cfg, *one, device=mesh.devices[i])
                results[i] = tree_map(lambda x: x[None], out)
            except BaseException as e:  # re-raised in the caller's thread
                errors[i] = e

        threads = [threading.Thread(target=work, args=(i,), name=f"shardmap-{i}")
                   for i in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None:
                raise e
        return _gather(results, mesh.devices[0])

    return run
