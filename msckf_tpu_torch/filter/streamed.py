"""Chunked, double-buffered sequence streaming for sequences larger than
device memory (port of ``msckf_tpu/filter/streamed.py``).

``data/stream.py::to_device`` uploads the whole prepared stream, which
bounds a sequence's length by device memory. Here the host keeps the
stream and its outputs as numpy; the device holds two frame chunks and the
outputs in flight.

The JAX package gets its overlap from asynchronous dispatch and pads the
last chunk with no-op frames so that one compiled program serves every
chunk. The eager port has no shapes to keep static, so the last chunk is
simply shorter, and the overlap is explicit:

* each host chunk is staged in pinned memory and copied to the device with
  ``non_blocking=True`` on a side stream (``up``) while the previous chunk
  runs on the current stream, which waits for the copy (``wait_stream``)
  before it reads the chunk; the chunk's tensors are marked as used on the
  current stream (``record_stream``), so the allocator does not hand their
  memory to the next upload while the filter still reads them;
* a chunk's outputs are copied into pinned host buffers on a second side
  stream (``down``) after the current stream's work on them, and the host
  waits for that copy (one host sync per chunk, counted in
  ``FrameStats.host_syncs``) only after the next chunk has been issued,
  when it hands the numpy arrays to ``on_chunk`` or to the result.

On the CPU the streams are absent and the same code makes plain copies.
The frames run through the same ``frame_step`` calls in the same order as
in the monolithic ``run_sequence``, on the same per-frame views, so the
trajectory and the final state do not depend on ``chunk_frames``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.msckf import FrameStats, TickOutput, frame_step, propagate_prefix
from msckf_tpu_torch.filter.state import FilterState
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls
from msckf_tpu_torch.parallel.batched import (
    DataMesh, _batch_size, _gather, batched_dispatch, data_mesh, shard_batch, vmapped_frame_step,
)


class _Pipe:
    """Host-to-device uploads and device-to-host fetches on two side
    streams of ``device`` (no streams on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.up = torch.cuda.Stream(device) if self.cuda else None
        self.down = torch.cuda.Stream(device) if self.cuda else None

    def _on(self, stream):
        return torch.cuda.stream(stream) if self.cuda else contextlib.nullcontext()

    def upload(self, host: dict) -> dict:
        """Start the copy of a host chunk (numpy, already in the filter's
        dtype) to the device; returns the device tensors."""
        out = {}
        with self._on(self.up):
            for k, v in host.items():
                src = torch.from_numpy(np.ascontiguousarray(v))
                staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=self.cuda)
                staged.copy_(src)
                out[k] = torch.empty(src.shape, dtype=src.dtype, device=self.device)
                out[k].copy_(staged, non_blocking=True)
        return out

    def ready(self, chunk: dict) -> None:
        """Let the current stream read an uploaded chunk."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self.up)
            for t in chunk.values():
                t.record_stream(cur)

    def fetch(self, out: TickOutput):
        """Start the copy of outputs to pinned host buffers after the current
        stream's work on them; returns (host tensors, event or None)."""
        event = None
        if self.cuda:
            self.down.wait_stream(torch.cuda.current_stream(self.device))
        with self._on(self.down):
            host = []
            for t in out:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                h.copy_(t, non_blocking=True)
                if self.cuda:
                    t.record_stream(self.down)
                host.append(h)
            if self.cuda:
                event = torch.cuda.Event()
                event.record(self.down)
        return host, event


def _host_slice(d: dict, cfg: MSCKFConfig, axis: int, a: int, b: int) -> dict:
    """Frames a..b of a host stream along ``axis``, float payloads cast to
    the filter dtype (``data/stream.py::to_device``'s contract)."""
    out = {}
    for k, v in d.items():
        v = np.asarray(v)[(slice(None),) * axis + (slice(a, b),)]
        out[k] = v.astype(cfg.dtype) if v.dtype == np.float64 else v
    return out


def _stream(cfg: MSCKFConfig, shards, axis: int, chunk_frames: int, step,
            stats: FrameStats | None, on_chunk=None, on_prefix=None):
    """The double-buffered loop shared by the single, the batched and the
    sharded form. ``shards`` holds one (device, host prefix, host frames,
    run_prefix) a shard, ``axis`` is the frame axis of the frames and of
    the outputs, ``step`` one frame's ``(state, frame) -> (state,
    TickOutput)``. Each shard has its own pipe on its device; frame by frame
    the shards step in turn, and a chunk's host outputs are the shards'
    concatenated along the leading (batch) axis. ``stats``, ``on_chunk``
    and ``on_prefix`` serve the single form (one shard).

    The loop runs frame by frame here rather than through ``run_filter``: a
    call over a chunk would hold the chunk's first state for the whole
    chunk, one filter state (its track store) beyond what the monolithic
    loop holds. Returns (final states, one a shard; prefix TickOutput;
    frame TickOutput), the TickOutputs as host numpy."""
    C = int(np.asarray(shards[0][2]["imu_ts"]).shape[axis])
    if C == 0:
        raise ValueError("frames is empty")
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be positive, got {chunk_frames}")
    bounds = [(a, min(a + chunk_frames, C)) for a in range(0, C, chunk_frames)]
    lead = (slice(None),) * axis
    pipes = [_Pipe(dev) for dev, *_ in shards]

    def cat(parts):
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    states, pre_fetches, nxts = [], [], []
    for pipe, (_, prefix, frames, run_prefix) in zip(pipes, shards):
        pre = pipe.upload(_host_slice(prefix, cfg, axis, 0, None))
        pipe.ready(pre)
        nxts.append(pipe.upload(_host_slice(frames, cfg, axis, *bounds[0])))
        state, pre_out = run_prefix(pre)
        states.append(state)
        pre_fetches.append(pipe.fetch(pre_out))
        del pre, pre_out

    def host(fetches):
        return TickOutput(*(cat([h.numpy() for h in hs]) for hs in zip(*(f[0] for f in fetches))))

    chunks_out = []

    def deliver(pending):
        fetches, start = pending
        for _, event in fetches:
            if event is not None:
                event.synchronize()
        if stats is not None:
            stats.host_syncs += 1
        if start == 0 and on_prefix is not None:
            # the prefix's fetch went first on the same stream
            on_prefix(host(pre_fetches))
        out = host(fetches)
        chunks_out.append(out)
        if on_chunk is not None:
            on_chunk(start, out)

    pending = None
    for i, (a, b) in enumerate(bounds):
        chunks = nxts
        nxts = []
        for pipe, chunk, (_, _, frames, _) in zip(pipes, chunks, shards):
            pipe.ready(chunk)
            if i + 1 < len(bounds):
                nxts.append(pipe.upload(_host_slice(frames, cfg, axis, *bounds[i + 1])))
        outs = [[] for _ in shards]
        for j in range(b - a):
            for k, chunk in enumerate(chunks):
                states[k], out = step(states[k], {n: v[lead + (j,)] for n, v in chunk.items()})
                outs[k].append(out)
        fetched = ([pipe.fetch(TickOutput(*(torch.stack(list(x), dim=axis) for x in zip(*o))))
                    for pipe, o in zip(pipes, outs)], a)
        del chunks, outs
        if pending is not None:
            deliver(pending)
        pending = fetched
    deliver(pending)

    frame_out = TickOutput(*(np.concatenate(x, axis=axis) for x in zip(*chunks_out)))
    return states, host(pre_fetches), frame_out


@with_f32_matmuls
def run_sequence_streamed(cfg: MSCKFConfig, state: FilterState, prefix: dict, frames: dict,
                          chunk_frames: int = 64, device=None, on_chunk=None, on_prefix=None,
                          assume_camera: bool = False, stats: FrameStats | None = None):
    """``run_sequence(cfg, state, prefix, frames)`` over a host-resident
    stream (``data/stream.py::build_stream``'s numpy dicts, leading dim C),
    ``chunk_frames`` frames at a time, on ``device`` (the GPU unless
    ``device="cpu"``), where ``state`` must already live.

    ``assume_camera`` as in ``run_sequence``; ``stats`` counts as there,
    plus one host sync per chunk. ``on_prefix(prefix_out)`` and
    ``on_chunk(start_frame, chunk_out)`` receive each host TickOutput once
    it has arrived, while the next chunk is already issued.

    Returns (final state on the device, prefix TickOutput, frame TickOutput
    (C, B, ...)), the TickOutputs as host numpy."""
    dev = resolve_device(device)
    check_on_device(state.P, dev, "the filter state")
    (state,), pre_out, frame_out = _stream(
        cfg, [(dev, prefix, frames, lambda pre: propagate_prefix(cfg, state, pre))], 0,
        chunk_frames, lambda st, fr: frame_step(cfg, st, fr, assume_camera, stats),
        stats, on_chunk, on_prefix,
    )
    return state, pre_out, frame_out


@with_f32_matmuls
def run_batched_streamed(cfg: MSCKFConfig, states: FilterState, prefix: dict, frames: dict,
                         chunk_frames: int = 64, device=None, assume_camera: bool = False,
                         sharding: DataMesh | None = None):
    """The batched form of ``run_sequence_streamed``: ``batched_run_sequence``
    (with ``batched_dispatch``) over host arrays with leading dims (batch,
    Bp) and (batch, C, ...), streamed in chunks along the frame axis, on
    ``sharding``, a ``DataMesh`` (``parallel/batched.py::data_mesh``), by
    default ``data_mesh(devices=[device])`` (the GPU unless
    ``device="cpu"``). ``states`` (leading batch axis) must already live on
    the mesh's first device.

    The states and each host chunk split over the mesh as in
    ``sharded_run_sequence``, each device double-buffers its own uploads,
    and the frames run as there, bitwise.

    Returns (final states on the mesh's first device, prefix TickOutput
    (batch, Bp, ...), frame TickOutput (batch, C, B, ...)), the TickOutputs
    as host numpy."""
    mesh = sharding if sharding is not None else data_mesh(devices=[device])
    check_on_device(states.P, mesh.devices[0], "the filter states")
    bcfg = batched_dispatch(cfg)
    vstep = vmapped_frame_step(bcfg, assume_camera)
    prefix_step = torch.func.vmap(lambda s, p: propagate_prefix(bcfg, s, p))
    parts = shard_batch(states, mesh)
    per = _batch_size(parts[0])
    shards = []
    for i, (dev, st) in enumerate(zip(mesh.devices, parts)):
        rows = slice(i * per, (i + 1) * per)
        shards.append((dev, {k: np.asarray(v)[rows] for k, v in prefix.items()},
                       {k: np.asarray(v)[rows] for k, v in frames.items()},
                       lambda pre, st=st: prefix_step(st, pre)))
    finals, pre_out, frame_out = _stream(cfg, shards, 1, chunk_frames, vstep, None)
    return _gather(finals, mesh.devices[0]), pre_out, frame_out
