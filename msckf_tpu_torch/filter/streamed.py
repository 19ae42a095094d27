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
from msckf_tpu_torch.parallel.batched import batched_dispatch, vmapped_frame_step


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


def _stream(cfg: MSCKFConfig, dev: torch.device, prefix: dict, frames: dict, axis: int,
            chunk_frames: int, run_prefix, step, stats: FrameStats | None,
            on_chunk=None, on_prefix=None):
    """The double-buffered loop shared by the single and the batched form;
    ``axis`` is the frame axis of ``frames`` and of the outputs, ``step``
    one frame's ``(state, frame) -> (state, TickOutput)``.

    The loop runs frame by frame here rather than through ``run_filter``: a
    call over a chunk would hold the chunk's first state for the whole
    chunk, one filter state (its track store) beyond what the monolithic
    loop holds."""
    C = int(np.asarray(frames["imu_ts"]).shape[axis])
    if C == 0:
        raise ValueError("frames is empty")
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be positive, got {chunk_frames}")
    bounds = [(a, min(a + chunk_frames, C)) for a in range(0, C, chunk_frames)]
    lead = (slice(None),) * axis
    pipe = _Pipe(dev)

    pre = pipe.upload(_host_slice(prefix, cfg, axis, 0, None))
    pipe.ready(pre)
    nxt = pipe.upload(_host_slice(frames, cfg, axis, *bounds[0]))
    state, pre_out = run_prefix(pre)
    pre_fetch = pipe.fetch(pre_out)
    del pre, pre_out

    chunks_out = []

    def deliver(pending):
        (host, event), start = pending
        if event is not None:
            event.synchronize()
        if stats is not None:
            stats.host_syncs += 1
        if start == 0 and on_prefix is not None:
            # the prefix's fetch went first on the same stream
            on_prefix(TickOutput(*(h.numpy() for h in pre_fetch[0])))
        out = TickOutput(*(h.numpy() for h in host))
        chunks_out.append(out)
        if on_chunk is not None:
            on_chunk(start, out)

    pending = None
    for i, (a, b) in enumerate(bounds):
        chunk = nxt
        pipe.ready(chunk)
        if i + 1 < len(bounds):
            nxt = pipe.upload(_host_slice(frames, cfg, axis, *bounds[i + 1]))
        outs = []
        for j in range(b - a):
            state, out = step(state, {k: v[lead + (j,)] for k, v in chunk.items()})
            outs.append(out)
        out = TickOutput(*(torch.stack(list(x), dim=axis) for x in zip(*outs)))
        fetched = (pipe.fetch(out), a)
        del chunk, outs, out
        if pending is not None:
            deliver(pending)
        pending = fetched
    deliver(pending)

    pre_host = TickOutput(*(h.numpy() for h in pre_fetch[0]))
    frame_out = TickOutput(*(np.concatenate(x, axis=axis) for x in zip(*chunks_out)))
    return state, pre_host, frame_out


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
    return _stream(
        cfg, dev, prefix, frames, 0, chunk_frames,
        lambda pre: propagate_prefix(cfg, state, pre),
        lambda st, fr: frame_step(cfg, st, fr, assume_camera, stats),
        stats, on_chunk, on_prefix,
    )


@with_f32_matmuls
def run_batched_streamed(cfg: MSCKFConfig, states: FilterState, prefix: dict, frames: dict,
                         chunk_frames: int = 64, device=None, assume_camera: bool = False):
    """The batched form of ``run_sequence_streamed``: ``batched_run_sequence``
    (with ``batched_dispatch``) over host arrays with leading dims (batch,
    Bp) and (batch, C, ...), streamed in chunks along the frame axis.
    ``states`` (leading batch axis) must already live on ``device`` (the GPU
    unless ``device="cpu"``).

    Returns (final states on the device, prefix TickOutput (batch, Bp, ...),
    frame TickOutput (batch, C, B, ...)), the TickOutputs as host numpy."""
    dev = resolve_device(device)
    check_on_device(states.P, dev, "the filter states")
    bcfg = batched_dispatch(cfg)
    vstep = vmapped_frame_step(bcfg, assume_camera)
    return _stream(
        cfg, dev, prefix, frames, 1, chunk_frames,
        lambda pre: torch.func.vmap(lambda s, p: propagate_prefix(bcfg, s, p))(states, pre),
        lambda st, fr: vstep(st, fr)[:2],
        None,
    )
