"""Image-in pipeline: the XFeat CNN feeding the MSCKF camera loop (port of
``msckf_tpu/pipeline.py``).

``fused_frame_step`` runs ``detect_and_compute`` on one image, then the
filter's frame block on its keypoints. ``run_sequence_images`` runs the
whole sequence in two stages: the CNN over the image stack as one batched
call (or in chunks of ``cnn_chunk`` frames), since only the filter carries a
dependence from frame to frame; then the propagate-only prefix and the loop
of ``frame_step(..., assume_camera=True)`` over the frames. Both give the
same numbers as the per-frame composition.

Shapes: images are (H, W) grayscale in [0, 255]; the CNN emits fixed
(top_k, ...) keypoint, descriptor, score and valid buffers that feed the
filter directly (K = top_k, not ``cfg.k_max``). The CNN runs in float32;
its outputs are cast to the filter's dtype. ``cfg.desc_dim`` must be 64,
XFeat's descriptor width.
"""

from __future__ import annotations

import torch

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.msckf import FrameStats, frame_step, propagate_prefix, run_filter
from msckf_tpu_torch.filter.state import FilterState
from msckf_tpu_torch.models.xfeat import XFeatModel, detect_and_compute
from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls


def _check_inputs(cfg: MSCKFConfig, model: XFeatModel, state: FilterState, images, blocks,
                  device) -> None:
    if cfg.desc_dim != 64:
        raise ValueError(f"XFeat descriptors are 64-d; cfg.desc_dim={cfg.desc_dim}")
    dev = resolve_device(device)
    check_on_device(state.P, dev, "the filter state")
    check_on_device(images, dev, "the images")
    check_on_device(next(model.parameters()), dev, "the XFeat model")
    for block in blocks:
        for name, x in block.items():
            check_on_device(x, dev, f"stream field {name!r}")


def _features(cfg: MSCKFConfig, kp, desc, score, kp_valid) -> dict:
    dt = cfg.jdtype
    return dict(kp=kp.to(dt), desc=desc.to(dt), score=score.to(dt), kp_valid=kp_valid)


@with_f32_matmuls
def fused_frame_step(cfg: MSCKFConfig, model: XFeatModel, state: FilterState,
                     image: torch.Tensor, imu_block: dict, top_k: int = 300,
                     refine_subpix: bool = False, device=None,
                     stats: FrameStats | None = None):
    """One camera frame, image in: ``detect_and_compute`` on ``image`` (H, W),
    then ``frame_step`` with ``assume_camera`` on its outputs. ``imu_block``
    holds imu_ts (B,), imu_gyro (B, 3), imu_acc (B, 3), imu_valid (B,).
    Runs on ``device`` (the GPU unless ``device="cpu"``), where the model,
    the state, the image and the block must already live. Returns (state,
    TickOutput with a leading B axis)."""
    _check_inputs(cfg, model, state, image, (imu_block,), device)
    feats = detect_and_compute(model, image, top_k=top_k, refine_subpix=refine_subpix)
    frame = dict(imu_block, **_features(cfg, *feats))
    return frame_step(cfg, state, frame, assume_camera=True, stats=stats)


@with_f32_matmuls
def run_sequence_images(cfg: MSCKFConfig, model: XFeatModel, state: FilterState,
                        prefix: dict, imu_frames: dict, images: torch.Tensor,
                        top_k: int = 300, refine_subpix: bool = False,
                        cnn_chunk: int | None = None, device=None,
                        stats: FrameStats | None = None):
    """The whole image-in sequence: the CNN stage over ``images`` (C, H, W),
    then the filter over the prefix and the C frame blocks of ``imu_frames``
    (imu_ts (C, B), imu_gyro (C, B, 3), imu_acc (C, B, 3), imu_valid (C, B);
    ``data/stream.py::build_image_stream`` makes them).

    ``cnn_chunk``: run the CNN stage in chunks of this many frames to bound
    activation memory (a 640x480 frame's block1 activations take about 5 MB);
    the last chunk is padded with zero images to the chunk's size, whose
    outputs are dropped before the filter sees anything. None: the whole
    stack in one call.

    Runs on ``device`` (the GPU unless ``device="cpu"``). Returns
    (final_state, prefix TickOutput, frame TickOutput (C, B, ...))."""
    _check_inputs(cfg, model, state, images, (prefix, imu_frames), device)

    def dc(x):
        return detect_and_compute(model, x, top_k=top_k, refine_subpix=refine_subpix)

    C = images.shape[0]
    if cnn_chunk is None:
        feats = dc(images)
    else:
        pad = (-C) % cnn_chunk
        if pad:
            images = torch.cat([images, images.new_zeros((pad,) + images.shape[1:])])
        chunks = [dc(images[i:i + cnn_chunk]) for i in range(0, C + pad, cnn_chunk)]
        feats = [torch.cat(parts)[:C] for parts in zip(*chunks)]
    frames = dict(imu_frames, **_features(cfg, *feats))

    state, pre_out = propagate_prefix(cfg, state, prefix)
    state, outs = run_filter(cfg, state, frames, assume_camera=True, stats=stats)
    return state, pre_out, outs
