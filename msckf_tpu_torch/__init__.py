"""msckf_tpu_torch — the MSCKF filter in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``msckf_tpu`` (the JAX package, which stays the reference). It
imports torch, numpy and scipy, never JAX. Entry points run on the GPU
unless the caller passes ``device="cpu"``; on the CPU each kernel's plain
PyTorch version runs instead. The image front-end (the XFeat CNN,
``detect_and_compute``) feeds the same loop through ``run_sequence_images``.
See ROADMAP.md for what is ported.
"""

from msckf_tpu_torch.config import MSCKFConfig, NOISE_PRESETS, reference_experiment_config
from msckf_tpu_torch.data.stream import build_image_stream, circle_streams
from msckf_tpu_torch.filter.msckf import (
    FrameStats,
    TickOutput,
    camera_step,
    frame_step,
    make_initial_state,
    propagate_prefix,
    run_filter,
    run_sequence,
)
from msckf_tpu_torch.filter.state import (
    FilterState,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from msckf_tpu_torch.models.frontend import FeatureExtractor
from msckf_tpu_torch.models.xfeat import (
    XFeatModel,
    batched_detect_and_compute,
    detect_and_compute,
    load_xfeat_npz,
)
from msckf_tpu_torch.parallel.batched import (
    batched_dispatch,
    batched_frame_step,
    batched_initial_state,
    batched_run_sequence,
)
from msckf_tpu_torch.pipeline import fused_frame_step, run_sequence_images

__all__ = [
    "MSCKFConfig",
    "NOISE_PRESETS",
    "reference_experiment_config",
    "FilterState",
    "FrameStats",
    "TickOutput",
    "init_state",
    "make_initial_state",
    "camera_step",
    "frame_step",
    "propagate_prefix",
    "run_filter",
    "run_sequence",
    "state_from_numpy",
    "state_to_numpy",
    "batched_dispatch",
    "batched_frame_step",
    "batched_initial_state",
    "batched_run_sequence",
    "circle_streams",
    "build_image_stream",
    "XFeatModel",
    "FeatureExtractor",
    "detect_and_compute",
    "batched_detect_and_compute",
    "load_xfeat_npz",
    "fused_frame_step",
    "run_sequence_images",
]
