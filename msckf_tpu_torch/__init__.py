"""msckf_tpu_torch — the MSCKF filter in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of ``msckf_tpu`` (the JAX package, which stays the reference). It
imports torch, numpy and scipy, never JAX. Entry points run on the GPU
unless the caller passes ``device="cpu"``; on the CPU each kernel's plain
PyTorch version runs instead. The image front-end (the XFeat CNN,
``detect_and_compute``) feeds the same loop through ``run_sequence_images``.
The CLI is ``python -m msckf_tpu_torch.runner`` (synthetic, rendered,
TartanAir- and PeringLab-format sources; ``data/imageio.py`` reads PNG
rasters without OpenCV); ``filter/streamed.py`` streams sequences longer
than device memory and ``utils/checkpoint.py`` saves and restores a state.
The XFeat front-end trains on the self-supervised pairs of
``models/selfsup.py`` (``python -m msckf_tpu_torch.models.train_xfeat``)
and is scored on the frozen benchmark of ``models/frontend_eval.py``.
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
from msckf_tpu_torch.filter.propagation import propagate
from msckf_tpu_torch.filter.state import (
    FilterState,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from msckf_tpu_torch.models.frontend import FeatureExtractor
from msckf_tpu_torch.models.frontend_eval import frozen_match_precision
from msckf_tpu_torch.models.selfsup import make_batch
from msckf_tpu_torch.models.train_xfeat import (
    ClippedAdamW,
    PairPool,
    save_npz_params,
    train,
    train_step,
)
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
    "propagate",
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
    "make_batch",
    "PairPool",
    "ClippedAdamW",
    "train_step",
    "train",
    "save_npz_params",
    "frozen_match_precision",
    "fused_frame_step",
    "run_sequence_images",
]
