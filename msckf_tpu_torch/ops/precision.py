"""Matmul precision control: the port's counterpart of ``with_f32_matmuls``.

The filter's covariance algebra (Joseph updates, third-order Phi chains,
information-form gains) needs full float32 products. On the GPU, PyTorch may
route float32 matrix products and convolutions through TF32 tensor cores,
which keep about three decimal digits. The one-hot products that gather
camera poses (``filter/tracks.py::gather_cam_poses``) are exact only in full
float32. Every public filter entry point therefore runs under
:func:`with_f32_matmuls`, which turns TF32 off and checks that it stayed off.
"""

from __future__ import annotations

import functools

import torch


def set_f32_matmuls() -> None:
    """Turn TF32 off for matmuls and cuDNN, and assert that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def with_f32_matmuls(fn):
    """Decorator: run ``fn`` with full-precision float32 matmuls."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        set_f32_matmuls()
        return fn(*args, **kwargs)

    return wrapped
