"""The port's device rule.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a GPU, a call that did not ask for the CPU raises: the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "msckf_tpu_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def check_on_device(t: torch.Tensor, device: torch.device, what: str) -> None:
    if t.device.type != device.type:
        raise ValueError(f"{what} lives on {t.device}, expected {device}")
