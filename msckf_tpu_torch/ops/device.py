"""The port's device rule.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Without a GPU, a call that did not ask for the CPU raises: the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def one_cpu_thread(t: torch.Tensor):
    """Run a batched LAPACK call on ``t`` with one intra-op thread when
    ``t`` lies on the CPU; restore the calling thread's count on exit. A
    CUDA tensor never enters the scope.

    With more than one thread, MKL's batched solves at the filter's size
    (float64, n = 207, a batch of 2) print ``Parameter 6 was incorrect on
    entry to DLASWP`` and stall. PyTorch keeps the count per host thread
    (OpenMP's and MKL's thread-local settings), so the scope affects only
    the thread that enters it."""
    if t.device.type != "cpu":
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
