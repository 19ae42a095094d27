"""The least time each of the program's six kernel computations can take on
one H100, from the shapes alone: the operations it needs and the bytes of
its inputs read once and its outputs written once, against NVIDIA's
published peaks of the H100 SXM (dense, no sparsity, 700 W).

The operation counts are those of the computations as the kernels' sources
state them (one multiply-add is two operations); they do not depend on
which code carries the computation out. ``B`` is the number of sequences
one batched call covers.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12  # HBM3, bytes/s
# outside the tensor cores; for matrix-product work float64 also runs on
# the tensor cores (DMMA) at 67 TFLOP/s, while float32 there would be TF32
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_FLOPS_MATMUL = {"float32": 67e12, "float64": 67e12}

VERIFICATION_FLOPS_PER_PAIR = 452
P15_FLOPS_PER_TICK = 3 * 2 * 15**3 + 3 * 15 * 15  # three 15^3 products, + Qd, symmetrize
PROPAGATE_FLOPS_PER_TICK = 44_625
TRIAGE_FLOPS_PER_OBS = 50  # norm 6, 3 divisions, X 24, b.d 5, y 12
TRIAGE_FLOPS_PER_TRACK = 122  # the 3x3 solve, the anchor frame, projection, refresh

KERNELS = ("batched_gating_gamma", "verification_scores", "p15_recurrence_fused",
           "propagate_block_fused", "triage_refresh_fused", "update_terms_fused")


def update_terms_flops(U: int, R2: int, D: int) -> float:
    """One update-terms call: per track the Gram and Hf^T r sums, Hf^T H,
    C = W Hf^T H, H~ = H - Hf C, H~ P, the symmetric S (R2 (R2 + 1) / 2 dot
    products of length D) and the Cholesky with its substitution; then the
    symmetric A (D (D + 1) / 2 dot products over all U * R2 rows) and c."""
    per_track = (9 * 2 * R2 + 3 * 2 * R2 * D + 15 * D + 6 * R2 * D
                 + 2 * R2 * D * D + D * R2 * (R2 + 1) + R2**3 / 3 + 2 * R2**2)
    return U * per_track + U * R2 * D * (D + 1) + 2 * U * R2 * D


def bound_ms(nbytes: float, flops: float, dtype: str, peaks=PEAK_FLOPS):
    """(least ms, "bytes" or "operations": which of the two bounds it)."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / peaks[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def work(name: str, dims, dtype: str):
    """(bytes, operations, peaks) of one call on one sequence."""
    sz = 4 if dtype == "float32" else 8
    peaks = PEAK_FLOPS
    if name == "batched_gating_gamma":
        # the recurrence reads S's upper triangle only
        U, n = dims
        nbytes = U * (n * (n + 1) // 2 + n + 1) * sz
        flops = U * (n**3 / 3 + n**2 + 2 * n)
    elif name == "verification_scores":
        F, M = dims
        nbytes = (F * M * (9 + 3 + 2 + 3) + F * 2 + 30) * sz
        flops = F * M * VERIFICATION_FLOPS_PER_PAIR
    elif name == "p15_recurrence_fused":
        (nt,) = dims
        nbytes, flops = (225 + 2 * nt * 225 + 2 * 225 + 6 * nt) * sz, nt * P15_FLOPS_PER_TICK
    elif name == "propagate_block_fused":
        (nt,) = dims
        nbytes = ((9 + 4 * 3 + 1 + 12 + 3 + 225) + nt * 7) * sz + nt + 8 \
            + ((9 + 3 + 3 + 1 + 225 + 225) + nt * 21) * sz + 8
        flops = nt * PROPAGATE_FLOPS_PER_TICK
    elif name == "triage_refresh_fused":
        F, M = dims
        nbytes = (F * M * 7 + F * 12 + 18 + F * 4) * sz + F
        flops = F * M * TRIAGE_FLOPS_PER_OBS + F * TRIAGE_FLOPS_PER_TRACK
    elif name == "update_terms_fused":
        U, n2, D = dims
        nbytes = (U * n2 * (D + 4) + 2 * D * D + D + U) * sz + 2 * U
        flops, peaks = update_terms_flops(U, n2, D), PEAK_FLOPS_MATMUL
    else:
        raise KeyError(f"no kernel computation {name!r}")
    return nbytes, flops, peaks


def kernel_bound(name: str, dims, dtype: str, B: int = 1):
    """(least ms, what bounds it) of one call over B sequences."""
    nbytes, flops, peaks = work(name, dims, dtype)
    return bound_ms(B * nbytes, B * flops, dtype, peaks)


def call_dims(name: str, filt: dict, block_ticks: int):
    """The shapes one call of ``name`` takes on the filter's main path with
    the configuration's capacities (``filt``: its ``filter`` group) and
    camera-frame blocks of ``block_ticks`` IMU ticks."""
    F, M, U, N = filt["f_max"], filt["m_max"], filt["u_max"], filt["n_cam_slots"]
    return {
        "batched_gating_gamma": (U, 2 * M),
        "verification_scores": (F, M),
        "p15_recurrence_fused": (block_ticks - 1,),
        "propagate_block_fused": (1,),
        "triage_refresh_fused": (F, M),
        "update_terms_fused": (U, 2 * M, 6 * N),
    }[name]
