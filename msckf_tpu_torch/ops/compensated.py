"""Double-word (compensated) float32 arithmetic for the EKF correction island
(port of ``msckf_tpu/ops/compensated.py``).

Each high-precision number is an unevaluated pair ``(hi, lo)`` of float32
with ``|lo| <= ulp(hi)/2``: Dekker/Knuth double-word arithmetic, about
2^-48 effective precision from IEEE float32 adds and multiplies.

  * ``two_sum``  — Knuth's exact a + b = s + err (6 flops)
  * ``two_prod`` — Dekker's exact a * b = p + err by 12-bit splitting (no
                   FMA needed)
  * ``df_matmul`` — C = A @ B from exact partial products and a double-word
                    pairwise reduction over K
  * ``ozaki_matmul`` — the same accuracy from exact float32 slice products
  * ``refined_solve`` — a float32 LU solve plus double-word iterative
                        refinement

The card has real float64, so the island is an option there
(``correction_dtype="compensated"``), not a necessity.

Exactness rests on the order of the operations, so every Dekker/Knuth
expression is written one operation a line, as separate eager ops: PyTorch
has no algebraic simplifier, and nothing here is compiled or fused (no
``addcmul``, no ``torch.compile``). Powers of two are built from their
exponent bits (``_exact_pow2``) and exponents read exactly
(``torch.frexp``). Every product is a float32 ``torch.matmul`` with TF32
off (``ops/precision.py``). Every function takes leading batch axes and
runs under ``torch.func.vmap``, and none reads a value on the host.

Three differences from the JAX package, none of which changes the
contract:

* ``df_matmul`` picks its chunk of K from a byte budget (``df_chunk``):
  256 for one filter-sized product, the JAX package's 64 for a batch of
  32 under vmap. The same adds in another order; the larger chunk cuts
  the single loop's host ops by a quarter, the smaller bounds the batched
  loop's memory.

* ``ozaki_matmul`` computes its 21 slice-pair products as one batched
  float32 matmul and sums them by a double-word pairwise tree, where the
  JAX package adds them one by one. Each product is exact either way; the
  sum's rounding stays at the double-word floor.
* ``refined_solve`` solves by the LU for ``solver="ns"`` as well. The JAX
  package's Newton-Schulz preconditioner stands in for an LU that fails
  under vmap on the TPU; ``torch.linalg.lu_factor_ex`` maps under
  ``torch.func.vmap`` with no host read, and the refinement reaches the
  double-word floor from either preconditioner.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msckf_tpu_torch.ops.device import one_cpu_thread
from msckf_tpu_torch.ops.precision import with_f32_matmuls

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for the 24-bit f32 mantissa


class DF(NamedTuple):
    """A double-word float: value = hi + lo (unevaluated sum)."""

    hi: torch.Tensor
    lo: torch.Tensor


def df_from(x) -> DF:
    x = torch.as_tensor(x, dtype=torch.float32)
    return DF(x, torch.zeros_like(x))


def two_sum(a, b) -> DF:
    """Exact a + b = s + err (Knuth; no magnitude ordering required)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return DF(s, err)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> DF:
    """Exact a * b = p + err (Dekker splitting)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return DF(p, err)


def df_add(x: DF, y: DF) -> DF:
    """Double-word + double-word (Dekker add, ~11 flops)."""
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    lo = s.lo + t.hi
    r = two_sum(s.hi, lo)
    lo2 = r.lo + t.lo
    return two_sum(r.hi, lo2)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_scale(x: DF, s) -> DF:
    """Double-word * float32 tensor ``s`` (elementwise; a Python float would
    be multiplied in double precision by ``_split``, so pass a tensor)."""
    p = two_prod(x.hi, s)
    return two_sum(p.hi, p.lo + x.lo * s)


def df_round(x: DF) -> torch.Tensor:
    return x.hi + x.lo


def _tree_reduce_df(hi, lo, dim):
    """Sum a DF tensor along ``dim`` (a power-of-2 length; see _pad_pow2)
    with pairwise double-word adds."""
    n = hi.shape[dim]
    assert n & (n - 1) == 0, "tree reduction needs a power-of-2 axis"
    while n > 1:
        half = n // 2
        s = df_add(DF(hi.narrow(dim, 0, half), lo.narrow(dim, 0, half)),
                   DF(hi.narrow(dim, half, half), lo.narrow(dim, half, half)))
        hi, lo = s.hi, s.lo
        n = half
    return DF(hi.squeeze(dim), lo.squeeze(dim))


def _pad_pow2(x, dim):
    """Zero-pad ``dim`` up to a power of two."""
    n = x.shape[dim]
    p = 1 << (n - 1).bit_length()
    if p == n:
        return x
    shape = list(x.shape)
    shape[dim] = p - n
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


# the bytes of the (..., n, chunk, m) partial products that df_matmul holds
# at a time: a chunk of 256 for one product at D = 207 (44 MB), 64, the JAX
# package's, for a batch of 32 of them under vmap (350 MB)
DF_CHUNK_BYTES = 64 << 20


def df_chunk(A, B, lo: int = 64, hi: int = 256) -> int:
    """The largest power-of-2 chunk in [lo, hi] whose partial products of
    A @ B, batch axes included, fit in DF_CHUNK_BYTES. A larger chunk is
    fewer ops on the host (the single loop is bound by them), a smaller one
    less device memory (the batched loop's peak grows with it)."""
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2]).numel()
    row = batch * A.shape[-2] * B.shape[-1] * 4
    chunk = hi
    while chunk > lo and row * chunk > DF_CHUNK_BYTES:
        chunk //= 2
    return chunk


def df_matmul(A, B, A_lo=None, B_lo=None, chunk: int | None = None) -> DF:
    """C = A @ B with double-word accumulation.

    A: (..., n, k) float32, B: (..., k, m); optional low words ``A_lo`` /
    ``B_lo`` make either operand a double-word matrix (the A_lo * B_lo
    cross term at 2^-48 relative is dropped). Partial products are exact
    (``two_prod``); the K-reduction is a pairwise double-word tree over
    chunks of ``chunk``, which bounds the materialized (..., n, chunk, m)
    intermediate. By default ``df_chunk`` picks it from the shapes, the
    batch of a ``torch.func.vmap`` included (``msckf::df_matmul``'s vmap
    rule calls it with the batch as a leading axis)."""
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    if chunk is None:
        return DF(*_df_matmul_op(A, B, A_lo, B_lo))
    return _df_matmul_chunks(A, B, A_lo, B_lo, chunk)


def _df_matmul_chunks(A, B, A_lo, B_lo, chunk: int) -> DF:
    k = A.shape[-1]
    acc = None
    for k0 in range(0, k, chunk):
        k1 = min(k0 + chunk, k)
        Ac = A[..., :, k0:k1, None]  # (..., n, kc, 1)
        Bc = B[..., None, k0:k1, :]  # (..., 1, kc, m)
        p = two_prod(Ac, Bc)  # (..., n, kc, m) exact partial products
        hi, lo = p.hi, p.lo
        # low-word contributions sit at ~2^-24 |A B|; their own rounding is
        # at 2^-48, so plain float32 products suffice
        if A_lo is not None:
            lo = lo + A_lo[..., :, k0:k1, None] * Bc
        if B_lo is not None:
            lo = lo + Ac * B_lo[..., None, k0:k1, :]
        s = _tree_reduce_df(_pad_pow2(hi, -2), _pad_pow2(lo, -2), dim=-2)
        acc = s if acc is None else df_add(acc, s)
    return acc


@torch.library.custom_op("msckf::df_matmul", mutates_args=())
def _df_matmul_op(A: torch.Tensor, B: torch.Tensor, A_lo: torch.Tensor | None,
                  B_lo: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """df_matmul at the chunk ``df_chunk`` picks; a custom op so that its
    vmap rule sees the batch."""
    r = _df_matmul_chunks(A, B, A_lo, B_lo, df_chunk(A, B))
    return r.hi, r.lo


@_df_matmul_op.register_vmap
def _df_matmul_vmap(info, in_dims, A, B, A_lo, B_lo):
    def lead(x, d):  # the batch as a leading axis; an unbatched operand broadcasts
        if x is None:
            return None
        return x.unsqueeze(0) if d is None else x.movedim(d, 0)

    return _df_matmul_op(*map(lead, (A, B, A_lo, B_lo), in_dims)), (0, 0)


def df_matvec(A, x, A_lo=None) -> DF:
    """A @ x with double-word accumulation (x: (..., k))."""
    r = df_matmul(A, x[..., :, None], A_lo=A_lo)
    return DF(r.hi[..., 0], r.lo[..., 0])


# --- Ozaki-scheme matmul: double-word accuracy from exact float32 products --
#
# Slice each operand into 8-bit-significand pieces on a fixed per-row
# (per-column for B) power-of-2 grid, so that every pairwise slice product
# is exactly representable (8 x 8 -> 16 significant bits) and the float32
# accumulation over K <= 256 is exact (16 + 8 <= 24 bits on a shared
# exponent grid), in whatever order the matmul sums. The exact term
# matrices are then combined with double-word adds: O(n m) work on top of
# the products instead of df_matmul's O(n k m).


@torch.library.custom_op("msckf::exact_pow2", mutates_args=())
def _exact_pow2_bits(e: torch.Tensor) -> torch.Tensor:
    """2^e for int32 e, built from the exponent bits of two normal floats,
    whose product is 2^e exactly wherever 2^e is a float32 (subnormals
    included) and inf or 0 beyond, as ``ldexp`` gives. A custom op so that
    vmap maps it elementwise (not every PyTorch release batches the
    reinterpreting ``view(torch.float32)``)."""
    e1 = torch.clamp(e, -126, 127)
    e2 = torch.clamp(e - e1, -126, 127)
    p1 = torch.bitwise_left_shift(e1 + 127, 23).view(torch.float32)
    p2 = torch.bitwise_left_shift(e2 + 127, 23).view(torch.float32)
    return p1 * p2


@_exact_pow2_bits.register_vmap
def _exact_pow2_vmap(info, in_dims, e):
    return _exact_pow2_bits(e), in_dims[0]


def _exact_pow2(e):
    """2^e for integer-valued e (an integer or float tensor), exact."""
    return _exact_pow2_bits(e.to(torch.int32))


@torch.library.custom_op("msckf::floor_log2", mutates_args=())
def _floor_log2(m: torch.Tensor) -> torch.Tensor:
    """floor(log2(m)) of positive finite floats as int32, exact (frexp's
    exponent less one), where ``log2`` rounds and can cross a power of
    two. A custom op so that vmap maps it elementwise."""
    return torch.frexp(m).exponent - 1


@_floor_log2.register_vmap
def _floor_log2_vmap(info, in_dims, m):
    return _floor_log2(m), in_dims[0]


def _pow2_axis_scale(x, dim):
    """Power-of-2 scale S with |x|/S < 2 along ``dim`` (exact to divide by)."""
    m = torch.amax(torch.abs(x), dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m) & (m > 0), m, torch.ones_like(m))
    return _exact_pow2(_floor_log2(m))


def _slices8(xn, lo=None, levels=6):
    """Split |xn| <= 2 into ``levels`` slices of 8 significant bits on the
    fixed grid step_l = 2^(-6-8l) (each slice exactly bf16-representable);
    ``lo`` (an optional low word at ~2^-24) joins the residual after the
    slices above its magnitude are extracted. Residual after all levels is
    < 2^(-6-8*levels)."""
    out = []
    r = xn
    r2 = lo  # the low word's residual, carried separately: folding it into
    #          r with one float32 add would round at ~2^-47
    for l in range(levels):
        # 1.5 * 2^23 * step_l: r + c stays inside one binade for |r| <=
        # 2^22 * step, so the rounding grid is exactly step_l
        c = 1.5 * 2.0 ** (17 - 8 * l)
        t = r + c
        s = t - c  # round to the step_l grid: two ops, never (r + c) - c -> r
        r = r - s  # exact: s agrees with r to within step_l / 2
        if r2 is not None and l >= 2:
            # |lo| <= 2^-23-ish: from level 2 on its slices share the grid;
            # s + s2 is an exact multiple of step_l with |.| <= 256 * step
            t2 = r2 + c
            s2 = t2 - c
            r2 = r2 - s2
            s = s + s2
        out.append(s)
    return out


@with_f32_matmuls
def ozaki_matmul(A, B, A_lo=None, B_lo=None, s_max: int = 5, levels: int = 6) -> DF:
    """C = A @ B with double-word accuracy from exact float32 slice products.

    Same contract as :func:`df_matmul` (optional low words make an operand
    double-word): the slice pairs with levels i + j <= ``s_max`` are each
    one exact float32 product, summed in double-word. Worst-case dropped-term
    error ~K * 2^(2-8(s_max+1)) relative to rowmax(A) * colmax(B). Requires
    K <= 256 for exact accumulation (the filter's D = 207 qualifies); a
    larger K raises."""
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    k = A.shape[-1]
    if k > 256:
        raise ValueError(f"ozaki_matmul needs K <= 256 for exactness, got {k}")
    # inner-dimension balancing: the slicing grid truncates each operand at
    # 2^-54 of its rowmax (A) / colmax (B), so a power-of-2 g_k equalizing
    # |A[:, k]| g_k ~ |B[k, :]| / g_k makes the error relative to the
    # dominant partial product on scale-heterogeneous K axes. Exact.
    cA = torch.amax(torch.abs(A), dim=-2)
    rB = torch.amax(torch.abs(B), dim=-1)
    ok = torch.isfinite(cA) & torch.isfinite(rB) & (cA > 0) & (rB > 0)
    one = torch.ones_like(cA)
    half_log = 0.5 * (torch.log2(torch.where(ok, rB, one)) - torch.log2(torch.where(ok, cA, one)))
    g = torch.where(ok, _exact_pow2(torch.round(half_log)), one)
    # ~ok lanes contribute exactly zero to the product, but their other
    # operand's magnitude would still set SA / SB and so the slicing grid
    # (an information matrix's zero IMU-head columns against a 1e18-scale
    # covariance); masking both sides keeps the product and frees the grid
    okA = ok[..., None, :]
    okB = ok[..., :, None]
    A = torch.where(okA, A * g[..., None, :], 0.0)
    B = torch.where(okB, B / g[..., :, None], 0.0)
    SA = _pow2_axis_scale(A, dim=-1)  # (..., n, 1)
    SB = _pow2_axis_scale(B, dim=-2)  # (..., 1, m)
    An = A / SA
    Bn = B / SB
    sA = _slices8(An, None if A_lo is None else torch.where(
        okA, (A_lo * g[..., None, :]) / SA, 0.0), levels)
    sB = _slices8(Bn, None if B_lo is None else torch.where(
        okB, (B_lo / g[..., :, None]) / SB, 0.0), levels)
    pairs = [(i, s - i) for s in range(s_max + 1) for i in range(min(s + 1, levels))
             if s - i < levels]
    # one batched product of every slice pair: each term exact in float32
    terms = torch.stack([sA[i] for i, _ in pairs]) @ torch.stack([sB[j] for _, j in pairs])
    terms = _pad_pow2(terms, 0)
    acc = _tree_reduce_df(terms, torch.zeros_like(terms), dim=0)
    scale = SA * SB
    return DF(acc.hi * scale, acc.lo * scale)


def _pow2_equilibration(M):
    """Row/column scales for diag(r) M diag(c), rounded to exact powers of 2
    (power-of-2 scaling is exact in float32: only the exponent changes)."""

    def scale_of(v):
        v = torch.where(torch.isfinite(v) & (v > 0), v, torch.ones_like(v))
        return _exact_pow2(-torch.round(torch.log2(v)))

    r = scale_of(torch.amax(torch.abs(M), dim=-1))
    c = scale_of(torch.amax(torch.abs(M * r[..., :, None]), dim=-2))
    return r, c


@with_f32_matmuls
def refined_solve(B: DF, C, iters: int = 3, solver: str = "lu") -> DF:
    """Solve B X = C for X with double-word forward accuracy.

    B is a double-word (..., n, n) matrix, C a float32 (..., n, m)
    right-hand side. Power-of-2 row/column equilibration (exact; it removes
    the scale-heterogeneity conditioning of filter covariances), a float32
    approximate solve of the scaled matrix, and ``iters`` refinement steps
    with double-word residuals: X_{j+1} = X_j + B^{-1}(C - B X_j). The
    converged forward error is O(cond * 2^-48).

    ``solver`` ("lu" or "ns") is taken for parity with the JAX package,
    whose "ns" preconditions with a Newton-Schulz inverse for the batched
    loop; here both factor the scaled matrix once
    (``torch.linalg.lu_factor_ex``, no error check, so no host read), which
    maps under ``torch.func.vmap``.

    Returns X as a DF pair (hi = the refined float32 solution, lo = the
    running sub-ulp tail).
    """
    r, cs = _pow2_equilibration(B.hi)
    Bs = (B.hi * r[..., :, None]) * cs[..., None, :]
    with one_cpu_thread(Bs):
        LU, piv, _ = torch.linalg.lu_factor_ex(Bs)

    def scaled_solve(rhs):
        with one_cpu_thread(LU):
            X = torch.linalg.lu_solve(LU, piv, r[..., :, None] * rhs)
        return cs[..., :, None] * X

    X = scaled_solve(C)
    lo = torch.zeros_like(X)
    # Monotonic safeguard: refinement contracts only while
    # ||I - Bs M^{-1}|| < 1, roughly cond(Bs) < 1/eps_f32. Past that each
    # step multiplies the error, so every iterate's residual is measured and
    # the newest iterate is taken unless its residual exceeds 4x the best
    # seen: convergent runs take the final iterate, divergence freezes the
    # selection at the last healthy one. NaN residuals compare False. The
    # selection is a select over (..., 1, 1): no value is read on the host.
    best_rn = torch.full(X.shape[:-2] + (1, 1), float("inf"), dtype=X.dtype, device=X.device)
    best_X, best_lo = X, lo
    for it in range(iters + 1):
        # Ozaki residuals, but one exact df_matmul residual for the last
        # refinement step: the converged error is set by the last
        # residual's accuracy. Iteration ``iters`` computes a residual only,
        # for the selection of the final iterate.
        if it == iters - 1:
            BX = df_matmul(B.hi, X, A_lo=B.lo)
        else:
            BX = ozaki_matmul(B.hi, X, A_lo=B.lo)
        # the B.hi @ lo tail of the full product B (X + lo)
        tail = B.hi @ lo
        BX = df_add(BX, DF(tail, torch.zeros_like(X)))
        res = df_add(df_from(C), df_neg(BX))  # C - B X, C exact
        # the selection residual in the equilibrated row frame
        rn = torch.amax(torch.abs(r[..., :, None] * res.hi), dim=(-2, -1), keepdim=True)
        take = rn <= 4.0 * best_rn
        best_rn = torch.where(rn < best_rn, rn, best_rn)
        best_X = torch.where(take, X, best_X)
        best_lo = torch.where(take, lo, best_lo)
        if it == iters:
            break
        dX = scaled_solve(res.hi + res.lo)
        # X <- X + dX, keeping the sub-ulp tail
        s = two_sum(X, dX + lo)
        X, lo = s.hi, s.lo
    return DF(best_X, best_lo)
