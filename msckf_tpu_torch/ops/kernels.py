"""The port's six hand-written CUDA kernels: wrappers, plain versions, build.

Each TPU kernel of the JAX package (``msckf_tpu/ops/pallas_kernels.py``)
has here

* a wrapper with the JAX package's public name, a ``torch.library`` custom
  op (namespace ``msckf``), which checks its inputs, allocates the outputs
  with ``torch.empty``, launches the CUDA kernel from
  ``msckf_tpu_torch/csrc/`` on PyTorch's current stream, raises if the launch
  returns an error, and adds one to its launch count;
* the op's vmap rule, the batched form: under ``torch.func.vmap`` it
  launches the same kernel once over a leading axis of B sequences;
* a plain PyTorch version (``*_plain``) that repeats the kernel's
  arithmetic and takes any leading batch axes.

A wrapper checks its inputs on either device and takes the plain version
only for tensors that lie on the CPU (the tests, and the CPU path of the
filter). For CUDA tensors it launches the kernel or raises; there is no
fallback.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library under ``msckf_tpu_torch/build/`` (one ``nvcc -c`` per source,
all started together, then one link) and bound through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("gating.cu", "verification.cu", "p15_recurrence.cu", "propagate_block.cu",
           "triage.cu", "update_terms.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The verification and triage kernels are built without multiply-add
# contraction, so they round each product and sum as their plain versions
# do and agree with them bitwise: their threshold decisions then cannot
# differ between the two.
EXTRA_FLAGS = {"verification.cu": ("--fmad=false",), "triage.cu": ("--fmad=false",)}

# launches of each kernel, counted by its wrapper where it launches
LAUNCHES = {
    "batched_gating_gamma": 0,
    "verification_scores": 0,
    "p15_recurrence_fused": 0,
    "propagate_block_fused": 0,
    "triage_refresh_fused": 0,
    "update_terms_fused": 0,
}


_LAUNCHES_LOCK = threading.Lock()


def _count(name: str) -> None:
    # host threads may launch at once (parallel/batched.py::shardmap_run_sequence)
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_tag() -> str:
    h = hashlib.sha256(repr((NVCC_FLAGS, sorted(EXTRA_FLAGS.items()))).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:12]


def build_kernels() -> Path:
    """Compile the kernel sources into one shared library (cached by the
    sources' hash) and return its path. Raises on any compiler error."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libmsckf_kernels_{_source_tag()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(src, ()), "-c", str(CSRC_DIR / src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = [], []
    for src, p in zip(SOURCES, procs):
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # S, r, gamma, scratch (or None), U, n, stream (a batch of sequences
    # flattens into U)
    "msckf_gating": (_P, _P, _P, _P, _I, _I, _P),
    # R1, t1, kp1, kp2, camR, camt, K, Kinv, their strides a sequence (0 where
    # shared), homo, epi, base, F, M, B, threads a block, stream
    "msckf_verification": (_P,) * 8 + (_I,) * 4 + (_P,) * 3 + (_I,) * 4 + (_P,),
    # P0, Phi, Qd, P, Phi_acc, sig, nt, B, ticks per chunk, shared bytes, stream
    "msckf_p15_recurrence": (_P,) * 6 + (_I,) * 4 + (_P,),
    # R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid, qc, g,
    # P15, | R, p, v, last_ts, prop_count, P15, Phi_acc, outR, outp, outv,
    # outsig, qc's and g's strides a sequence (0 where shared), nt, B, stream
    "msckf_propagate_block": (_P,) * 25 + (_I,) * 4 + (_P,),
    # base, dir, w, Ra, ta, K, Kinv, eps, width, height, m, rho, ok, F, M, B,
    # tracks per block, tracks and observations per pass, threads, shared
    # bytes, stream
    "msckf_triage": (_P,) * 7 + (_D, _D, _D) + (_P,) * 3 + (_I,) * 8 + (_P,),
    # H, Hf, r, P, crit, sel_ok, | Ht, rt, Ss, gate scratch (or None), Apart,
    # cpart (scratch), A, c, passed, U, 2M, D, B, tracks per chunk, sigma2,
    # eps, stream
    "msckf_update_terms": (_P,) * 15 + (_I,) * 5 + (_D, _D, _P),
    # a query, no stream: the gate's global scratch per system of n rows (0
    # where it works in shared memory)
    "msckf_gate_scratch": (_I,),
}


_LIBRARY: list[ctypes.CDLL] = []
_LIBRARY_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    """The kernel library, built and loaded by the first caller; threads
    that launch at once (``shardmap_run_sequence``) wait for that one."""
    with _LIBRARY_LOCK:
        if not _LIBRARY:
            lib = ctypes.CDLL(str(build_kernels()))
            for name, args in _SIGNATURES.items():
                for suffix in ("_f32", "_f64"):
                    fn = getattr(lib, name + suffix)
                    fn.argtypes = list(args)
                    fn.restype = ctypes.c_int
            _LIBRARY.append(lib)
        return _LIBRARY[0]


def _launch(name: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Launch on ``device``, the tensors' device, on its current stream:
    the CUDA calls act on the current device, which a shard on another card
    is not."""
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    fn = getattr(_library(), name + suffix)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}{suffix} launch failed: cudaError {err}")


def _query(name: str, dtype: torch.dtype, device: torch.device, *args) -> int:
    """A query of the kernel library about ``device`` (no launch); raises
    on a negative (failed) answer."""
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    with torch.cuda.device(device):
        out = getattr(_library(), name + suffix)(*args)
    if out < 0:
        raise RuntimeError(f"{name}{suffix} failed: cudaError {-out}")
    return out


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _float_dtype(t: torch.Tensor) -> torch.dtype:
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {t.dtype}")
    return t.dtype


# --------------------------------------------------------------------------
# custom ops and their vmap rules
# --------------------------------------------------------------------------
# A ctypes launch is invisible to torch.func: under vmap a plain wrapper
# would see batched tensors it cannot launch on. So every wrapper is a
# torch.library custom op (namespace "msckf"), and its vmap rule, the
# counterpart of the JAX custom_vmap rule, launches ONE batched kernel for
# the whole batch (never one per sequence) or, on the CPU, runs the plain
# version over the batch axis. Each launcher takes its tensors with a
# leading axis of B sequences; a single call is B = 1.


def _batch_first(info, in_dims, *args):
    """Every tensor argument with the batch axis first and contiguous; an
    unbatched one broadcast to the batch, as the JAX package's
    ``_broadcast_unbatched`` (pallas_kernels.py:57-64) does."""
    out = []
    for x, d in zip(args, in_dims):
        if isinstance(x, torch.Tensor):
            x = x.expand(info.batch_size, *x.shape) if d is None else x.movedim(d, 0)
            x = x.contiguous()
        out.append(x)
    return out


def _shared_or_batch_first(in_dims, *args):
    """Constants that the sequences may share: an unmapped one stays as it
    is (its kernel reads it with stride 0), a mapped one gets the batch axis
    first; both contiguous."""
    return [x.contiguous() if d is None else x.movedim(d, 0).contiguous()
            for x, d in zip(args, in_dims)]


def _single_call(launch, check, plain, tensors, scalars=()):
    """One call: the plain version for CPU tensors, else the launcher at
    B = 1."""
    one = [x[None] for x in tensors]
    if tensors[0].device.type == "cpu":
        check(*one)
        return plain(*tensors, *scalars)
    return tuple(o[0] for o in launch(*one, *scalars))


def _batched_call(launch, check, plain, info, in_dims, args, n_tensors):
    """The vmap rule's body: one batched launch, or on the CPU the plain
    version over the batch axis."""
    args = _batch_first(info, in_dims, *args)
    if args[0].device.type == "cpu":
        check(*args[:n_tensors])
        out = plain(*args)
    else:
        out = launch(*args)
    return tuple(out), (0,) * len(out)


# --------------------------------------------------------------------------
# 1. chi-square gating statistic (replaces batched_gating_gamma,
#    msckf_tpu/ops/pallas_kernels.py:276 -> _gating_kernel_blocked :103)
# --------------------------------------------------------------------------

GATING_NB = 8


def batched_gating_gamma_plain(S: torch.Tensor, r: torch.Tensor, nb: int = GATING_NB):
    """gamma_u = r_u^T S_u^{-1} r_u by right-looking Cholesky in panels of
    ``nb`` columns with the forward substitution fused in. The pivot column
    is read as the pivot ROW (the TPU kernel's choice); a non-positive pivot
    makes gamma non-finite, which fails the gate."""
    U, n, _ = S.shape
    A = S
    rr = r
    row = torch.arange(n, device=S.device)[None, :]
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    gamma = torch.zeros(U, dtype=S.dtype, device=S.device)
    for k0 in range(0, n, nb):
        w = min(nb, n - k0)
        panel = []
        for j in range(w):
            jj = k0 + j
            rowj = A[:, jj, :]
            for k in range(j):
                rowj = rowj - panel[k] * panel[k][:, jj][:, None]
            inv_sqrt_d = torch.rsqrt(rowj[:, jj])
            lcol = torch.where(row >= jj, rowj * inv_sqrt_d[:, None], zero)
            panel.append(lcol)
            yj = rr[:, jj] * inv_sqrt_d
            rr = rr - torch.where(row > jj, lcol, zero) * yj[:, None]
            gamma = gamma + yj * yj
        upd = panel[0][:, :, None] * panel[0][:, None, :]
        for j in range(1, w):
            upd = upd + panel[j][:, :, None] * panel[j][:, None, :]
        A = A - upd
    return gamma


@functools.lru_cache(maxsize=None)
def gate_scratch_elems(dtype: torch.dtype, n: int, device: torch.device) -> int:
    """Elements of the gate's global scratch per system of n rows on the
    device: 0 where a system's working set fits in shared memory (the
    kernel library's own answer, asked once per device, dtype and n)."""
    return _query("msckf_gate_scratch", dtype, device, n)


def gate_scratch(nsys: int, n: int, dtype: torch.dtype, device) -> torch.Tensor | None:
    """The gate's global scratch for nsys systems of n rows: None where a
    system's working set fits in shared memory, else nsys working sets."""
    per = gate_scratch_elems(dtype, n, torch.device(device))
    return torch.empty(nsys * per, dtype=dtype, device=device) if per else None


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _gating(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    dt = _float_dtype(S)
    U, n = S.shape[0], S.shape[-1]
    _check(S, "S", (U, n, n), dt, S.device)
    _check(r, "r", (U, n), dt, S.device)
    if S.device.type == "cpu":
        return batched_gating_gamma_plain(S, r)
    if U * n == 0:
        return torch.zeros(U, dtype=dt, device=S.device)
    gamma = torch.empty(U, dtype=dt, device=S.device)
    scratch = gate_scratch(U, n, dt, S.device)
    _launch("msckf_gating", dt, S.device, S.data_ptr(), r.data_ptr(), gamma.data_ptr(), _ptr(scratch),
            U, n)
    _count("batched_gating_gamma")
    return gamma


@torch.library.custom_op("msckf::batched_gating_gamma", mutates_args=())
def batched_gating_gamma(S: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """S: (U, n, n) SPD systems (sigma^2-regularized), r: (U, n) -> (U,)."""
    return _gating(S, r)


@batched_gating_gamma.register_vmap
def _gating_vmap(info, in_dims, S, r):
    """B sequences of U systems: one launch over the B * U systems, as the
    JAX rule flattens them (pallas_kernels.py:264-271)."""
    S, r = _batch_first(info, in_dims, S, r)
    B, U, n = S.shape[0], S.shape[1], S.shape[-1]
    _check(S, "S", (B, U, n, n), _float_dtype(S), S.device)
    return _gating(S.reshape(B * U, n, n), r.reshape(B * U, n)).reshape(B, U), 0


# --------------------------------------------------------------------------
# 2. verification scores (replaces verification_scores,
#    msckf_tpu/ops/pallas_kernels.py:752 -> _verification_kernel :626)
# --------------------------------------------------------------------------


def _mm_pp_sc(Ap, B, transpose_a=False):
    """plane-matrix @ scalar-matrix (row-major lists of 9)."""
    out = []
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                a = Ap[k * 3 + i] if transpose_a else Ap[i * 3 + k]
                term = a * B[k][j]
                acc = term if acc is None else acc + term
            out.append(acc)
    return out


def _mm_sc_pp(A, Bp):
    out = []
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = Bp[k * 3 + j] * A[i][k]
                acc = term if acc is None else acc + term
            out.append(acc)
    return out


def _mm_pp_pp(Ap, Bp):
    out = []
    for i in range(3):
        for j in range(3):
            acc = None
            for k in range(3):
                term = Ap[i * 3 + k] * Bp[k * 3 + j]
                acc = term if acc is None else acc + term
            out.append(acc)
    return out


def _mv_pp(Ap, x):
    return [Ap[i * 3 + 0] * x[0] + Ap[i * 3 + 1] * x[1] + Ap[i * 3 + 2] * x[2]
            for i in range(3)]


def verification_scores_plain(R1, t1, kp1, kp2, camR, camt, K, Kinv):
    """(homography symmetric transfer error, signed epipolar residual,
    baseline) per (track, observation) pair, element by element as the TPU
    kernel computes them, with its 1e-30 guard on the projected z. Takes
    any leading batch axes (camR, camt, K and Kinv with the same ones)."""
    R1p = [R1[..., i, j] for i in range(3) for j in range(3)]
    t1p = [t1[..., i] for i in range(3)]
    kp1x, kp1y = kp1[..., 0], kp1[..., 1]
    kp2x = kp2[..., :, None, 0].expand(kp1x.shape)
    kp2y = kp2[..., :, None, 1].expand(kp1x.shape)
    # the per-call constants, broadcast over the (F, M) pairs
    cR = [[camR[..., i, j, None, None] for j in range(3)] for i in range(3)]
    ct = [camt[..., i, None, None] for i in range(3)]
    Ks = [[K[..., i, j, None, None] for j in range(3)] for i in range(3)]
    Ki = [[Kinv[..., i, j, None, None] for j in range(3)] for i in range(3)]
    KiT = [[Ki[j][i] for j in range(3)] for i in range(3)]
    one = torch.ones_like(kp1x)
    tiny = torch.full_like(kp1x, 1e-30)

    R12 = _mm_pp_sc(R1p, cR, transpose_a=True)
    d = [ct[i] - t1p[i] for i in range(3)]
    t12 = [R1p[0 * 3 + i] * d[0] + R1p[1 * 3 + i] * d[1] + R1p[2 * 3 + i] * d[2]
           for i in range(3)]
    base = torch.sqrt(t12[0] * t12[0] + t12[1] * t12[1] + t12[2] * t12[2])

    H = _mm_pp_sc(_mm_sc_pp(Ks, R12), Ki)
    R12T = [R12[j * 3 + i] for i in range(3) for j in range(3)]
    Hinv = _mm_pp_sc(_mm_sc_pp(Ks, R12T), Ki)
    x2h = [kp2x, kp2y, one]
    x1h = [kp1x, kp1y, one]
    x1p = _mv_pp(Hinv, x2h)
    x2p = _mv_pp(H, x1h)
    z1 = torch.where(x1p[2].abs() < 1e-30, tiny, x1p[2])
    z2 = torch.where(x2p[2].abs() < 1e-30, tiny, x2p[2])
    e1x = kp2x - x1p[0] / z1
    e1y = kp2y - x1p[1] / z1
    e2x = kp1x - x2p[0] / z2
    e2y = kp1y - x2p[1] / z2
    homo = 0.5 * (torch.sqrt(e1x * e1x + e1y * e1y) + torch.sqrt(e2x * e2x + e2y * e2y))

    zero = torch.zeros_like(kp1x)
    skew_t = [zero, -t12[2], t12[1], t12[2], zero, -t12[0], -t12[1], t12[0], zero]
    Fm = _mm_pp_sc(_mm_sc_pp(KiT, _mm_pp_pp(skew_t, R12)), Ki)
    Fx1 = _mv_pp(Fm, x1h)
    epi = x2h[0] * Fx1[0] + x2h[1] * Fx1[1] + x2h[2] * Fx1[2]
    return homo, epi, base


# the per-call constants of the verification kernel and their shapes for one
# sequence
_VERIFY_CONSTS = (("camR", (3, 3)), ("camt", (3,)), ("K", (3, 3)), ("Kinv", (3, 3)))


def _verification_check(R1, t1, kp1, kp2, camR, camt, K, Kinv):
    """The pair arrays with a leading axis of B sequences; each constant
    with the same axis, or without it when the sequences share it."""
    dt = _float_dtype(t1)
    B, F, M = t1.shape[:3]
    dev = t1.device
    for name, x, shape in (
        ("R1", R1, (B, F, M, 3, 3)), ("t1", t1, (B, F, M, 3)), ("kp1", kp1, (B, F, M, 2)),
        ("kp2", kp2, (B, F, 2)),
    ):
        _check(x, name, shape, dt, dev)
    for (name, shape), x in zip(_VERIFY_CONSTS, (camR, camt, K, Kinv)):
        _check(x, name, shape if x.dim() == len(shape) else (B, *shape), dt, dev)
    return dt, B, F, M


def verification_plan(F: int, M: int) -> tuple[int, int]:
    """(threads a block, blocks a sequence) of the verification kernel for
    F x M pairs: one lane a pair, 128 lanes a block, the last block masked;
    a batched launch repeats the grid over its B sequences. The plan decides
    where a pair is computed, never its arithmetic. Raises ValueError for F
    or M < 1."""
    if F < 1 or M < 1:
        raise ValueError(f"verification kernel takes F and M >= 1, got F={F}, M={M}")
    threads = 128
    return threads, -(-F * M // threads)


def _verification_launch(R1, t1, kp1, kp2, camR, camt, K, Kinv):
    dt, B, F, M = _verification_check(R1, t1, kp1, kp2, camR, camt, K, Kinv)
    dev = t1.device
    homo = torch.empty((B, F, M), dtype=dt, device=dev)
    epi = torch.empty_like(homo)
    base = torch.empty_like(homo)
    if B * F * M == 0:
        return homo, epi, base
    consts = (camR, camt, K, Kinv)
    strides = (x.stride(0) if x.dim() > len(shape) else 0
               for (_, shape), x in zip(_VERIFY_CONSTS, consts))
    _launch("msckf_verification", dt, dev, *(t.data_ptr() for t in (R1, t1, kp1, kp2, *consts)),
            *strides, *(t.data_ptr() for t in (homo, epi, base)), F, M, B,
            verification_plan(F, M)[0])
    _count("verification_scores")
    return homo, epi, base


@torch.library.custom_op("msckf::verification_scores", mutates_args=())
def verification_scores(R1: torch.Tensor, t1: torch.Tensor, kp1: torch.Tensor,
                        kp2: torch.Tensor, camR: torch.Tensor, camt: torch.Tensor,
                        K: torch.Tensor, Kinv: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """R1 (F, M, 3, 3), t1 (F, M, 3), kp1 (F, M, 2), kp2 (F, 2), camR (3, 3),
    camt (3,), K and Kinv (3, 3) -> homo, epi, base, each (F, M)."""
    return _single_call(_verification_launch, _verification_check, verification_scores_plain,
                        (R1, t1, kp1, kp2, camR, camt, K, Kinv))


@verification_scores.register_vmap
def _verification_vmap(info, in_dims, *args):
    """One launch for the batch. The pair arrays get the batch axis first; a
    constant that the sequences share (K and K^-1 on the batched loop) stays
    as it is and reaches the kernel with stride 0, not copied B times."""
    pairs = _batch_first(info, in_dims[:4], *args[:4])
    consts = _shared_or_batch_first(in_dims[4:], *args[4:])
    if pairs[0].device.type == "cpu":
        _verification_check(*pairs, *consts)
        out = verification_scores_plain(*pairs, *consts)
    else:
        out = _verification_launch(*pairs, *consts)
    return tuple(out), (0, 0, 0)


# --------------------------------------------------------------------------
# 3. P15 recurrence (replaces p15_recurrence_fused,
#    msckf_tpu/ops/pallas_kernels.py:970 -> _p15_recurrence_kernel :951)
# --------------------------------------------------------------------------


def p15_recurrence_fused_plain(P0, Phi, Qd):
    """Over nt ticks: P <- Phi_i P Phi_i^T + Qd_i, symmetrized;
    Phi_acc <- Phi_i Phi_acc; per-tick diag(P)[0:3] and [12:15]. Takes any
    leading batch axes."""
    P = P0
    Acc = torch.eye(15, dtype=P0.dtype, device=P0.device)
    sig = []
    for i in range(Phi.shape[-3]):
        Ph = Phi[..., i, :, :]
        P = Ph @ P @ Ph.mT + Qd[..., i, :, :]
        P = 0.5 * (P + P.mT)
        Acc = Ph @ Acc
        dg = torch.diagonal(P, dim1=-2, dim2=-1)
        sig.append(torch.cat([dg[..., 0:3], dg[..., 12:15]], dim=-1))
    return P, Acc, torch.stack(sig, dim=-2)


def _p15_check(P0, Phi, Qd):
    dt = _float_dtype(P0)
    B, nt = Phi.shape[:2]
    for name, x, shape in (("P0", P0, (B, 15, 15)), ("Phi", Phi, (B, nt, 15, 15)),
                           ("Qd", Qd, (B, nt, 15, 15))):
        _check(x, name, shape, dt, P0.device)
    return dt, B, nt


# The kernels' launch plans assume what a block gets without an opt-in.
SMEM_NO_OPTIN = 48 * 1024


def _round_up(n: int, v: int) -> int:
    return -(-n // v) * v


# p15_recurrence.cu keeps two P buffers, Phi_i P and two Phi_acc buffers as
# 16 x 16 matrices in rows of P15_PITCH elements, and a ring of two slots of
# C ticks, each tick Phi_i as such a matrix and Qd_i as it is (15 x 15)
P15_PITCH = 20


def p15_plan(nt: int, itemsize: int) -> tuple[int, int, int]:
    """(ticks per chunk C, chunks, shared-memory bytes) of the P15 recurrence
    kernel for nt ticks in a type of ``itemsize`` bytes: the largest C whose
    two ring slots fit SMEM_NO_OPTIN beside the fixed buffers (9 in f32, 4
    in f64), at most nt. Raises ValueError for nt < 1."""
    if nt < 1:
        raise ValueError(f"P15 recurrence takes nt >= 1 ticks, got {nt}")
    mat = 16 * P15_PITCH
    fixed = 5 * mat * itemsize
    tick = _round_up(mat + 225, 16 // itemsize) * itemsize
    C = min(nt, (SMEM_NO_OPTIN - fixed) // (2 * tick))
    chunks = -(-nt // C)
    return C, chunks, fixed + min(chunks, 2) * C * tick


def _p15_launch(P0, Phi, Qd):
    dt, B, nt = _p15_check(P0, Phi, Qd)
    dev = P0.device
    P = torch.empty((B, 15, 15), dtype=dt, device=dev)
    acc = torch.empty_like(P)
    sig = torch.empty((B, nt, 6), dtype=dt, device=dev)
    C, _, smem = p15_plan(nt, P0.element_size())
    _launch("msckf_p15_recurrence", dt, dev, P0.data_ptr(), Phi.data_ptr(), Qd.data_ptr(),
            P.data_ptr(), acc.data_ptr(), sig.data_ptr(), nt, B, C, smem)
    _count("p15_recurrence_fused")
    return P, acc, sig


@torch.library.custom_op("msckf::p15_recurrence_fused", mutates_args=())
def p15_recurrence_fused(P0: torch.Tensor, Phi: torch.Tensor, Qd: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P0 (15, 15), Phi and Qd (nt, 15, 15) -> P (15, 15), Phi_acc (15, 15),
    sigma diagonals (nt, 6)."""
    return _single_call(_p15_launch, _p15_check, p15_recurrence_fused_plain, (P0, Phi, Qd))


@p15_recurrence_fused.register_vmap
def _p15_vmap(info, in_dims, *args):
    """One block per sequence: pallas_call's own vmap rule for this kernel
    (a leading grid axis)."""
    return _batched_call(_p15_launch, _p15_check, p15_recurrence_fused_plain, info, in_dims,
                         args, 3)


# --------------------------------------------------------------------------
# 4. fused propagation block (replaces propagate_block_fused,
#    msckf_tpu/ops/pallas_kernels.py:1216 -> _propagate_block_kernel :1020)
# --------------------------------------------------------------------------


def _skew3(w):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _blocks(rows):
    """A matrix from rows of (..., 3, 3) blocks, the blocks' leading axes
    broadcast against each other."""
    lead = torch.broadcast_shapes(*(b.shape[:-2] for row in rows for b in row))
    return torch.cat([
        torch.cat([b.expand(*lead, *b.shape[-2:]) for b in row], dim=-1) for row in rows
    ], dim=-2)


def _mv(A, x):
    """(..., m, k) @ (..., k) -> (..., m)."""
    return (A @ x[..., :, None])[..., 0]


def propagate_block_fused_plain(R0, p0, v0, bg, ba, last_ts, prop_count,
                                ts, gyro, acc, valid, qc, gravity, P15):
    """nt sequential OC-EKF ticks as the TPU kernel runs them: Rodrigues
    nominal integration, F and the third-order Taylor Phi, the
    observability-constrained fix-up (identity null state while
    prop_count == 0), Q = (Phi G) diag(Qc) (Phi G)^T dt, the P15 and
    Phi_acc recurrences, and masked commits on padding ticks. Takes any
    leading batch axes."""
    dt_ = R0.dtype
    dev = R0.device
    I3 = torch.eye(3, dtype=dt_, device=dev)
    Z3 = torch.zeros((3, 3), dtype=dt_, device=dev)
    I15 = torch.eye(15, dtype=dt_, device=dev)
    R, p, v, lts, pc = R0, p0, v0, last_ts, prop_count
    Phi_acc = I15
    outR, outp, outv, outsig = [], [], [], []
    for i in range(ts.shape[-1]):
        t_i = ts[..., i]
        g_i = gyro[..., i, :] - bg
        a_i = acc[..., i, :] - ba
        ok = valid[..., i]
        dt = t_i - lts
        dt1, dt2 = dt[..., None], dt[..., None, None]

        first = pc == 0
        R_null = torch.where(first[..., None, None], I3, R)
        v_null = torch.where(first[..., None], torch.zeros_like(v), v)
        p_null = torch.where(first[..., None], torch.zeros_like(p), p)

        w_norm = torch.sqrt(torch.sum(g_i * g_i, dim=-1))
        theta = w_norm * dt
        axis = g_i / torch.where(w_norm < 1e-30, torch.ones_like(w_norm), w_norm)[..., None]
        Kx = _skew3(axis)
        dR = (I3 + torch.sin(theta)[..., None, None] * Kx
              + (1.0 - torch.cos(theta))[..., None, None] * (Kx @ Kx))
        dR = torch.where((theta > 0)[..., None, None], dR, I3)
        R_new = R @ dR
        a_w = (a_i[..., None, :] @ R.mT)[..., 0, :] - gravity  # row form of R @ acc - g
        p_new = p + v * dt1 + 0.5 * a_w * dt1 * dt1
        v_new = v + a_w * dt1

        F = _blocks([
            [-_skew3(g_i), -I3, Z3, Z3, Z3],
            [Z3] * 5,
            [-(R_new @ _skew3(a_i)), Z3, Z3, -R_new, Z3],
            [Z3] * 5,
            [Z3, Z3, I3, Z3, Z3],
        ])
        Fdt = F * dt2
        Fdt2 = Fdt @ Fdt
        Phi = I15 + Fdt + 0.5 * Fdt2 + (1.0 / 6.0) * (Fdt2 @ Fdt)

        u_col = _mv(R_null, gravity)
        u_row = (gravity[..., None, :] @ R_null.mT)[..., 0, :]
        s_row = u_row / torch.sum(u_row * u_row, dim=-1, keepdim=True)
        A_vel = Phi[..., 6:9, 0:3]
        A_pos = Phi[..., 12:15, 0:3]
        w1 = _mv(_skew3(v_null - v_new), gravity)
        w2 = _mv(_skew3(dt1 * v_null + p_null - p_new), gravity)
        corr_vel = (_mv(A_vel, u_col) - w1)[..., :, None] * s_row[..., None, :]
        corr_pos = (_mv(A_pos, u_col) - w2)[..., :, None] * s_row[..., None, :]
        Phi = torch.cat([
            torch.cat([R_new @ R_null.mT, Phi[..., 0:3, 3:]], dim=-1),
            Phi[..., 3:6, :],
            torch.cat([A_vel - corr_vel, Phi[..., 6:9, 3:]], dim=-1),
            Phi[..., 9:12, :],
            torch.cat([A_pos - corr_pos, Phi[..., 12:15, 3:]], dim=-1),
        ], dim=-2)

        PG = torch.cat([-Phi[..., :, 0:3], Phi[..., :, 3:6], -(Phi[..., :, 6:9] @ R_new),
                        Phi[..., :, 9:12]], dim=-1)
        Q = (PG * qc[..., None, :]) @ PG.mT * dt2
        P15_new = Phi @ P15 @ Phi.mT + Q
        P15_new = 0.5 * (P15_new + P15_new.mT)
        Phi_acc_new = Phi @ Phi_acc

        okv, okm = ok[..., None], ok[..., None, None]
        R = torch.where(okm, R_new, R)
        p = torch.where(okv, p_new, p)
        v = torch.where(okv, v_new, v)
        lts = torch.where(ok, t_i, lts)
        pc = torch.where(ok, pc + 1, pc)
        P15 = torch.where(okm, P15_new, P15)
        Phi_acc = torch.where(okm, Phi_acc_new, Phi_acc)

        outR.append(R)
        outp.append(p)
        outv.append(v)
        dg = torch.diagonal(P15, dim1=-2, dim2=-1)
        outsig.append(torch.cat([dg[..., 0:3], dg[..., 12:15]], dim=-1))
    return (R, p, v, lts, pc, P15, Phi_acc, torch.stack(outR, dim=-3),
            torch.stack(outp, dim=-2), torch.stack(outv, dim=-2), torch.stack(outsig, dim=-2))


def _propagate_check(R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid, qc,
                     gravity, P15):
    """The per-sequence arrays with a leading axis of B sequences; qc and
    gravity with the same axis, or without it when the sequences share
    them."""
    dt = _float_dtype(R0)
    dev = R0.device
    B, nt = ts.shape
    for name, x, shape in (
        ("R0", R0, (B, 3, 3)), ("p0", p0, (B, 3)), ("v0", v0, (B, 3)), ("bg", bg, (B, 3)),
        ("ba", ba, (B, 3)), ("last_ts", last_ts, (B,)), ("ts", ts, (B, nt)),
        ("gyro", gyro, (B, nt, 3)), ("acc", acc, (B, nt, 3)), ("P15", P15, (B, 15, 15)),
    ):
        _check(x, name, shape, dt, dev)
    for name, x, n in (("qc", qc, 12), ("gravity", gravity, 3)):
        _check(x, name, (n,) if x.dim() == 1 else (B, n), dt, dev)
    _check(prop_count, "prop_count", (B,), torch.int64, dev)
    _check(valid, "valid", (B, nt), torch.bool, dev)
    return dt, B, nt


def _propagate_launch(R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid, qc,
                      gravity, P15):
    args = (R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid, qc, gravity, P15)
    dt, B, nt = _propagate_check(*args)
    dev = R0.device

    def empty(*shape, dtype=dt):
        return torch.empty((B, *shape), dtype=dtype, device=dev)

    outs = (empty(3, 3), empty(3), empty(3), empty(), empty(dtype=torch.int64),
            empty(15, 15), empty(15, 15), empty(nt, 3, 3), empty(nt, 3), empty(nt, 3),
            empty(nt, 6))
    strides = (x.stride(0) if x.dim() == 2 else 0 for x in (qc, gravity))
    _launch("msckf_propagate_block", dt, dev, *(t.data_ptr() for t in args + outs), *strides, nt,
            B)
    _count("propagate_block_fused")
    return outs


@torch.library.custom_op("msckf::propagate_block_fused", mutates_args=())
def propagate_block_fused(
    R0: torch.Tensor, p0: torch.Tensor, v0: torch.Tensor, bg: torch.Tensor,
    ba: torch.Tensor, last_ts: torch.Tensor, prop_count: torch.Tensor, ts: torch.Tensor,
    gyro: torch.Tensor, acc: torch.Tensor, valid: torch.Tensor, qc: torch.Tensor,
    gravity: torch.Tensor, P15: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """One kernel for a block of nt OC-EKF ticks.

    Returns (R, p, v, last_ts, prop_count, P15, Phi_acc, per-tick R (nt,3,3),
    p (nt,3), v (nt,3), sigma diagonals (nt,6)). ``prop_count`` is an int64
    scalar tensor, ``valid`` a bool (nt,) tensor."""
    return _single_call(_propagate_launch, _propagate_check, propagate_block_fused_plain,
                        (R0, p0, v0, bg, ba, last_ts, prop_count, ts, gyro, acc, valid, qc,
                         gravity, P15))


@propagate_block_fused.register_vmap
def _propagate_vmap(info, in_dims, *args):
    """One launch for the batch. The per-sequence arrays get the batch axis
    first; qc and gravity, when the sequences share them (the batched loop's
    constants), stay as they are and reach the kernel with stride 0, not
    copied B times."""
    seq = _batch_first(info, in_dims[:11] + in_dims[13:], *args[:11], args[13])
    args = (*seq[:11], *_shared_or_batch_first(in_dims[11:13], *args[11:13]), seq[11])
    if args[0].device.type == "cpu":
        _propagate_check(*args)
        out = propagate_block_fused_plain(*args)
    else:
        out = _propagate_launch(*args)
    return tuple(out), (0,) * len(out)


# --------------------------------------------------------------------------
# 5. triage triangulation and refresh (replaces triage_refresh_fused,
#    msckf_tpu/ops/pallas_kernels.py:930 -> _triage_kernel :771)
# --------------------------------------------------------------------------


def triage_refresh_fused_plain(line_base, line_dir, weights, anchor_R, anchor_t, K, Kinv,
                               rcond, width, height):
    """Weighted line intersection summed over the observations in order,
    the trace-normalised Tikhonov 3x3 solve, the anchor in-front and
    field-of-view test, and the refresh m = W_v / |W_v|, rho = 1 / z, with
    the TPU kernel's floors (1e-30 on the direction norm, |z| and |W_v|;
    1e-20 on the Gram scale; 1e-38 on |det|). Every divisor is a tensor:
    PyTorch on the GPU divides by a Python number as a multiplication by its
    reciprocal, which the kernel does not. Takes any leading batch axes (K
    and Kinv with the same ones)."""
    M = weights.shape[-1]
    full = functools.partial(torch.full, weights.shape[:-1], dtype=weights.dtype,
                             device=weights.device)
    zero, one, three = full(0.0), full(1.0), full(3.0)
    tiny = full(1e-30)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    X = dict.fromkeys(pairs, zero)
    y = [zero, zero, zero]
    for m in range(M):
        b = [line_base[..., m, i] for i in range(3)]
        d = [line_dir[..., m, i] for i in range(3)]
        w = weights[..., m]
        n = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        n = torch.where(n < 1e-30, tiny, n)
        dn = [d[i] / n for i in range(3)]
        for i, j in pairs:
            X[(i, j)] = X[(i, j)] + w * ((one if i == j else zero) - dn[i] * dn[j])
        db = dn[0] * b[0] + dn[1] * b[1] + dn[2] * b[2]
        y = [y[i] + w * (b[i] - dn[i] * db) for i in range(3)]

    scale = (X[(0, 0)] + X[(1, 1)] + X[(2, 2)]) / three
    scale = torch.where(scale < 1e-20, full(1e-20), scale)
    eps = full(3.0 * rcond)
    a = X[(0, 0)] / scale + eps
    b = X[(0, 1)] / scale
    c = X[(0, 2)] / scale
    d = X[(1, 1)] / scale + eps
    e = X[(1, 2)] / scale
    f = X[(2, 2)] / scale + eps
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = c * b - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    det = torch.where(det.abs() < 1e-38, full(1e-38), det)
    inv_det = one / (det * scale)
    Wp = [
        (co00 * y[0] + co01 * y[1] + co02 * y[2]) * inv_det,
        (co01 * y[0] + co11 * y[1] + co12 * y[2]) * inv_det,
        (co02 * y[0] + co12 * y[1] + co22 * y[2]) * inv_det,
    ]

    R = [anchor_R[..., i, j] for i in range(3) for j in range(3)]
    dx, dy, dz = (Wp[i] - anchor_t[..., i] for i in range(3))
    Ci = [R[i] * dx + R[3 + i] * dy + R[6 + i] * dz for i in range(3)]
    z = torch.where(Ci[2].abs() < 1e-30, tiny, Ci[2])
    Kb = [[K[..., i, j, None] for j in range(3)] for i in range(3)]  # over the tracks
    Kib = [[Kinv[..., i, j, None] for j in range(3)] for i in range(3)]
    u = (Kb[0][0] * Ci[0] + Kb[0][1] * Ci[1] + Kb[0][2] * Ci[2]) / z
    v = (Kb[1][0] * Ci[0] + Kb[1][1] * Ci[1] + Kb[1][2] * Ci[2]) / z
    ok = (Ci[2] > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    cam = [Kib[i][0] * u + Kib[i][1] * v + Kib[i][2] for i in range(3)]
    Wv = [R[3 * i] * cam[0] + R[3 * i + 1] * cam[1] + R[3 * i + 2] * cam[2] for i in range(3)]
    nrm = torch.sqrt(Wv[0] * Wv[0] + Wv[1] * Wv[1] + Wv[2] * Wv[2])
    nrm = torch.where(nrm < 1e-30, tiny, nrm)
    m_new = torch.stack([Wv[i] / nrm for i in range(3)], dim=-1)
    return m_new, one / z, ok


def _triage_check(line_base, line_dir, weights, anchor_R, anchor_t, K, Kinv):
    dt = _float_dtype(weights)
    B, F, M = weights.shape
    for name, x, shape in (
        ("line_base", line_base, (B, F, M, 3)), ("line_dir", line_dir, (B, F, M, 3)),
        ("weights", weights, (B, F, M)), ("anchor_R", anchor_R, (B, F, 3, 3)),
        ("anchor_t", anchor_t, (B, F, 3)), ("K", K, (B, 3, 3)), ("Kinv", Kinv, (B, 3, 3)),
    ):
        _check(x, name, shape, dt, weights.device)
    return dt, B, F, M


# triage.cu: at most 256 observations and threads a pass, at most 32 tracks a
# block (one warp of epilogues), and blocks enough for every SM of an H100
# SXM (132)
TRIAGE_MAX_THREADS = 256
TRIAGE_MAX_TRACKS = 32
TRIAGE_SMS = 132


def triage_plan(F: int, M: int, B: int, itemsize: int) -> tuple[int, int, int, int, int]:
    """(tracks per block, tracks per pass g, observations per pass mc,
    threads, shared-memory bytes) of the triage kernel for B sequences of F
    tracks of M observations in a type of ``itemsize`` bytes. A block's
    tracks double up to TRIAGE_MAX_TRACKS while the B ceil(F / tracks)
    blocks still cover every SM (4 at 768 x 32, 32 at B = 32); it walks
    them in passes of g whole tracks (g mc <= TRIAGE_MAX_THREADS, 8 at
    M = 32) or, past M = TRIAGE_MAX_THREADS, of one track's mc observations;
    the threads cover a pass's observations, its 9 g summing lanes and the
    block's epilogue lanes, in whole warps. The plan decides where each term
    is computed, never the order of a sum, so the bits depend on it no more
    than on B. Raises ValueError for F, M or B < 1."""
    if F < 1 or M < 1 or B < 1:
        raise ValueError(f"triage kernel takes F, M and B >= 1, got F={F}, M={M}, B={B}")
    mc = min(M, TRIAGE_MAX_THREADS)
    tracks = 1
    while 2 * tracks <= TRIAGE_MAX_TRACKS and B * -(-F // (2 * tracks)) >= TRIAGE_SMS:
        tracks *= 2
    g = min(tracks, TRIAGE_MAX_THREADS // mc if mc == M else 1, TRIAGE_MAX_THREADS // 9)
    threads = _round_up(max(g * mc, 9 * g, tracks), 32)
    # a pass's base, dir and w; the block's anchor R and t; K and K^-1; a
    # pass's terms in rows of odd pitch; the block's sums; each array on 16
    # bytes (triage.cu, Layout)
    v = 16 // itemsize
    elems = sum(_round_up(n, v) for n in (3 * g * mc, 3 * g * mc, g * mc, 9 * tracks, 3 * tracks,
                                          9, 9, 9 * g * (mc | 1), 9 * tracks))
    return tracks, g, mc, threads, elems * itemsize


def _triage_launch(line_base, line_dir, weights, anchor_R, anchor_t, K, Kinv, rcond,
                   width, height):
    tensors = (line_base, line_dir, weights, anchor_R, anchor_t, K, Kinv)
    dt, B, F, M = _triage_check(*tensors)
    dev = weights.device
    m = torch.empty((B, F, 3), dtype=dt, device=dev)
    rho = torch.empty((B, F), dtype=dt, device=dev)
    ok = torch.empty((B, F), dtype=torch.bool, device=dev)
    if B * F * M == 0:
        return m, rho, ok
    _launch("msckf_triage", dt, dev, *(t.data_ptr() for t in tensors),
            3.0 * rcond, float(width), float(height),
            m.data_ptr(), rho.data_ptr(), ok.data_ptr(), F, M, B,
            *triage_plan(F, M, B, weights.element_size()))
    _count("triage_refresh_fused")
    return m, rho, ok


@torch.library.custom_op("msckf::triage_refresh_fused", mutates_args=())
def triage_refresh_fused(line_base: torch.Tensor, line_dir: torch.Tensor,
                         weights: torch.Tensor, anchor_R: torch.Tensor,
                         anchor_t: torch.Tensor, K: torch.Tensor, Kinv: torch.Tensor,
                         rcond: float, width: float, height: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """line_base, line_dir (F, M, 3), weights (F, M) (zero where an
    observation is invalid), anchor_R (F, 3, 3), anchor_t (F, 3), K and
    Kinv (3, 3) -> refreshed bearing m (F, 3), inverse depth rho (F,), and
    ok (F,) bool: the point lies in front of the anchor camera and inside
    its image."""
    return _single_call(_triage_launch, _triage_check, triage_refresh_fused_plain,
                        (line_base, line_dir, weights, anchor_R, anchor_t, K, Kinv),
                        (rcond, width, height))


@triage_refresh_fused.register_vmap
def _triage_vmap(info, in_dims, *args):
    return _batched_call(_triage_launch, _triage_check, triage_refresh_fused_plain, info,
                         in_dims, args, 7)


# --------------------------------------------------------------------------
# 6. fused update terms (replaces update_terms_fused,
#    msckf_tpu/ops/pallas_kernels.py:560 -> _update_terms_kernel :303)
# --------------------------------------------------------------------------


def update_terms_gamma_plain(H, Hf, r, P, sigma2, rcond):
    """The per-track half of ``update_terms_fused_plain``: the projector
    Pi = I - Hf W Hf^T (W the closed-form trace-normalised Tikhonov inverse
    of Hf^T Hf, with the TPU kernel's floors 1e-20 and 1e-38) applied to r
    and H, S = H~ P H~^T + sigma^2 I, and gamma = r~^T S^-1 r~ by the gating
    kernel's pivot-row Cholesky. Returns (H~, r~, gamma). Takes any leading
    batch axes (P with the same ones)."""
    R2 = H.shape[-2]
    dt, dev = H.dtype, H.device

    def gram(i, j):
        return torch.sum(Hf[..., i] * Hf[..., j], dim=-1)

    g00, g01, g02 = gram(0, 0), gram(0, 1), gram(0, 2)
    g11, g12, g22 = gram(1, 1), gram(1, 2), gram(2, 2)
    scale = (g00 + g11 + g22) / torch.full_like(g00, 3.0)
    scale = torch.where(scale < 1e-20, torch.full_like(scale, 1e-20), scale)
    eps = torch.full_like(scale, 3.0 * rcond)
    a, b, c = g00 / scale + eps, g01 / scale, g02 / scale
    d, e, f = g11 / scale + eps, g12 / scale, g22 / scale + eps
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = c * b - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    det = torch.where(det.abs() < 1e-38, torch.full_like(det, 1e-38), det)
    inv_det = torch.ones_like(det) / (det * scale)
    W = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2) * inv_det[..., None, None]  # (U, 3, 3)

    w = torch.einsum("...uij,...uj->...ui", W, torch.einsum("...uri,...ur->...ui", Hf, r))
    r_t = r - torch.einsum("...uri,...ui->...ur", Hf, w)
    C = torch.einsum("...uij,...ujd->...uid", W, torch.einsum("...uri,...urd->...uid", Hf, H))
    H_t = H - torch.einsum("...uri,...uid->...urd", Hf, C)
    S = (H_t @ P[..., None, :, :]) @ H_t.mT + sigma2 * torch.eye(R2, dtype=dt, device=dev)
    gamma = batched_gating_gamma_plain(S.reshape(-1, R2, R2), r_t.reshape(-1, R2))
    return H_t, r_t, gamma.reshape(r_t.shape[:-1])


def update_terms_masked_plain(H_t, r_t, passed):
    """A = sum H~^T H~ and c = sum H~^T r~ over the passed tracks, their
    rows selected (not multiplied), so that an inf row of a rejected track
    adds exact zeros."""
    zero = torch.zeros((), dtype=H_t.dtype, device=H_t.device)
    H_w = torch.where(passed[..., None, None], H_t, zero)
    r_w = torch.where(passed[..., None], r_t, zero)
    return (torch.einsum("...urd,...ure->...de", H_w, H_w),
            torch.einsum("...urd,...ur->...d", H_w, r_w))


def update_terms_fused_plain(H, Hf, r, P, crit, sel_ok, sigma2, rcond):
    """The projector, S and gamma per track; passed = sel_ok &
    (gamma <= crit), where a NaN crit or gamma fails; then the masked
    A and c."""
    H_t, r_t, gamma = update_terms_gamma_plain(H, Hf, r, P, sigma2, rcond)
    passed = sel_ok & (gamma <= crit)
    A, c = update_terms_masked_plain(H_t, r_t, passed)
    return A, c, passed


def _update_terms_check(H, Hf, r, P, crit, sel_ok):
    dt = _float_dtype(H)
    B, U, R2, D = H.shape
    dev = H.device
    for name, x, shape in (("H", H, (B, U, R2, D)), ("Hf", Hf, (B, U, R2, 3)),
                           ("r", r, (B, U, R2)), ("P", P, (B, D, D)), ("crit", crit, (B, U))):
        _check(x, name, shape, dt, dev)
    _check(sel_ok, "sel_ok", (B, U), torch.bool, dev)
    return dt, B, U, R2, D


# The accumulation's split over rows (launch 2 of update_terms.cu): chunks of
# whole tracks of about 512 rows, the TPU kernel's tile of 8 tracks of 64 rows
# (_UPDATE_TILE_U, pallas_kernels.py:461), at most 32 tracks (the kernel reads
# a chunk's gate decisions as one warp ballot).
UPDATE_CHUNK_ROWS = 512
UPDATE_CHUNK_MAX_TRACKS = 32


def update_chunk_plan(U: int, R2: int) -> tuple[int, int]:
    """(tracks per chunk, chunks) of the update-terms accumulation for U
    tracks of 2M = R2 rows: chunk k holds tracks [k t, min((k + 1) t, U)).
    The plan fixes the kernel's order of summation, so it depends on U and
    2M only, never on the batch. Raises ValueError for 2M < 1."""
    if R2 < 1:
        raise ValueError(f"update-terms kernel takes 2M >= 1, got {R2}")
    if U < 0:
        raise ValueError(f"update-terms kernel takes U >= 0, got {U}")
    tpc = min(UPDATE_CHUNK_MAX_TRACKS, max(1, UPDATE_CHUNK_ROWS // R2))
    return tpc, -(-U // tpc)


def update_terms_scratch(B: int, U: int, R2: int, D: int, dtype: torch.dtype, device) -> dict:
    """The update-terms call's scratch, from the chunk plan (never from B
    beyond the leading axis): H~ and r~ (B, U, 2M, D) and (B, U, 2M), S
    (B, U, 2M, 2M; launch 1 writes its upper triangle, the gate reads it),
    the gate's global scratch (None where it works in shared memory), and
    the partials (B, chunks, D, D) and (B, chunks, D)."""
    _, n_chunks = update_chunk_plan(U, R2)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return {"Ht": empty(B, U, R2, D), "rt": empty(B, U, R2), "Ss": empty(B, U, R2, R2),
            "gate": gate_scratch(B * U, R2, dtype, device),
            "Apart": empty(B, n_chunks, D, D), "cpart": empty(B, n_chunks, D)}


def _update_terms_launch(H, Hf, r, P, crit, sel_ok, sigma2, rcond):
    dt, B, U, R2, D = _update_terms_check(H, Hf, r, P, crit, sel_ok)
    dev = H.device
    if B * U * R2 == 0:
        return (torch.zeros((B, D, D), dtype=dt, device=dev),
                torch.zeros((B, D), dtype=dt, device=dev),
                torch.zeros((B, U), dtype=torch.bool, device=dev))
    tpc, _ = update_chunk_plan(U, R2)
    sc = update_terms_scratch(B, U, R2, D, dt, dev)
    A = torch.empty((B, D, D), dtype=dt, device=dev)
    c = torch.empty((B, D), dtype=dt, device=dev)
    passed = torch.empty((B, U), dtype=torch.bool, device=dev)
    _launch("msckf_update_terms", dt, dev,
            *(t.data_ptr() for t in (H, Hf, r, P, crit, sel_ok)),
            *(_ptr(sc[k]) for k in ("Ht", "rt", "Ss", "gate", "Apart", "cpart")),
            *(t.data_ptr() for t in (A, c, passed)),
            U, R2, D, B, tpc, float(sigma2), 3.0 * float(rcond))
    _count("update_terms_fused")
    return A, c, passed


@torch.library.custom_op("msckf::update_terms_fused", mutates_args=())
def update_terms_fused(H: torch.Tensor, Hf: torch.Tensor, r: torch.Tensor, P: torch.Tensor,
                       crit: torch.Tensor, sel_ok: torch.Tensor, sigma2: float, rcond: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """H (U, 2M, D), Hf (U, 2M, 3), r (U, 2M), P (D, D), crit (U,) with NaN
    for a track that must fail, sel_ok (U,) bool -> A (D, D), c (D,),
    passed (U,) bool. One call is four launches (per-track projector and
    S, the gate, the masked accumulation's partial sums by chunk of tracks,
    their sum; five on the general form of the first), counted as one."""
    return _single_call(_update_terms_launch, _update_terms_check, update_terms_fused_plain,
                        (H, Hf, r, P, crit, sel_ok), (sigma2, rcond))


@update_terms_fused.register_vmap
def _update_terms_vmap(info, in_dims, *args):
    return _batched_call(_update_terms_launch, _update_terms_check, update_terms_fused_plain,
                         info, in_dims, args, 6)
