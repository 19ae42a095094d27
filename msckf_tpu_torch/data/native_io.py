"""ctypes bindings for the port's native host library (port of
``msckf_tpu/data/native_io.py``).

``msckf_tpu_torch/native/fastcsv.cpp`` (the port's copy of the JAX
package's mmap'd numeric CSV parser and sensor-block packer) and
``png_unfilter.cpp`` (PNG scanline unfiltering for ``data/imageio.py``) are
compiled at first use by ``g++`` with the flags of
``msckf_tpu/native/Makefile`` into ``msckf_tpu_torch/build/``, under a tag
that hashes the flags and the sources. Without ``g++`` every function
serves the same result from numpy and the port's ``csv`` reader
(``data/parser.py::read_table``). Both parse with correctly rounded
``strtod``, so either way a number reads back as ``read_table`` reads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]
NATIVE_DIR = PACKAGE / "native"
BUILD_DIR = PACKAGE / "build"
SOURCES = ("fastcsv.cpp", "png_unfilter.cpp")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")


def _source_tag() -> str:
    h = hashlib.sha256(repr(CXXFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:12]


def build_native() -> Path | None:
    """The library's path, compiled if it is not built yet (each process
    compiles to a file of its own and renames it into place, so concurrent
    first uses agree); None without ``g++`` or when it fails, which warns
    with the compiler's message."""
    lib = BUILD_DIR / f"libmsckf_host_{_source_tag()}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    done = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"the native host library did not build; reading CSV and PNG rows "
                      f"with numpy instead:\n{done.stderr}", RuntimeWarning, stacklevel=2)
        return None
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load():
    """The bound library, or None (no compiler, or the build failed)."""
    path = build_native()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_char, i64p, i64p]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_read.argtypes = [ctypes.c_char_p, ctypes.c_char, dp, ctypes.c_int64, ctypes.c_int64]
    lib.csv_read.restype = ctypes.c_int64
    lib.pack_blocks.argtypes = [dp, dp, dp, ctypes.c_int64, i64p, ctypes.c_int64,
                                ctypes.c_int64, dp, dp, dp, u8p]
    lib.pack_blocks.restype = ctypes.c_int
    lib.csv_read_many.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_char,
                                  ctypes.POINTER(dp), i64p, i64p, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.csv_read_many.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p]
    lib.png_unfilter.restype = ctypes.c_int64
    return lib


def have_native() -> bool:
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _dims(lib, path: str, sep: str) -> tuple[int, int]:
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.csv_dims(path.encode(), sep.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        raise IOError(f"csv_dims failed for {path}")
    return rows.value, cols.value


def read_numeric_csv(path: str, sep: str = ",") -> np.ndarray:
    """Numeric CSV (one header line) -> (rows, cols) float64 array."""
    lib = _load()
    if lib is None:
        from msckf_tpu_torch.data.parser import read_table

        cols = read_table(path, sep=sep)
        return np.stack([np.asarray(v, dtype=np.float64) for v in cols.values()], axis=-1)
    rows, cols = _dims(lib, path, sep)
    out = np.empty((rows, cols), dtype=np.float64)
    got = lib.csv_read(path.encode(), sep.encode(), _dptr(out), rows, cols)
    if got != rows:
        raise IOError(f"csv_read parsed {got}/{rows} rows of {path}")
    return out


def read_numeric_csvs(paths, sep: str = ",", threads: int | None = None):
    """Parse many numeric CSVs concurrently on the native thread pool (one
    mmap'd file a thread; the multi-sequence feeder of a batched run), or
    one after another without the library. Returns a list of (rows, cols)
    float64 arrays in input order."""
    lib = _load()
    paths = list(paths)
    if lib is None:
        return [read_numeric_csv(p, sep) for p in paths]
    n = len(paths)
    if n == 0:
        return []
    if threads is None:
        threads = min(n, os.cpu_count() or 1)
    dims = [_dims(lib, p, sep) for p in paths]
    outs = [np.empty(d, dtype=np.float64) for d in dims]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_outs = (ctypes.POINTER(ctypes.c_double) * n)(*[_dptr(a) for a in outs])
    c_rows = (ctypes.c_int64 * n)(*[d[0] for d in dims])
    c_cols = (ctypes.c_int64 * n)(*[d[1] for d in dims])
    if lib.csv_read_many(c_paths, sep.encode(), c_outs, c_rows, c_cols, n, threads) != 0:
        raise IOError("csv_read_many: a file failed to parse completely")
    return outs


def pack_blocks_native(imu_ts: np.ndarray, gyro: np.ndarray, acc: np.ndarray,
                       cam_ticks: np.ndarray, block: int):
    """IMU ticks -> (C, block) frame blocks (ts, gyro, acc, valid): block j
    holds ticks cam_ticks[j] up to the next frame's; native, or numpy."""
    C = len(cam_ticks)
    ts = np.zeros((C, block), np.float64)
    g = np.zeros((C, block, 3), np.float64)
    a = np.zeros((C, block, 3), np.float64)
    valid = np.zeros((C, block), np.uint8)
    imu_ts = np.ascontiguousarray(imu_ts, np.float64)
    gyro = np.ascontiguousarray(gyro, np.float64)
    acc = np.ascontiguousarray(acc, np.float64)
    cam_ticks = np.ascontiguousarray(cam_ticks, np.int64)
    lib = _load()
    if lib is not None:
        rc = lib.pack_blocks(
            _dptr(imu_ts), _dptr(gyro), _dptr(acc), len(imu_ts),
            cam_ticks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), C, block,
            _dptr(ts), _dptr(g), _dptr(a), _u8ptr(valid),
        )
        if rc != 0:
            raise ValueError("pack_blocks: block size too small for a frame gap")
        return ts, g, a, valid.astype(bool)
    bounds = np.append(cam_ticks, len(imu_ts))
    for j in range(C):
        lo, hi = int(bounds[j]), int(bounds[j + 1])
        n = hi - lo
        if n > block:
            raise ValueError("pack_blocks: block size too small for a frame gap")
        ts[j, :n] = imu_ts[lo:hi]
        g[j, :n] = gyro[lo:hi]
        a[j, :n] = acc[lo:hi]
        valid[j, :n] = 1
    return ts, g, a, valid.astype(bool)


def png_unfilter_native(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray | None:
    """The (h, stride) unfiltered rows of a PNG's inflated data ``raw``
    (h rows of a filter-type byte and ``stride`` bytes), or None without
    the library. Raises ``ValueError`` on an unknown filter type."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {h} rows of {stride + 1}")
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(_u8ptr(raw), h, stride, bpp, _u8ptr(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {raw[(bad - 1) * (stride + 1)]}, "
                         "not 0 to 4")
    return out
