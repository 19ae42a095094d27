"""The port's native host library (``msckf_tpu_torch/data/native_io.py``,
``msckf_tpu_torch/native/fastcsv.cpp``) against the JAX package's module
and the port's csv reader, mirroring tests/test_native_io.py.

* The library builds with g++ into msckf_tpu_torch/build/ under a tag of
  its flags and sources; a failed build warns with g++'s message.
* ``read_numeric_csv`` on comma- and space-separated files, and
  ``read_numeric_csvs`` on the thread pool, are bitwise the JAX module's
  and ``data/parser.py::read_table``'s (correctly rounded parsing both),
  and give back the arrays that were written, bit for bit.
* ``pack_blocks_native`` is bitwise the JAX module's and a plain loop's,
  and raises on a gap wider than the block.
* The parser reads the per-frame keypoint files and ``load_imu_batch``
  through the library, bitwise as the JAX parser does.
* Without the library every function serves the same bits from numpy.
"""

import numpy as np
import pandas as pd
import pytest

from msckf_tpu.data import native_io as jnat
from msckf_tpu.data import parser as jpar
from msckf_tpu.data.synthetic import generate_circle_sequence as jax_circle

from msckf_tpu_torch.data import native_io as tnat
from msckf_tpu_torch.data import parser as tpar

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bits(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64), err_msg=what)


def _table(path, sep=","):
    return np.stack([np.asarray(v, np.float64) for v in tpar.read_table(path, sep).values()], -1)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """A pandas-written CSV, a space-separated one and nine numpy-written
    ones of different shapes, and the written arrays of the first two."""
    root = tmp_path_factory.mktemp("csv")
    rng = np.random.default_rng(0)
    df = pd.DataFrame(rng.normal(size=(57, 7)), columns=[f"c{i}" for i in range(7)])
    df.to_csv(root / "x.csv", index=False)
    a = rng.normal(size=(20, 4)) * 10.0 ** rng.integers(-8, 8, (20, 4))
    np.savetxt(root / "t.csv", a, delimiter=" ", header="a b c d", comments="")
    many = []
    for i in range(9):
        m = rng.normal(size=(200 + 17 * i, 3 + (i % 3)))
        p = root / f"seq{i}.csv"
        np.savetxt(p, m, delimiter=",", header=",".join(f"c{j}" for j in range(m.shape[1])),
                   comments="")
        many.append(str(p))
    return str(root / "x.csv"), str(root / "t.csv"), many, (df.to_numpy(), a)


def test_native_builds_into_the_ports_build_dir():
    assert tnat.have_native()
    lib = tnat.build_native()
    assert lib.parent == tnat.BUILD_DIR and lib.name.startswith("libmsckf_host_")
    assert tnat._source_tag() in lib.name


def test_failed_build_warns_with_the_compilers_message(tmp_path, monkeypatch):
    """g++ present but failing warns with its stderr and builds nothing."""
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnat, "CXXFLAGS", tnat.CXXFLAGS + ("-fno-such-flag",))
    with pytest.warns(RuntimeWarning, match="no-such-flag"):
        assert tnat.build_native() is None
    assert not list(tmp_path.iterdir())


def test_read_numeric_csv(csvs):
    comma, space, _, written = csvs
    for path, sep, want in ((comma, ",", written[0]), (space, " ", written[1])):
        got = tnat.read_numeric_csv(path, sep=sep)
        _bits(got, jnat.read_numeric_csv(path, sep=sep), path)
        _bits(got, _table(path, sep), path)
        _bits(got, want, path)


def test_read_numeric_csvs_threaded(csvs):
    _, _, many, _ = csvs
    outs = tnat.read_numeric_csvs(many, threads=4)
    for out, jout, p in zip(outs, jnat.read_numeric_csvs(many, threads=4), many):
        _bits(out, jout, p)
        _bits(out, tnat.read_numeric_csv(p), p)
    assert tnat.read_numeric_csvs([]) == []


def test_pack_blocks_matches_jax_and_a_loop():
    rng = np.random.default_rng(2)
    T = 97
    ts = np.arange(T) * 0.005
    gyro = rng.normal(size=(T, 3))
    acc = rng.normal(size=(T, 3))
    cam = np.array([10, 20, 30, 40, 55, 70, 85], dtype=np.int64)
    B = 15
    got = tnat.pack_blocks_native(ts, gyro, acc, cam, B)
    for g, j in zip(got, jnat.pack_blocks_native(ts, gyro, acc, cam, B)):
        np.testing.assert_array_equal(g, j)
        assert g.dtype == j.dtype
    bounds = np.append(cam, T)
    for k in range(len(cam)):
        lo, hi = bounds[k], bounds[k + 1]
        n = hi - lo
        np.testing.assert_array_equal(got[0][k, :n], ts[lo:hi])
        np.testing.assert_array_equal(got[1][k, :n], gyro[lo:hi])
        np.testing.assert_array_equal(got[2][k, :n], acc[lo:hi])
        assert got[3][k, :n].all() and not got[3][k, n:].any()
        assert not got[0][k, n:].any()


def test_pack_blocks_overflow():
    ts = np.arange(30) * 1.0
    z = np.zeros((30, 3))
    with pytest.raises(ValueError):
        tnat.pack_blocks_native(ts, z, z, np.array([0], dtype=np.int64), 8)


def test_parser_reads_through_the_library(tmp_path):
    """Per-frame keypoint files and load_imu_batch, as the JAX parser reads
    them, on sequences the port's writer wrote."""
    paths = []
    for i in range(3):
        seq = jax_circle(rng=np.random.default_rng(i), n_world_points=50)
        d = tmp_path / f"s{i}"
        tpar.save_sequence_csv(seq, str(d))
        paths.append(str(d / "imu.csv"))
    for (ts, g, a), (jts, jg, ja) in zip(tpar.load_imu_batch(paths, threads=3),
                                         jpar.load_imu_batch(paths, threads=3)):
        _bits(ts, jts)
        _bits(g, jg)
        _bits(a, ja)
    frame = sorted((tmp_path / "s0" / "cam_noisy").iterdir())[3]
    tp = tpar.Parser("synthetic", "circle", base_path=str(tmp_path))
    jp = jpar.Parser("synthetic", "circle", base_path=str(tmp_path))
    for got, want in zip(tp.extract_synthetic_camera_measurements(str(frame)),
                         jp.extract_synthetic_camera_measurements(str(frame))):
        _bits(got, want)


def test_numpy_fallback_gives_the_same_bits(csvs, monkeypatch):
    comma, space, many, _ = csvs
    ts = np.arange(50) * 0.01
    g = np.random.default_rng(3).normal(size=(50, 3))
    cam = np.array([0, 9, 22, 40], dtype=np.int64)
    native = (tnat.read_numeric_csv(comma), tnat.read_numeric_csv(space, sep=" "),
              tnat.read_numeric_csvs(many), tnat.pack_blocks_native(ts, g, -g, cam, 18))
    monkeypatch.setattr(tnat, "_load", lambda: None)
    assert not tnat.have_native()
    plain = (tnat.read_numeric_csv(comma), tnat.read_numeric_csv(space, sep=" "),
             tnat.read_numeric_csvs(many), tnat.pack_blocks_native(ts, g, -g, cam, 18))
    _bits(plain[0], native[0])
    _bits(plain[1], native[1])
    for a, b in zip(plain[2], native[2]):
        _bits(a, b)
    for a, b in zip(plain[3], native[3]):
        np.testing.assert_array_equal(a, b)
    assert tnat.png_unfilter_native(np.zeros(6, np.uint8), 2, 2, 1) is None
    with pytest.raises(ValueError):
        tnat.pack_blocks_native(ts, g, g, np.array([0], dtype=np.int64), 8)
