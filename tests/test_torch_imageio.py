"""The port's PNG codec (``msckf_tpu_torch/data/imageio.py``) against OpenCV.

* The decoder gives ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``'s bits (BGR
  order, alpha last) on 8-bit greyscale, RGB and RGBA files that OpenCV
  wrote with each of its row filters (None, Sub, Up, Average, Paeth, and
  its adaptive choice among all five), and on greyscale-with-alpha and
  palette files (1, 4 and 8 bits, with and without a tRNS table), which
  OpenCV does not write: those are built chunk by chunk here.
* The native unfilter (``native/png_unfilter.cpp``) and its plain version
  give the same bytes for every filter type and pixel size.
* The encoder, with each single filter type and with all five in turn,
  writes greyscale and RGB files that OpenCV reads back bit for bit.
* ``imread_grayscale`` is ``IMREAD_GRAYSCALE`` and ``imread_color_gray`` is
  ``cvtColor(imread(path), COLOR_BGR2GRAY)``, bit for bit, on every accepted
  form; the two differ on colour pixels.
* Interlaced, 16-bit and colour-keyed files, an eXIf chunk, a colour file
  with gAMA or sRGB read as grey, a bad CRC, a missing file, and a non-PNG
  file without OpenCV raise.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from msckf_tpu_torch.data import imageio, native_io  # noqa: E402

from tests.torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

H, W = 37, 53  # not multiples of anything, so every row edge is exercised


def _image(rng, channels):
    """Smooth content plus noise: OpenCV's adaptive filtering then picks
    several filter types."""
    yy, xx = np.mgrid[0:H, 0:W]
    base = (3 * xx + 2 * yy)[..., None] + 40 * np.arange(channels)
    img = (base + rng.integers(0, 24, (H, W, channels))) % 256
    return img.astype(np.uint8)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _png(rows: np.ndarray, w: int, color_type: int, depth: int = 8, chunks=(), plte=None,
         trns=None, interlace: int = 0) -> bytes:
    """A PNG of unfiltered (filter type 0) rows (h, stride bytes), built
    chunk by chunk."""
    data = b"".join(b"\x00" + r.tobytes() for r in rows)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, len(rows), depth, color_type, 0, 0, interlace))
    for ctype, body in chunks:
        out += _chunk(ctype, body)
    if plte is not None:
        out += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


CV_FILTERS = {
    "none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
    "up": cv2.IMWRITE_PNG_FILTER_UP, "average": cv2.IMWRITE_PNG_FILTER_AVG,
    "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of every accepted form."""
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    out = {}
    for ch, kind in ((1, "grey"), (3, "bgr"), (4, "bgra")):
        img = _image(rng, ch)[..., 0] if ch == 1 else _image(rng, ch)
        for fname, flag in CV_FILTERS.items():
            path = str(root / f"cv_{kind}_{fname}.png")
            assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
            out[f"cv_{kind}_{fname}"] = path
    ga = _image(rng, 2)
    (root / "ga.png").write_bytes(_png(ga.reshape(H, -1), W, 4))
    out["grey_alpha"] = str(root / "ga.png")
    plte = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    for depth in (1, 4, 8):
        idx = rng.integers(0, min(2**depth, len(plte)), (H, W), dtype=np.uint8)
        per = 8 // depth
        padded = np.zeros((H, -(-W // per) * per), np.uint8)
        padded[:, :W] = idx
        shifts = 8 - depth * (1 + np.arange(per))
        packed = (padded.reshape(H, -1, per).astype(np.int64) << shifts).sum(-1).astype(np.uint8)
        (root / f"p{depth}.png").write_bytes(_png(packed, W, 3, depth, plte=plte))
        out[f"palette{depth}"] = str(root / f"p{depth}.png")
    trns = rng.integers(0, 256, 120, dtype=np.uint8).tobytes()
    idx = rng.integers(0, len(plte), (H, W), dtype=np.uint8)
    (root / "pt.png").write_bytes(_png(idx, W, 3, plte=plte, trns=trns))
    out["palette_trns"] = str(root / "pt.png")
    # a unit gAMA and a cHRM change nothing in OpenCV's reads
    rgb = _image(rng, 3)
    (root / "chrm.png").write_bytes(_png(rgb.reshape(H, -1), W, 2, chunks=[
        (b"gAMA", struct.pack(">I", 100000)), (b"cHRM", struct.pack(">8I", *range(8)))]))
    out["rgb_unit_gamma_chrm"] = str(root / "chrm.png")
    return out


def test_decoder_is_opencvs_unchanged_read(files):
    for name, path in files.items():
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = imageio.imread_unchanged(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_opencv_files_use_every_filter(files):
    """The fixture's adaptive files hold several filter types, and the
    single-filter files one each, so the decoder saw all five."""
    seen = set()
    for name, path in files.items():
        if name.startswith("cv_"):
            data = open(path, "rb").read()
            raw = zlib.decompress(b"".join(b for t, b in imageio._chunks(data, path)
                                           if t == "IDAT"))
            stride = len(raw) // H
            seen |= set(np.frombuffer(raw, np.uint8).reshape(H, stride)[:, 0].tolist())
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_plain(bpp):
    assert native_io.have_native()
    rng = np.random.default_rng(bpp)
    stride = 29 * bpp + (bpp > 1)
    rows = rng.integers(0, 256, (40, stride + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(40) % 5
    got = imageio.unfilter(rows.reshape(-1), 40, stride, bpp)
    np.testing.assert_array_equal(got, imageio.unfilter_plain(rows.reshape(-1), 40, stride, bpp))
    rows[7, 0] = 5
    for fn in (imageio.unfilter, imageio.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 5"):
            fn(rows.reshape(-1), 40, stride, bpp)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
def test_encoder_reads_back_in_opencv(filters, tmp_path):
    rng = np.random.default_rng(3)
    grey, rgb = _image(rng, 1)[..., 0], _image(rng, 3)
    for name, img, want in (("grey", grey, grey), ("rgb", rgb, rgb[..., ::-1])):
        path = str(tmp_path / f"{name}.png")
        imageio.write_png(path, img, filters)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), want)
        np.testing.assert_array_equal(imageio.imread_unchanged(path), want)
        data = open(path, "rb").read()
        raw = zlib.decompress(b"".join(b for t, b in imageio._chunks(data, path)
                                       if t == "IDAT"))
        types = np.frombuffer(raw, np.uint8).reshape(H, -1)[:, 0]
        np.testing.assert_array_equal(types, np.resize(np.atleast_1d(filters), H))


def test_grey_reads_are_opencvs(files):
    colour = 0
    for name, path in files.items():
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(imageio.imread_grayscale(path), want, err_msg=name)
        want_cvt = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
        np.testing.assert_array_equal(imageio.imread_color_gray(path), want_cvt, err_msg=name)
        colour += int((want != want_cvt).any())
    assert colour >= 10  # the two formulas differ on the colour files


def test_grey_formulas_on_every_colour():
    """Both formulas against OpenCV's own conversions over a million
    random colours (libpng's through a PNG file, cvtColor directly)."""
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (1000, 1000, 3), dtype=np.uint8)
    rgb[:10] = rgb[:10, :, :1]  # grey pixels pass unchanged
    np.testing.assert_array_equal(imageio.gray_cvtcolor(rgb),
                                  cv2.cvtColor(rgb[..., ::-1].copy(), cv2.COLOR_BGR2GRAY))
    ok, buf = cv2.imencode(".png", rgb[..., ::-1].copy())
    assert ok
    np.testing.assert_array_equal(imageio.gray_libpng(rgb),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def _refused(tmp_path):
    rng = np.random.default_rng(9)
    rgb = _image(rng, 3).reshape(H, -1)
    grey = _image(rng, 1).reshape(H, -1)
    return {
        "interlaced": (_png(rgb, W, 2, interlace=1), "Adam7-interlaced RGB"),
        "16-bit": (_png(np.repeat(grey, 2, axis=1), W, 0, depth=16), "16-bit greyscale"),
        "2-bit grey": (_png(grey[:, :-(-W // 4)], W, 0, depth=2), "2-bit greyscale"),
        "colour key": (_png(rgb, W, 2, trns=struct.pack(">HHH", 1, 2, 3)), "tRNS colour key"),
        "exif": (_png(rgb, W, 2, chunks=[(b"eXIf", b"MM\x00*")]), "eXIf"),
    }


def test_refused_forms_raise(tmp_path):
    for name, (data, msg) in _refused(tmp_path).items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        for read in (imageio.imread_unchanged, imageio.imread_grayscale,
                     imageio.imread_color_gray):
            with pytest.raises(ValueError, match=msg):
                read(str(path))


def test_colour_managed_grey_read_raises(tmp_path):
    """libpng converts colour to grey in linear light when a gAMA other than
    1.0 or an sRGB chunk is present (OpenCV's grey read then differs from
    the formula), so the grey read refuses those files; the other reads,
    which OpenCV does not gamma-correct, take them, and so does the grey
    read of a greyscale file."""
    rng = np.random.default_rng(4)
    rgb = _image(rng, 3)
    grey = _image(rng, 1)[..., 0]
    for tag, body in ((b"gAMA", struct.pack(">I", 45455)), (b"sRGB", b"\x00")):
        path = str(tmp_path / f"{tag.decode()}.png")
        open(path, "wb").write(_png(rgb.reshape(H, -1), W, 2, chunks=[(tag, body)]))
        assert not np.array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE),
                                  imageio.gray_libpng(rgb))
        with pytest.raises(ValueError, match=tag.decode()):
            imageio.imread_grayscale(path)
        np.testing.assert_array_equal(imageio.imread_unchanged(path),
                                      cv2.imread(path, cv2.IMREAD_UNCHANGED))
        np.testing.assert_array_equal(imageio.imread_color_gray(path),
                                      cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY))
        gpath = str(tmp_path / f"grey_{tag.decode()}.png")
        open(gpath, "wb").write(_png(grey, W, 0, chunks=[(tag, body)]))
        np.testing.assert_array_equal(imageio.imread_grayscale(gpath),
                                      cv2.imread(gpath, cv2.IMREAD_GRAYSCALE))


def test_corrupt_missing_and_other_formats(tmp_path, monkeypatch):
    good = tmp_path / "good.png"
    imageio.write_png(str(good), np.zeros((4, 5), np.uint8))
    data = bytearray(good.read_bytes())
    data[-20] ^= 1  # inside IDAT: its CRC no longer holds
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        imageio.imread_unchanged(str(bad))
    with pytest.raises(FileNotFoundError):
        imageio.imread_grayscale(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "frame.jpg")
    img = _image(np.random.default_rng(2), 3)
    assert cv2.imwrite(jpg, img)
    # with OpenCV: read through it, as the JAX package reads
    np.testing.assert_array_equal(imageio.imread_grayscale(jpg),
                                  cv2.imread(jpg, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(imageio.imread_color_gray(jpg),
                                  cv2.cvtColor(cv2.imread(jpg), cv2.COLOR_BGR2GRAY))
    # without it: a ValueError that names the format
    monkeypatch.setitem(sys.modules, "cv2", None)
    for read in (imageio.imread_unchanged, imageio.imread_grayscale,
                 imageio.imread_color_gray):
        with pytest.raises(ValueError, match="JPEG file"):
            read(jpg)
    np.testing.assert_array_equal(imageio.imread_unchanged(str(good)), np.zeros((4, 5)))
