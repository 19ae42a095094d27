"""PNG reading and writing in numpy and zlib, so the port reads images where
OpenCV is not installed.

The JAX package reads rasters through OpenCV in two ways, and the port
keeps both, bit for bit:

* ``imread_grayscale``: ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, the raster
  read of the runner's image-in path. libpng converts colour to grey as
  ``(9797 R + 19234 G + 3737 B) >> 15``, truncated, and passes a pixel with
  R = G = B through unchanged.
* ``imread_color_gray``: ``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)``,
  the read of ``models/frontend.py::load_image_grayscale``:
  ``(9798 R + 19235 G + 3735 B + 16384) >> 15``.

The two differ by one grey level on about half the pixels of a colour image.
``imread_unchanged`` is ``cv2.IMREAD_UNCHANGED`` (BGR order, alpha last).

The decoder takes 8-bit greyscale, greyscale with alpha, RGB and RGBA, and
palette images of 1, 2, 4 or 8 bits (with a ``tRNS`` alpha table or
without). It checks every chunk's CRC. It refuses, with a ``ValueError``
that names the file and the form, what it does not read as OpenCV does:
Adam7 interlacing, 16-bit and sub-byte greyscale, a ``tRNS`` colour key on a
greyscale or RGB image, an ``eXIf`` chunk (OpenCV turns the image by its
orientation) and, for ``imread_grayscale`` of a colour image, a ``gAMA``
other than 1.0, ``sRGB`` or ``iCCP`` chunk (libpng then converts in linear
light). The rows are unfiltered by the port's native host library
(``native/png_unfilter.cpp``) where it is built, else by
``unfilter_plain``. A file that is not a PNG is read through OpenCV where
it imports, and raises a ``ValueError`` naming its format where it does not.

``write_png`` writes 8-bit greyscale and RGB images with a chosen filter
type per row, for the fixtures of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Sequence

import numpy as np

from msckf_tpu_torch.data import native_io

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOR_TYPES = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale with alpha", 6: "RGBA"}
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the chunks that make libpng convert colour to grey in linear light
_COLOR_MANAGED = ("gAMA", "sRGB", "iCCP")
_UNITY_GAMMA = 100000

# magic numbers of the other formats OpenCV reads, to name them
_MAGIC = (
    (b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
    (b"RIFF", "WebP"), (b"GIF8", "GIF"), (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
    (b"P5", "PGM"), (b"P6", "PPM"), (b"\x76\x2f\x31\x01", "OpenEXR"),
)


class PngImage(NamedTuple):
    """A decoded PNG: ``pixels`` (H, W, C) uint8 with C = 1 (grey), 2 (grey,
    alpha), 3 (RGB) or 4 (RGBA), a palette expanded to RGB, or to RGBA with a
    tRNS table; ``color_type`` the file's; ``color_managed`` the names of the
    gAMA (other than 1.0), sRGB and iCCP chunks it holds."""

    pixels: np.ndarray
    color_type: int
    color_managed: tuple


def _refuse(name: str, what: str):
    raise ValueError(f"{name}: {what} is not supported by msckf_tpu_torch.data.imageio")


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk header at byte {pos}")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r} at byte {pos}")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: CRC mismatch in PNG chunk {ctype!r} at byte {pos}")
        yield ctype.decode("latin-1"), body
        pos = end + 4


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_plain(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) unfiltered rows of a PNG's inflated data, in numpy
    (None, Sub, Up) and Python (Average and Paeth, which predict each byte
    from the reconstructed byte to its left): the plain version of
    ``native/png_unfilter.cpp``."""
    rows = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    for r in range(h):
        ft, f = int(rows[r, 0]), rows[r, 1:]
        up = out[r - 1] if r else zero
        if ft == 0:
            out[r] = f
        elif ft == 1:
            # Sub: a running sum (mod 256) of each byte of the pixel
            n = -(-stride // bpp) * bpp
            pad = np.zeros(n, np.uint8)
            pad[:stride] = f
            out[r] = np.cumsum(pad.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif ft == 2:
            out[r] = f + up
        elif ft in (3, 4):
            fb, ub = f.tolist(), up.tolist()
            cur = [0] * stride
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ft == 3:
                    cur[i] = (fb[i] + ((a + ub[i]) >> 1)) & 255
                else:
                    c = ub[i - bpp] if i >= bpp else 0
                    cur[i] = (fb[i] + _paeth(a, ub[i], c)) & 255
            out[r] = cur
        else:
            raise ValueError(f"PNG row {r} has filter type {ft}, not 0 to 4")
    return out


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Unfiltered rows, by the native library where it is built."""
    out = native_io.png_unfilter_native(raw, h, stride, bpp)
    return unfilter_plain(raw, h, stride, bpp) if out is None else out


def decode_png(data: bytes, name: str = "<bytes>") -> PngImage:
    """A PNG file's bytes as a ``PngImage``."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    ihdr = plte = trns = None
    idat, managed = [], []
    ended = False
    for ctype, body in _chunks(data, name):
        if ctype == "IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == "PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == "tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == "IDAT":
            idat.append(body)
        elif ctype == "eXIf":
            _refuse(name, "a PNG with an eXIf chunk (OpenCV applies its orientation)")
        elif ctype == "gAMA":
            if struct.unpack(">I", body)[0] != _UNITY_GAMMA:
                managed.append(ctype)
        elif ctype in _COLOR_MANAGED:
            managed.append(ctype)
        elif ctype == "IEND":
            ended = True
            break
    if ihdr is None or not ended:
        raise ValueError(f"{name}: PNG without {'IHDR' if ihdr is None else 'IEND'}")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in COLOR_TYPES or comp != 0 or filt != 0:
        raise ValueError(f"{name}: invalid PNG header (colour type {ctype}, compression "
                         f"{comp}, filter method {filt})")
    kind = COLOR_TYPES[ctype]
    if interlace:
        _refuse(name, f"an Adam7-interlaced {kind} PNG")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        _refuse(name, f"a {depth}-bit {kind} PNG")
    if trns is not None and ctype != 3:
        _refuse(name, f"a {kind} PNG with a tRNS colour key")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    stride = -(-w * bits // 8)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data holds {raw.size} bytes, not {h} rows of "
                         f"{stride + 1}")
    rows = unfilter(raw, h, stride, max(1, bits // 8))
    if ctype != 3:
        return PngImage(rows.reshape(h, w, ch), ctype, tuple(managed))
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    else:
        idx = rows
    if int(idx.max(initial=0)) >= len(plte):
        _refuse(name, f"a palette index past the {len(plte)}-entry PLTE")
    pixels = plte[idx]
    if trns is not None:
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(plte)]
        pixels = np.concatenate([pixels, alpha[idx][..., None]], axis=-1)
    return PngImage(pixels, ctype, tuple(managed))


def read_png(path: str) -> PngImage:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def gray_libpng(rgb: np.ndarray) -> np.ndarray:
    """libpng's colour-to-grey (OpenCV's ``IMREAD_GRAYSCALE``) of (..., 3)
    uint8 RGB: truncated, and exact where R = G = B."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (g == b), r, y).astype(np.uint8)


def gray_cvtcolor(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's ``cvtColor(COLOR_BGR2GRAY)`` of (..., 3) uint8 RGB: rounded."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(np.uint8)


def _format_of(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(16)
    for magic, fmt in _MAGIC:
        if head.startswith(magic):
            return fmt
    return "unrecognised"


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE


def _cv2_read(path: str, flag_name: str) -> np.ndarray:
    """A file that is not a PNG, through OpenCV where it imports."""
    fmt = _format_of(path)
    try:
        import cv2
    except ImportError:
        raise ValueError(f"{path}: a {fmt} file; without OpenCV only PNG files are read") \
            from None
    img = cv2.imread(path, getattr(cv2, flag_name))
    if img is None:
        raise FileNotFoundError(f"image not readable: {path}")
    return img


def imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: (H, W) grey, (H, W, 3) BGR
    or (H, W, 4) BGRA (greyscale with alpha as grey, grey, grey, alpha)."""
    if not _is_png(path):
        return _cv2_read(path, "IMREAD_UNCHANGED")
    px = read_png(path).pixels
    ch = px.shape[-1]
    if ch == 1:
        return px[..., 0]
    if ch == 2:
        return px[..., [0, 0, 0, 1]]
    return px[..., [2, 1, 0, 3][:ch]]


def imread_grayscale(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` as (H, W) uint8: grey as
    it is, alpha dropped, colour by ``gray_libpng``."""
    if not _is_png(path):
        return _cv2_read(path, "IMREAD_GRAYSCALE")
    img = read_png(path)
    if img.pixels.shape[-1] <= 2:
        return img.pixels[..., 0]
    if img.color_managed:
        _refuse(path, f"the grey read of a {COLOR_TYPES[img.color_type]} PNG with "
                      f"{'/'.join(img.color_managed)} (libpng converts in linear light)")
    return gray_libpng(img.pixels[..., :3])


def imread_color_gray(path: str) -> np.ndarray:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)`` as (H, W)
    uint8: alpha dropped, colour by ``gray_cvtcolor`` (grey as it is)."""
    if not _is_png(path):
        img = _cv2_read(path, "IMREAD_COLOR")
        import cv2  # it imported in _cv2_read

        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    px = read_png(path).pixels
    return px[..., 0] if px.shape[-1] <= 2 else gray_cvtcolor(px[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _filter_rows(px: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride): each row's filter type, then its filtered bytes."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[types, np.arange(len(x))]
    return np.concatenate([types[:, None], (x - pred) & 255], axis=1).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filters: int | Sequence[int] = 0) -> None:
    """An 8-bit greyscale (H, W) or RGB (H, W, 3) uint8 image as a PNG file.
    ``filters``: one filter type (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    for every row, or a sequence whose entries rows take in turn."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write a (H, W) or (H, W, 3) uint8 image, not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    seq = [filters] if isinstance(filters, (int, np.integer)) else list(filters)
    if not seq or any(not 0 <= int(f) <= 4 for f in seq):
        raise ValueError(f"filter types are 0 to 4, not {seq}")
    types = np.resize(np.asarray(seq, np.int64), h)
    data = _filter_rows(img.reshape(h, w * ch), types, ch)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data.tobytes(), 6)) + _chunk(b"IEND", b""))
