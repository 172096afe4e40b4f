"""Image files as the JAX loader reads them, without PIL.

The JAX package's image-folder loader (``curvature_tpu/data/loaders.py``
``ImageFolderLoader._load``) opens each file with
``PIL.Image.open(path).convert("RGB")``, resizes it with ``Image.resize``
(bicubic) and center-crops it. The card's machine has no PIL, so the port
decodes and resizes with its own code, held bit for bit to PIL's
(``tests/test_torch_images.py``):

* :func:`open_rgb` sniffs the format from the magic bytes, as PIL does
  (ImageNet's train set holds a PNG named ``.JPEG``), and returns uint8
  ``[H, W, 3]``. JPEG (libjpeg-turbo's default decode) and PNG (filters,
  Adam7, Pillow's mode rules) decode in ``csrc/images.cpp``; PNG's zlib
  stream inflates through Python's ``zlib``. PPM/PGM/PBM and BMP are byte
  shuffles, done in numpy here after Pillow's plugins
  (``PpmImagePlugin``, ``BmpImagePlugin``: maxval scaling by Python's
  ``round``, palettes, bitfields, RLE4/RLE8).
* :func:`resize` is Pillow's bicubic ``Image.resize`` (``csrc/images.cpp``,
  fixed point), :func:`resize_plain` its numpy version.
* :func:`load_image` is JAX's ``_load``: shorter side to ``int(s*8/7)``,
  center crop ``s``, ``/ 255`` in float32.

The C++ library is built with ``g++`` at first use (``data/native.py``)
and its calls drop the GIL, so ``data.prefetch.ParallelDecodeLoader``'s
threads decode at once.
"""
import ctypes
import functools
import re
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

from curvature_tpu_torch.data import native

SOURCE = Path(__file__).resolve().parent / "csrc" / "images.cpp"
#: contracted multiply-adds would change the resampler's weights
GXX_FLAGS = ("-ffp-contract=off",)
_ERRLEN = 512


class ImageDecodeError(OSError):
    """A file the decoders cannot read (PIL raises ``OSError`` too)."""


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = native.load(SOURCE, "curvimages", GXX_FLAGS)
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ct_jpeg_info.argtypes = [p, i64, ip, ip, ip, ctypes.c_char_p, i]
    lib.ct_jpeg_decode.argtypes = [p, i64, p, i64, ctypes.c_char_p, i]
    lib.ct_png_decode.argtypes = [p, i64, i, i, i, i, i, p, i, p,
                                  ctypes.c_char_p, i]
    lib.ct_resize_bicubic.argtypes = [p, i, i, p, i, i, ctypes.c_char_p, i]
    for f in (lib.ct_jpeg_info, lib.ct_jpeg_decode, lib.ct_png_decode,
              lib.ct_resize_bicubic):
        f.restype = ctypes.c_int
    return lib


def _check(rc: int, err) -> None:
    if rc:
        raise ImageDecodeError(err.value.decode(errors="replace"))


# -- formats ------------------------------------------------------------------

def sniff(head: bytes):
    """``"jpeg"``, ``"png"``, ``"ppm"`` or ``"bmp"`` from a file's first
    bytes, else None."""
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if len(head) >= 2 and head[:1] == b"P" and head[1:2] in b"123456":
        return "ppm"
    if head[:2] == b"BM":
        return "bmp"
    return None


def decode_jpeg(data: bytes) -> np.ndarray:
    lib = _lib()
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, c = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _check(lib.ct_jpeg_info(data, len(data), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c), err, _ERRLEN),
           err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.ct_jpeg_decode(data, len(data), out.ctypes.data, out.size,
                              err, _ERRLEN), err)
    return out


def decode_png(data: bytes) -> np.ndarray:
    pos, ihdr, palette, idat = 8, None, b"", []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            break
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    else:
        raise ImageDecodeError("image file is truncated (no IEND chunk)")
    if ihdr is None or not idat:
        raise ImageDecodeError("broken PNG file: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if (ctype, depth) not in {(0, 1), (0, 2), (0, 4), (0, 8), (0, 16),
                              (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
                              (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)}:
        raise ImageDecodeError(f"unknown PNG mode: colour type {ctype}, "
                               f"bit depth {depth}")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageDecodeError(f"image file is truncated ({e})") from e
    pal = np.frombuffer(palette[:len(palette) // 3 * 3] or b"\0\0\0",
                        np.uint8)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(_lib().ct_png_decode(raw, len(raw), w, h, depth, ctype,
                                interlace, pal.ctypes.data,
                                len(palette) // 3, out.ctypes.data, err,
                                _ERRLEN), err)
    return out


_WS = b" \t\n\r\x0b\x0c"


def _ppm_header(data: bytes, count: int):
    """PIL's header tokens (``#`` comments to the end of the line) and the
    offset just past the whitespace byte after the last."""
    pos, tokens = 2, []
    while pos < len(data) and data[pos:pos + 1] not in _WS:
        pos += 1     # rest of the magic
    pos += 1
    while len(tokens) < count:
        tok = b""
        while True:
            if pos >= len(data):
                raise ImageDecodeError("Reached EOF while reading header")
            c = data[pos:pos + 1]
            pos += 1
            if c in _WS:
                if tok:
                    break
            elif c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
            else:
                tok += c
        tokens.append(int(tok))
    return tokens, pos


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """Pillow's ``round(value / maxval * out_max)`` (Python's round is
    half to even, as ``np.round``)."""
    return np.round(v.astype(np.float64) / maxval * out_max)


def decode_ppm(data: bytes) -> np.ndarray:
    magic = data[1:2]
    bands = 3 if magic in b"36" else 1
    if magic in b"14":
        (w, h), pos = _ppm_header(data, 2)
        if magic == b"4":
            stride = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, h * stride, pos)
            bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
        else:
            body = re.sub(rb"#[^\r\n]*(\r|\n|$)", b"", data[pos:])
            toks = np.frombuffer(b"".join(body.split())[:w * h], np.uint8)
            if toks.size < w * h or not np.isin(toks, (48, 49)).all():
                raise ImageDecodeError("not enough image data")
            bits = (toks - 48).reshape(h, w)
        grey = np.where(bits == 1, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=2)
    (w, h, maxval), pos = _ppm_header(data, 3)
    if not 0 < maxval < 65536:
        raise ImageDecodeError(
            "maxval must be greater than 0 and less than 65536")
    n = w * h * bands
    mode_i = bands == 1 and maxval > 255        # Pillow's mode "I"
    out_max = 65535 if mode_i else 255
    if magic in b"23":
        body = re.sub(rb"#[^\r\n]*(\r|\n|$)", b"", data[pos:])
        vals = np.array([int(t) for t in body.split()[:n]], np.int64)
        if vals.size < n:
            raise ImageDecodeError("not enough image data")
        if (vals > maxval).any():
            raise ImageDecodeError("Channel value too large for this mode")
        v = _scale(vals, maxval, out_max)
    else:
        wide = maxval > 255
        avail = (len(data) - pos) // (2 if wide else 1)
        if avail < n:
            raise ImageDecodeError("image file is truncated")
        v = np.frombuffer(data, ">u2" if wide else np.uint8, n, pos)
        if maxval != 255 and not (mode_i and maxval == 65535):
            v = np.minimum(out_max, _scale(v, maxval, out_max))
    v = np.clip(v, 0, 255).astype(np.uint8).reshape(h, w, bands)
    return v if bands == 3 else np.repeat(v, 3, axis=2)


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """Pillow's ``BmpRleDecoder`` (a two-byte delta reads two more bytes
    for its offsets, as there)."""
    out = bytearray()
    x, n = 0, w * h

    def read(k):
        nonlocal pos
        b = data[pos:pos + k]
        pos += len(b)
        return b

    while len(out) < n:
        pixels, byte = read(1), read(1)
        if not pixels or not byte:
            break
        count = pixels[0]
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                hi, lo = bytes([byte[0] >> 4]), bytes([byte[0] & 15])
                for i in range(count):
                    out += hi if i % 2 == 0 else lo
            else:
                out += byte * count
            x += count
        elif byte[0] == 0:
            while len(out) % w != 0:
                out += b"\0"
            x = 0
        elif byte[0] == 1:
            break
        elif byte[0] == 2:
            if len(read(2)) < 2:
                break
            right, up = read(2)
            out += b"\0" * (right + up * w)
            x = len(out) % w
        else:
            k = byte[0] // 2 if rle4 else byte[0]
            got = read(k)
            if rle4:
                for b in got:
                    out += bytes([b >> 4, b & 15])
            else:
                out += got
            if len(got) < k:
                break
            x += byte[0]
            if pos % 2:
                pos += 1
    if len(out) < n:
        raise ImageDecodeError("not enough image data")
    return bytes(out[:n])


_BMP_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
         (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)},
    24: {(0xFF0000, 0xFF00, 0xFF)},
    16: {(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)},
}


def decode_bmp(data: bytes) -> np.ndarray:
    """Pillow's ``BmpImagePlugin`` and its raw unpackers, then
    ``convert("RGB")``."""
    def i16(o):
        return struct.unpack_from("<H", data, o)[0]

    def i32(o):
        return struct.unpack_from("<I", data, o)[0]

    try:
        offset, hsize = i32(10), i32(14)
        pos = 18 + max(hsize - 4, 0)
        masks = None
        if hsize == 12:
            w, h, bits = i16(18), i16(20), i16(24)
            comp, colors, pad, direction = 0, 0, 3, -1
        elif hsize in (40, 52, 56, 64, 108, 124):
            flip = data[18 + 7] == 0xFF
            direction = 1 if flip else -1
            w = i32(18)
            h = 2 ** 32 - i32(22) if flip else i32(22)
            bits, comp, colors, pad = i16(28), i32(30), i32(46), 4
            if comp == 3:
                if hsize - 4 >= 48:
                    a = i32(18 + 48) if hsize - 4 >= 52 else 0
                    masks = (i32(54), i32(58), i32(62), a)
                else:
                    masks = (i32(pos), i32(pos + 4), i32(pos + 8), 0)
                    pos += 12
        else:
            raise ImageDecodeError(f"Unsupported BMP header type ({hsize})")
    except struct.error as e:
        raise ImageDecodeError("image file is truncated") from e
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    raw = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
           32: "BGRX"}.get(bits)
    if raw is None:
        raise ImageDecodeError(f"Unsupported BMP pixel depth ({bits})")
    if comp == 3:
        key = masks if bits == 32 else masks[:3]
        if key not in _BMP_MASKS.get(bits, ()):
            raise ImageDecodeError("Unsupported BMP bitfields layout")
        if bits == 16:
            raw = "BGR;16" if masks[0] == 0xF800 else "BGR;15"
        elif bits == 32 and any(masks):
            raw = masks
    elif comp not in (0, 1, 2):
        raise ImageDecodeError(f"Unsupported BMP compression ({comp})")
    table = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ImageDecodeError(f"Unsupported BMP Palette size ({colors})")
        pal = data[pos:pos + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad:i * pad + 3] == bytes([v]) * 3
               for i, v in enumerate(ramp)):
            raw = "1" if colors == 2 else "L"
        else:
            p = np.frombuffer(pal[:len(pal) // pad * pad], np.uint8)
            p = p.reshape(-1, pad)[:256, 2::-1]
            table = np.zeros((256, 3), np.uint8)
            table[:len(p)] = p
    if comp in (1, 2):
        idx = np.frombuffer(_bmp_rle(data, offset, w, h, comp == 2),
                            np.uint8).reshape(h, w)
        img = table[idx] if table is not None else np.repeat(
            (idx if raw != "1" else idx * 255)[..., None], 3, axis=2)
        return np.ascontiguousarray(img[::-1] if direction < 0 else img)
    stride = ((w * bits + 31) >> 3) & ~3
    if len(data) < offset + stride * h:
        raise ImageDecodeError("image file is truncated")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if direction < 0:
        rows = rows[::-1]
    if raw in ("P;1", "1"):
        v = np.unpackbits(rows, axis=1)[:, :w]
        img = table[v] if table is not None else np.repeat(
            (v * 255)[..., None], 3, axis=2)
    elif raw == "P;4":
        v = np.stack([rows >> 4, rows & 15], axis=2).reshape(h, -1)[:, :w]
        img = table[v]
    elif raw in ("P", "L"):
        v = rows[:, :w]
        img = table[v] if table is not None else np.repeat(v[..., None], 3,
                                                           axis=2)
    elif raw in ("BGR;15", "BGR;16"):
        px = rows[:, :2 * w].reshape(h, w, 2).astype(np.int32)
        px = px[..., 0] | (px[..., 1] << 8)
        if raw == "BGR;15":
            r, g = (px >> 10) & 31, ((px >> 5) & 31) * 255 // 31
        else:
            r, g = (px >> 11) & 31, ((px >> 5) & 63) * 255 // 63
        img = np.stack([r * 255 // 31, g, (px & 31) * 255 // 31], axis=2)
    elif raw == "BGR":
        img = rows[:, :3 * w].reshape(h, w, 3)[..., ::-1]
    elif raw == "BGRX":
        img = rows[:, :4 * w].reshape(h, w, 4)[..., 2::-1]
    else:                                   # 32-bit bitfields, byte masks
        px = rows[:, :4 * w].reshape(h, w, 4).copy().view("<u4")[..., 0]
        img = np.stack([(px & m) >> (int(m).bit_length() - 8)
                        for m in raw[:3]], axis=2)
    return np.ascontiguousarray(img, np.uint8)


_DECODERS = {"jpeg": decode_jpeg, "png": decode_png, "ppm": decode_ppm,
             "bmp": decode_bmp}


def open_rgb(path) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path).convert("RGB"))``: uint8
    ``[H, W, 3]``. Raises :class:`ImageDecodeError` naming the path for a
    file it cannot read, an unknown format included."""
    data = Path(path).read_bytes()
    kind = sniff(data[:8])
    if kind is None:
        raise ImageDecodeError(
            f"cannot identify image file {str(path)!r}: not a JPEG, PNG, "
            f"PPM/PGM/PBM or BMP file (first bytes {data[:8]!r})")
    try:
        return _DECODERS[kind](data)
    except ImageDecodeError as e:
        raise ImageDecodeError(f"{path}: {e}") from None


# -- resize and crop ----------------------------------------------------------

def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize((W, H))`` (bicubic) of uint8 RGB ``[h, w, 3]``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"resize takes RGB [h, w, 3], got {img.shape}")
    out_w, out_h = size
    out = np.empty((out_h, out_w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(_lib().ct_resize_bicubic(img.ctypes.data, img.shape[1],
                                    img.shape[0], out.ctypes.data, out_w,
                                    out_h, err, _ERRLEN), err)
    return out


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: each
    output index's first input index, tap count and 22-bit weights."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds, kk = [], np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = 0.0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = np.array([float(_bicubic(np.float64(
            (x + xmin - center + 0.5) * (1.0 / fscale))))
            for x in range(xmax)])
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = [int(-0.5 + v * (1 << 22)) if v < 0
                         else int(0.5 + v * (1 << 22)) for v in w]
        bounds.append((xmin, xmax))
    return bounds, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    bounds, kk = _coeffs(in_size, out_size)
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.empty((out_size,) + x.shape[1:], np.uint8)
    for i, (xmin, xmax) in enumerate(bounds):
        s = (1 << 21) + np.tensordot(kk[i, :xmax], x[xmin:xmin + xmax],
                                     axes=1)
        out[i] = np.clip(s >> 22, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_plain(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Numpy version of :func:`resize`, the same arithmetic."""
    img = np.asarray(img, np.uint8)
    out_w, out_h = size
    if out_w != img.shape[1]:
        img = _pass(img, out_w, 1)
    if out_h != img.shape[0]:
        img = _pass(img, out_h, 0)
    return np.array(img, np.uint8)


def center_crop(img: np.ndarray, s: int) -> np.ndarray:
    """PIL's ``crop((left, top, left + s, top + s))`` at
    ``((w - s) // 2, (h - s) // 2)``."""
    h, w = img.shape[:2]
    left, top = (w - s) // 2, (h - s) // 2
    return img[top:top + s, left:left + s]


def load_image(path, size: int) -> np.ndarray:
    """JAX's ``ImageFolderLoader._load``: shorter side to
    ``int(size * 8 / 7)`` (Python's round, never below ``size``), center
    crop, float32 in [0, 1]."""
    img = open_rgb(path)
    s = size
    h, w = img.shape[:2]
    scale = int(s * 8 / 7) / min(w, h)
    img = resize(img, (max(s, round(w * scale)), max(s, round(h * scale))))
    return np.asarray(center_crop(img, s), np.float32) / 255.0
