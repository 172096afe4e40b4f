"""Write the image decoders' fixtures with PIL (not a test module).

``python tests/torch_image_fixtures.py`` writes
``curvature_tpu_torch/data/fixtures/images/``: image files of every format
and variant ``curvature_tpu_torch/data/images.py`` reads, made from
seeded numpy images (:func:`fixture_image`: flat patches, hard edges and a
gradient with mild noise, so the AC coefficients, the clipping and the
chroma all do some work), and
``expected.npz``:

* ``<file name>``: PIL's ``Image.open(path).convert("RGB")`` of each
  file, uint8 ``[H, W, 3]``;
* ``batch224``, ``labels224`` and ``batch64``, ``labels64``: the JAX
  package's ``ImageFolderLoader.load_batch`` at 224² (one image) and 64²
  (six) over :func:`folder_tree`'s ``train`` folder (PIL's decode and
  resize, JAX's normalization), ``files224``/``files64`` the files in
  them.

The card's machine has no PIL: ``chip_smoke.py`` holds the port's
decoders to these arrays there. PIL cannot write an Adam7-interlaced PNG,
a 16-bit PNG of some modes or a 16-bit-bitfield BMP, so :func:`png_bytes`
and :func:`bmp_bytes` write those by hand. The tests import this module
for its writers and file list; it imports PIL only inside functions.
"""
import io
import os
import shutil
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "curvature_tpu_torch" / "data" / "fixtures" / "images"
SEED = 18
#: folder_tree's classes, each a list of fixture names
TREE = {"n01": ["jpeg_420_q75_500x375.jpg", "jpeg_444.jpg",
                "jpeg_grey.jpg", "jpeg_cmyk.jpg"],
        "n02": ["jpeg_420_q95_375x500.jpg", "jpeg_progressive.jpg",
                "png_as_jpeg.JPEG", "png_rgba.png"],
        "n03": ["jpeg_420_q75_333x500.jpg", "jpeg_422.jpg",
                "ppm_p6.ppm", "bmp_24.bmp"]}


def fixture_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """uint8 RGB ``[h, w, 3]``: flat patches of saturated colours with hard
    edges (ringing, clipping, chroma), a red ring, and a gradient patch
    with mild noise (AC coefficients). Flat areas keep ``expected.npz``
    small: PIL's decode of a gradient-filled 500x375 image does not
    compress below ~280 KB."""
    a = np.empty((h, w, 3), np.float64)
    a[:] = rng.uniform(0, 255, 3)
    for _ in range(12):
        y0, x0 = rng.integers(0, max(h - 8, 1)), rng.integers(0, max(w - 8, 1))
        a[y0:y0 + rng.integers(1, max(h // 2, 2)),
          x0:x0 + rng.integers(1, max(w // 2, 2))] = rng.choice(
              [0, 40, 128, 200, 255], 3)
    yy, xx = np.mgrid[0:h, 0:w]
    ring = np.hypot(yy - h / 2, xx - w / 2)
    r = min(h, w) / 4
    a[(ring > r) & (ring < r * 1.15)] = [255, 0, 0]
    ph, pw = max(h // 4, 1), max(w // 4, 1)
    y0, x0 = rng.integers(0, h - ph + 1), rng.integers(0, w - pw + 1)
    a[y0:y0 + ph, x0:x0 + pw] += (rng.normal(0, 4, (ph, pw, 3))
                                  + np.linspace(0, 60, pw)[None, :, None])
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def png_bytes(w: int, h: int, depth: int, color_type: int, rows: bytes,
              interlace: int = 0, plte: bytes = None) -> bytes:
    """A PNG from its already filtered (filter byte per row) scanlines."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if plte:
        out += chunk(b"PLTE", plte)
    return out + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b"")


def png_rows(arr: np.ndarray, depth: int, filt: int = 0) -> bytes:
    """``[h, w, c]`` samples as scanlines of one filter type (0 = None,
    1 = Sub; multi-byte samples big-endian, sub-byte ones packed)."""
    out = b""
    for r in arr.reshape(arr.shape[0], -1):
        if depth == 16:
            line = r.astype(">u2").tobytes()
        elif depth == 8:
            line = r.astype(np.uint8).tobytes()
        else:
            bits = np.unpackbits(r.astype(np.uint8)[:, None], axis=1)
            line = np.packbits(bits[:, 8 - depth:].reshape(-1)).tobytes()
        if filt == 1:
            bpp = max(1, arr.shape[2] * depth // 8)
            raw = np.frombuffer(line, np.uint8).astype(np.int32)
            prev = np.concatenate([np.zeros(bpp, np.int32), raw[:-bpp]])
            line = ((raw - prev) % 256).astype(np.uint8).tobytes()
        out += bytes([filt]) + line
    return out


def adam7_rows(arr: np.ndarray, depth: int) -> bytes:
    out = b""
    for xs, ys, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)):
        sub = arr[ys::dy, xs::dx]
        if sub.size:
            out += png_rows(sub, depth, filt=1)
    return out


def bmp_bytes(w: int, h: int, bits: int, pixels: bytes, compression: int = 0,
              palette: bytes = b"", masks=None, top_down: bool = False
              ) -> bytes:
    """A BMP with a 40-byte header (masks after it for bitfields)."""
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                       compression, len(pixels), 2835, 2835,
                       len(palette) // 4, 0)
    extra = struct.pack("<III", *masks) if masks else b""
    off = 14 + len(info) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + extra + palette + pixels)


def _save(im, fmt, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def fixture_files(rng: np.random.Generator) -> dict:
    """{file name: bytes} of every fixture."""
    from PIL import Image
    f = {}
    for (h, w), q in (((375, 500), 75), ((500, 375), 95), ((500, 333), 75),
                      ((375, 500), 95), ((500, 375), 75), ((500, 333), 95)):
        im = Image.fromarray(fixture_image(rng, h, w))
        f[f"jpeg_420_q{q}_{w}x{h}.jpg"] = _save(im, "JPEG", quality=q)
    mid = Image.fromarray(fixture_image(rng, 120, 160))
    f["jpeg_422.jpg"] = _save(mid, "JPEG", quality=85, subsampling=1)
    f["jpeg_444.jpg"] = _save(mid, "JPEG", quality=85, subsampling=0)
    f["jpeg_grey.jpg"] = _save(mid.convert("L"), "JPEG", quality=85)
    f["jpeg_progressive.jpg"] = _save(
        Image.fromarray(fixture_image(rng, 150, 200)), "JPEG", quality=85,
        progressive=True)
    f["jpeg_optimize.jpg"] = _save(mid, "JPEG", quality=80, optimize=True)
    f["jpeg_restart.jpg"] = _save(mid, "JPEG", quality=80,
                                  restart_marker_blocks=4)
    f["jpeg_cmyk.jpg"] = _save(mid.convert("CMYK"), "JPEG", quality=85)
    f["jpeg_17x23.jpg"] = _save(Image.fromarray(fixture_image(rng, 17, 23)),
                                "JPEG", quality=90)
    f["jpeg_1x1.jpg"] = _save(Image.fromarray(fixture_image(rng, 1, 1)),
                              "JPEG", quality=90)
    f["png_as_jpeg.JPEG"] = _save(
        Image.fromarray(fixture_image(rng, 90, 110)), "PNG")
    small = Image.fromarray(fixture_image(rng, 45, 61))
    f["png_rgb.png"] = _save(small, "PNG")
    f["png_rgba.png"] = _save(small.convert("RGBA"), "PNG")
    f["png_l.png"] = _save(small.convert("L"), "PNG")
    f["png_la.png"] = _save(small.convert("LA"), "PNG")
    pal = small.convert("P", palette=Image.ADAPTIVE, colors=64)
    f["png_p_trns.png"] = _save(pal, "PNG", transparency=5)
    f["png_1bit.png"] = _save(small.convert("1"), "PNG")
    # 0..765: Pillow's I;16 -> RGB clips the upper two thirds at 255
    g16 = fixture_image(rng, 21, 27)[..., 0].astype(np.uint16) * 3
    f["png_grey16.png"] = _save(Image.fromarray(g16), "PNG")
    f["png_adam7.png"] = png_bytes(
        29, 23, 8, 2, adam7_rows(fixture_image(rng, 23, 29), 8), interlace=1)
    f["ppm_p6.ppm"] = _save(Image.fromarray(fixture_image(rng, 29, 31)),
                            "PPM")
    f["ppm_p5.ppm"] = _save(small.convert("L"), "PPM")
    f["bmp_24.bmp"] = _save(small, "BMP")
    f["bmp_32.bmp"] = _save(small.convert("RGBA"), "BMP")
    f["bmp_8bit.bmp"] = _save(pal, "BMP")
    f["bmp_1bit.bmp"] = _save(small.convert("1"), "BMP")
    px = rng.integers(0, 1 << 16, (9, 11)).astype("<u2")
    rows = b"".join(r.tobytes() + b"\0\0" for r in px)   # 22 -> 24 bytes
    f["bmp_16_565.bmp"] = bmp_bytes(11, 9, 16, rows, compression=3,
                                    masks=(0xF800, 0x7E0, 0x1F),
                                    top_down=True)
    return f


def folder_tree(dst: Path, src: Path = OUT) -> Path:
    """``dst/train/<class>/`` of :data:`TREE`'s fixtures (copies)."""
    for cls, names in TREE.items():
        d = dst / "train" / cls
        d.mkdir(parents=True, exist_ok=True)
        for name in names:
            shutil.copyfile(src / name, d / name)
    return dst / "train"


def main() -> None:
    from PIL import Image
    sys.path.insert(0, str(REPO))
    from curvature_tpu.data import loaders as jloaders
    rng = np.random.default_rng(SEED)
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    expected = {}
    for name, data in fixture_files(rng).items():
        (OUT / name).write_bytes(data)
        expected[name] = np.asarray(Image.open(OUT / name).convert("RGB"))
    tmp = OUT.parent / "_tree"
    try:
        root = folder_tree(tmp)
        for size, sel in ((224, [0]), (64, [0, 3, 6, 9, 10, 11])):
            loader = jloaders.ImageFolderLoader(str(root), size)
            x, y = loader.load_batch(sel)
            expected[f"batch{size}"] = x
            expected[f"labels{size}"] = y
            expected[f"files{size}"] = np.array(
                [os.path.relpath(loader.samples[j][0], root) for j in sel])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    np.savez_compressed(OUT / "expected.npz", **expected)
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(expected)} arrays, {len(list(OUT.iterdir()))} files, "
          f"{total} bytes in {OUT}")


if __name__ == "__main__":
    main()
