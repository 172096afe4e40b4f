"""The port's image decoders, resize and image-folder loaders against PIL
and the JAX package's loader, exactly.

``curvature_tpu_torch/data/images.py`` (C++ in ``data/csrc/images.cpp``,
built with g++ into ``build/`` at first use) replaces PIL, which the
card's machine lacks. Every comparison here is ``assert_array_equal``:
the decoded uint8 pixels against ``Image.open(p).convert("RGB")``, the
resize against ``Image.resize``, and the float32 batches against JAX's
``ImageFolderLoader`` (which runs PIL here). The committed fixtures are
``tests/torch_image_fixtures.py``'s; the files written into ``tmp_path``
come from seeded numpy images.
"""
import io
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from curvature_tpu.data import loaders as jloaders
from curvature_tpu.data import prefetch as jprefetch
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import factors as jfactors
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import images as timages
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.data import native as tnative
from curvature_tpu_torch.data import prefetch as tprefetch
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import factors as tfactors
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig
from tests import torch_image_fixtures as F

torch.set_num_threads(1)

FIXTURES = sorted(p.name for p in F.OUT.iterdir() if p.name != "expected.npz")


def _pil(path_or_bytes) -> np.ndarray:
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) \
        else path_or_bytes
    return np.asarray(Image.open(src).convert("RGB"))


def _save(im, fmt, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


@pytest.fixture(scope="module")
def expected():
    return np.load(F.OUT / "expected.npz")


# -- the committed fixtures ---------------------------------------------------

def test_fixture_set_is_whole_and_small(expected):
    """Every fixture has its expected array and the tree stays under
    1.5 MB (the card gets it in every checkout)."""
    assert len(FIXTURES) >= 30
    assert set(FIXTURES) <= set(expected.files)
    assert sum(p.stat().st_size for p in F.OUT.iterdir()) < 1.5e6


@pytest.mark.parametrize("name", FIXTURES)
def test_expected_npz_is_pils_decode(expected, name):
    """``expected.npz`` still equals PIL's decode (the fixtures have not
    drifted from what the chip check holds the port to)."""
    np.testing.assert_array_equal(_pil(F.OUT / name), expected[name])


@pytest.mark.parametrize("name", FIXTURES)
def test_open_rgb_matches_pil_on_fixture(name):
    got = timages.open_rgb(F.OUT / name)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil(F.OUT / name))


# -- files written here, from seeds ---------------------------------------------

JPEG_CASES = [(q, sub, prog, size)
              for q in (10, 50, 90)
              for sub, prog in ((0, False), (1, False), (2, False), (2, True))
              for size in ((37, 53),)] + [
    (75, 2, False, (3, 3)), (75, 2, False, (5, 5)), (75, 1, False, (9, 2)),
    (75, 2, True, (2, 9)), (90, 2, False, (375, 500)),
    (90, 1, True, (33, 65))]


@pytest.mark.parametrize("q,sub,prog,size", JPEG_CASES)
def test_open_rgb_matches_pil_on_seeded_jpegs(tmp_path, q, sub, prog, size):
    """Qualities 10/50/90, 4:4:4, 4:2:2, 4:2:0 and progressive, at odd
    sizes (components 1 and 2 samples wide take the box upsampler)."""
    rng = np.random.default_rng(q * 100 + sub * 10 + prog)
    h, w = size
    img = Image.fromarray(F.fixture_image(rng, h, w))
    path = tmp_path / "x.jpg"
    path.write_bytes(_save(img, "JPEG", quality=q, subsampling=sub,
                           progressive=prog))
    np.testing.assert_array_equal(timages.open_rgb(path), _pil(path))


def _ycck(rng) -> bytes:
    """A CMYK JPEG whose Adobe marker is switched to YCCK (transform 2):
    libjpeg then converts YCCK -> CMYK before Pillow inverts it."""
    data = bytearray(_save(Image.fromarray(F.fixture_image(rng, 40, 56))
                           .convert("CMYK"), "JPEG", quality=80))
    at = data.index(b"Adobe")
    data[at + 11] = 2
    return bytes(data)


def _png_16(rng, ctype, chans):
    v = rng.integers(0, 1 << 16, (11, 9, chans))
    return F.png_bytes(9, 11, 16, ctype, F.png_rows(v, 16))


def _png_low(rng, depth, palette):
    v = rng.integers(0, 1 << depth, (7, 13, 1))
    plte = rng.integers(0, 256, 3 * (1 << depth) - 3, np.uint8).tobytes() \
        if palette else None      # short: the last index has no entry
    return F.png_bytes(13, 7, depth, 3 if palette else 0,
                       F.png_rows(v, depth, filt=1), plte=plte)


def _adam7(rng, depth, ctype, chans):
    hi = 65536 if depth == 16 else 1 << depth
    v = rng.integers(0, hi, (21, 19, chans))
    plte = rng.integers(0, 256, 768, np.uint8).tobytes() if ctype == 3 \
        else None
    return F.png_bytes(19, 21, depth, ctype, F.adam7_rows(v, depth),
                       interlace=1, plte=plte)


def _bmp_rle(rng, rle4):
    pal = b"".join(bytes([*rng.integers(0, 256, 3, np.uint8), 0])
                   for _ in range(16 if rle4 else 256))
    w, h = 7, 5
    row = bytes([4, 0x3A, 0, 3, 0x12, 0x30]) if rle4 else \
        bytes([3, 5, 0, 3, 7, 9, 11, 0, 1, 2])
    data = (row + b"\0\0") * h + b"\0\1"
    return F.bmp_bytes(w, h, 4 if rle4 else 8, data, 2 if rle4 else 1, pal)


def _bmp_raw(rng, bits, masks=None, top_down=False):
    w, h = 7, 5
    stride = ((w * bits + 31) >> 3) & ~3
    rows = rng.integers(0, 256, (h, stride), np.uint8).tobytes()
    pal = b"".join(bytes([*rng.integers(0, 256, 3, np.uint8), 0])
                   for _ in range(1 << bits)) if bits <= 8 else b""
    return F.bmp_bytes(w, h, bits, rows, 3 if masks else 0, pal, masks,
                       top_down)


def _ppm(rng, magic, w, h, maxval):
    bands = 3 if magic in "36" else 1
    v = rng.integers(0, maxval + 1, w * h * bands)
    head = f"P{magic}\n# seeded\n{w} {h}\n{maxval}\n".encode()
    if magic in "23":
        return head + " ".join(map(str, v)).encode() + b"\n"
    return head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()


OTHER_CASES = {
    "jpeg_ycck": _ycck,
    "png16_rgb": lambda r: _png_16(r, 2, 3),
    "png16_rgba": lambda r: _png_16(r, 6, 4),
    "png16_la": lambda r: _png_16(r, 4, 2),
    "png16_grey": lambda r: _png_16(r, 0, 1),
    "png_grey2": lambda r: _png_low(r, 2, False),
    "png_grey4": lambda r: _png_low(r, 4, False),
    "png_pal1_short": lambda r: _png_low(r, 1, True),
    "png_pal4_short": lambda r: _png_low(r, 4, True),
    "png_adam7_grey1": lambda r: _adam7(r, 1, 0, 1),
    "png_adam7_grey4": lambda r: _adam7(r, 4, 0, 1),
    "png_adam7_rgba16": lambda r: _adam7(r, 16, 6, 4),
    "png_adam7_pal8": lambda r: _adam7(r, 8, 3, 1),
    "png_optimized": lambda r: _save(Image.fromarray(
        r.integers(0, 256, (40, 50, 3), np.uint8)), "PNG", optimize=True),
    "pbm_p4": lambda r: _save(Image.fromarray(F.fixture_image(r, 13, 19))
                              .convert("1"), "PPM"),
    "pbm_p1": lambda r: b"P1\n3 2\n1 0 1\n0 1 1\n",
    "pgm_p5_maxval7": lambda r: _ppm(r, "5", 5, 4, 7),
    "pgm_p5_maxval1000": lambda r: _ppm(r, "5", 5, 4, 1000),
    "pgm_p5_maxval65535": lambda r: _ppm(r, "5", 5, 4, 65535),
    "ppm_p6_maxval100": lambda r: _ppm(r, "6", 5, 4, 100),
    "ppm_p6_maxval1000": lambda r: _ppm(r, "6", 5, 4, 1000),
    "ppm_p3": lambda r: _ppm(r, "3", 3, 2, 15),
    "pgm_p2_maxval600": lambda r: _ppm(r, "2", 3, 2, 600),
    "bmp_16_555": lambda r: _bmp_raw(r, 16),
    "bmp_16_565": lambda r: _bmp_raw(r, 16, (0xF800, 0x7E0, 0x1F)),
    "bmp_4bit": lambda r: _bmp_raw(r, 4),
    "bmp_32_top_down": lambda r: _bmp_raw(r, 32, top_down=True),
    "bmp_rle8": lambda r: _bmp_rle(r, False),
    "bmp_rle4": lambda r: _bmp_rle(r, True),
}


@pytest.mark.parametrize("name", sorted(OTHER_CASES))
def test_open_rgb_matches_pil_on_other_variants(tmp_path, name):
    """The modes PIL writes no fixture of: YCCK, 16-bit colour, sub-byte
    grey and palettes (a short palette reads black past its end), Adam7
    at 1/4/16 bits, PBM, PGM/PPM maxvals, plain PPM, 16-bit and 4-bit
    BMPs, top-down BMPs and RLE."""
    rng = np.random.default_rng(sorted(OTHER_CASES).index(name))
    path = tmp_path / name
    path.write_bytes(OTHER_CASES[name](rng))
    np.testing.assert_array_equal(timages.open_rgb(path), _pil(path))


# -- errors ---------------------------------------------------------------------

def _jpeg(rng) -> bytes:
    return _save(Image.fromarray(F.fixture_image(rng, 40, 56)), "JPEG",
                 quality=80)


def test_truncated_jpeg_raises_as_pil_does(tmp_path):
    data = _jpeg(np.random.default_rng(0))
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises(OSError, match="truncated"):
        Image.open(path).convert("RGB")
    with pytest.raises(timages.ImageDecodeError,
                       match=f"{path}.*truncated"):
        timages.open_rgb(path)


@pytest.mark.parametrize("marker,what", [(0xC9, "arithmetic-coded.*SOF9"),
                                         (0xCA, "arithmetic-coded.*SOF10"),
                                         (0xC3, "lossless.*SOF3")])
def test_unsupported_jpeg_processes_raise_naming_the_marker(
        tmp_path, marker, what):
    """ROADMAP Queue 3's open divergence: arithmetic-coded and lossless
    files raise, where PIL's libjpeg-turbo reads them."""
    data = bytearray(_jpeg(np.random.default_rng(1)))
    data[data.index(b"\xff\xc0") + 1] = marker
    path = tmp_path / "odd.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(timages.ImageDecodeError, match=what):
        timages.open_rgb(path)


def test_twelve_bit_jpeg_raises(tmp_path):
    data = bytearray(_jpeg(np.random.default_rng(2)))
    data[data.index(b"\xff\xc0") + 4] = 12            # sample precision
    path = tmp_path / "deep.jpg"
    path.write_bytes(bytes(data))
    with pytest.raises(timages.ImageDecodeError, match="12-bit"):
        timages.open_rgb(path)


def test_unknown_magic_raises_naming_the_path(tmp_path):
    path = tmp_path / "notes.jpg"
    path.write_bytes(b"GIF89a...")
    with pytest.raises(timages.ImageDecodeError, match="notes.jpg"):
        timages.open_rgb(path)


# -- resize ---------------------------------------------------------------------

RESIZE_SHAPES = [((375, 500), (256, 341)), ((500, 333), (384, 256)),
                 ((353, 500), (256, 362)), ((40, 60), (18, 27)),
                 ((64, 64), (73, 73)), ((30, 30), (36, 36)),
                 ((1, 1), (5, 7)), ((1, 9), (4, 4)), ((20, 10), (40, 20)),
                 ((7, 300), (3, 2)), ((10, 10), (10, 4))]


@pytest.mark.parametrize("src,dst", RESIZE_SHAPES)
def test_resize_matches_pil(src, dst):
    """``resize`` and ``resize_plain`` against ``Image.resize`` (bicubic):
    ImageNet's downscales, upscales, 1-pixel sources, a 2x upscale and
    one pass alone; ``(h, w)`` pairs."""
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    img = rng.integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0])))
    np.testing.assert_array_equal(timages.resize(img, (dst[1], dst[0])),
                                  want)
    np.testing.assert_array_equal(
        timages.resize_plain(img, (dst[1], dst[0])), want)


def test_library_lives_in_build(tmp_path):
    timages.open_rgb(F.OUT / "jpeg_1x1.jpg")
    path = tnative.library_path("curvimages")
    assert path.parent.name == "build" and path.exists()
    assert path.name.startswith("libcurvimages-")


# -- the loaders against JAX's ---------------------------------------------------

def _tree(root: Path, classes: dict, tag: str) -> None:
    """``root/<class>/`` holding copies of fixtures under new names."""
    names = FIXTURES
    k = 0
    for cls, n in classes.items():
        d = root / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            src = names[(k * 5 + len(tag)) % len(names)]
            shutil.copyfile(F.OUT / src,
                            d / f"{tag}_{i:03d}{Path(src).suffix}")
            k += 1


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """``--data_dir`` with ImageNet's and GTSRB's layouts: imagenet/train
    (4 classes x 4), imagenet/val (16), imagenet/art (2 x 8), gtsrb/train
    (unbalanced: 7, 3, 2), gtsrb/{val,test} (4 x 2)."""
    root = tmp_path_factory.mktemp("images")
    _tree(root / "imagenet" / "train", {f"n{i:02d}": 4 for i in range(4)},
          "tr")
    _tree(root / "imagenet" / "val", {f"n{i:02d}": 4 for i in range(4)},
          "va")
    _tree(root / "imagenet" / "art", {"a0": 8, "a1": 8}, "art")
    _tree(root / "gtsrb" / "train", {"00000": 7, "00001": 3, "00002": 2},
          "g")
    for split in ("val", "test"):
        _tree(root / "gtsrb" / split, {f"{i:05d}": 2 for i in range(4)},
              split)
    return root


def _same_batches(got, want, epochs=1):
    for _ in range(epochs):
        g, w = list(got), list(want)
        assert len(g) == len(w) > 0
        for (gx, gy), (wx, wy) in zip(g, w):
            assert gx.dtype == wx.dtype == np.float32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("which", ["imagenet", "tiny", "art", "gtsrb"])
def test_loaders_match_jax(data_dir, which):
    """Exact float32 batches in JAX's order: ImageNet's shuffled train and
    its val at 224², the same folder at 64² (tiny), art, and GTSRB's
    class-balanced train draw over two epochs and its val."""
    root = str(data_dir)
    if which == "gtsrb":
        g = os.path.join(root, "gtsrb")
        tl, jl = tloaders.gtsrb(g, 32, 5), jloaders.gtsrb(g, 32, 5)
        assert tl[0].class_balanced
        _same_batches(tl[0], jl[0], epochs=2)
        _same_batches(tl[1], jl[1])
        return
    if which == "art":
        im = os.path.join(root, "imagenet")
        _same_batches(tloaders.art(im, 224, 8), jloaders.art(im, 224, 8))
        return
    size = 64 if which == "tiny" else 224
    im = os.path.join(root, "imagenet")
    kw = dict(tiny=True) if which == "tiny" else {}
    tl = tloaders.imagenet(im, size, 6, splits=("train", "val"), **kw)
    jl = jloaders.imagenet(im, size, 6, splits=("train", "val"), **kw)
    _same_batches(tl[0], jl[0], epochs=2)
    _same_batches(tl[1], jl[1])


def test_committed_batches_equal_the_loaders(expected, tmp_path):
    """The fixtures' ``batch224``/``batch64`` (JAX's loader, written with
    the fixtures) from the port's loader: the arrays the chip check
    compares with."""
    root = F.folder_tree(tmp_path)
    for size, sel in ((224, [0]), (64, [0, 3, 6, 9, 10, 11])):
        loader = tloaders.ImageFolderLoader(str(root), size)
        x, y = loader.load_batch(sel)
        np.testing.assert_array_equal(x, expected[f"batch{size}"])
        np.testing.assert_array_equal(y, expected[f"labels{size}"])
        assert [os.path.relpath(loader.samples[j][0], root) for j in sel] \
            == list(expected[f"files{size}"])


def test_parallel_decode_loader_gives_the_plain_batches(data_dir):
    """``ParallelDecodeLoader(workers=4)`` over an image folder: the plain
    loader's batches in its order, and JAX's threaded loader's."""
    im = os.path.join(str(data_dir), "imagenet")
    plain = tloaders.imagenet(im, 64, 3, tiny=True)
    threaded = tprefetch.ParallelDecodeLoader(
        tloaders.imagenet(im, 64, 3, tiny=True), workers=4)
    jax_threaded = jprefetch.ParallelDecodeLoader(
        jloaders.imagenet(im, 64, 3, tiny=True), workers=4)
    assert len(threaded) == len(plain) == 6
    _same_batches(threaded, plain, epochs=2)
    threaded = tprefetch.ParallelDecodeLoader(
        tloaders.imagenet(im, 64, 3, tiny=True), workers=4)
    _same_batches(threaded, jax_threaded)


@pytest.mark.parametrize("data", ["imagenet", "tiny", "gtsrb"])
def test_build_data_matches_jax(data_dir, data):
    """``build_data`` (train, and val/test) and ``build_ood_data`` for the
    three image datasets against JAX's pipelines/common.py: ImageNet at
    the model's size (299² for Inception v3), tiny at 64², GTSRB at 32²;
    ImageNet's and tiny's OOD set the art folder, GTSRB's CIFAR-10 (not
    present: both raise)."""
    model = "inception_v3" if data == "imagenet" else "resnet18"
    argv = ["--platform", "cpu", "--model", model, "--data", data,
            "--data_dir", str(data_dir), "--batch_size", "7"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    _same_batches(tcommon.build_data(t, "train"),
                  jcommon.build_data(j, "train"))
    if data == "gtsrb":
        _same_batches(tcommon.build_data(t, "val"),
                      jcommon.build_data(j, "val"))
        for pkg, cfg in ((tcommon, t), (jcommon, j)):
            with pytest.raises(FileNotFoundError):
                pkg.build_ood_data(cfg)
        return
    t_in, t_ood = tcommon.build_ood_data(t)
    j_in, j_ood = jcommon.build_ood_data(j)
    assert t_in.img_size == t_ood.img_size == (299 if data == "imagenet"
                                               else 64)
    _same_batches(t_in, j_in)
    _same_batches(t_ood, j_ood)


# -- one CLI chain ---------------------------------------------------------------

def test_tiny_cli_chain_matches_jax(data_dir, tmp_path):
    """``factors`` then ``evaluate --ood`` on ``--data tiny`` (LeNet-5 at
    64², 200 classes, one weights file both packages load): the port's
    KFAC A factors within 1e-5 of JAX's CLI and its G traces within 20%
    (the MC labels differ), tests/test_torch_pipelines.py's bars; the
    evaluation writes JAX's result files and keys."""
    root = tmp_path / "r"
    (root / "weights").mkdir(parents=True)
    cfg_argv = ["--platform", "cpu", "--model", "lenet5", "--data", "tiny",
                "--data_dir", str(data_dir), "--batch_size", "8",
                "--mc_samples", "1", "--estimator", "kfac"]
    model = tmodels.build("lenet5", 200, device="cpu", in_channels=3,
                          image_size=64)
    tckpt.save_pytree(str(root / "weights" / "lenet5_tiny"),
                      tmodels.seeded_variables(model, 0))
    roots = {}
    for pkg, main in (("jax", jfactors.main), ("port", tfactors.main)):
        r = tmp_path / pkg
        shutil.copytree(root, r)
        roots[pkg] = r
        main(cfg_argv + ["--root_dir", str(r), "--results_dir", str(r)])
    t, j = tconfig.parse_args(cfg_argv + ["--root_dir", str(roots["port"])]), \
        jconfig.parse_args(cfg_argv + ["--root_dir", str(roots["jax"])])
    got = tckpt.load_pytree(tckpt.factors_path(t))
    want = jckpt.load_pytree(jckpt.factors_path(j))
    assert sorted(got) == sorted(want)
    for name in want:
        a, wa = np.asarray(got[name]["a"]), np.asarray(want[name]["a"])
        np.testing.assert_allclose(a, wa, atol=1e-5 * np.abs(wa).max())
        tr = [np.trace(np.asarray(s[name]["g"])) for s in (got, want)]
        assert abs(tr[0] - tr[1]) <= 0.2 * tr[1], name
    written = {}
    for pkg, main in (("jax", jevaluate.main), ("port", tevaluate.main)):
        r = roots[pkg]
        main(cfg_argv + ["--root_dir", str(r), "--results_dir", str(r),
                         "--norm", "1", "--scale", "5e4", "--samples", "2",
                         "--ood"])
        written[pkg] = {}
        for f in r.rglob("*.npz"):
            rel = f.relative_to(r)
            if rel.parts[0] in ("weights", "factors"):
                continue
            with np.load(f, allow_pickle=True) as z:
                written[pkg][str(rel)] = sorted(z.files)
    assert written["port"] and written["port"] == written["jax"]
