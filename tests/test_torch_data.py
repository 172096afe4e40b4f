"""The port's array-format loaders, native decoder and host pipeline
against the JAX package, on synthetic files in each format (no dataset
can be downloaded here): CIFAR-10 pickle batches, SVHN ``.mat`` (golden
bytes: X [32, 32, 3, N], label 10 meaning 0), a UCI CSV, SARCOS ``.mat``
and KUKA npz. Both packages read the same files; the batches must be the
same arrays (the same split, order, labels and transforms; the pixels
decoded by the same ``native/decoder.cpp``). The native entry points are
held to their plain numpy versions within one float32 ulp (the decoder
multiplies by 1/255f where numpy divides by 255), and a failed build
raises with the compiler's error. ``DevicePrefetcher`` runs on the CPU
where JAX's test runs it: a loader error mid-epoch raises in the
consumer.
"""
import os
import pickle

import numpy as np
import pytest
import scipy.io
import torch

from curvature_tpu.data import loaders as jloaders
from curvature_tpu.data import native as jnative
from curvature_tpu.data import prefetch as jprefetch
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.data import native as tnative
from curvature_tpu_torch.data import prefetch as tprefetch
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.utils import config as tconfig


def _write_cifar(root, n_train=20, n_test=10000, seed=0):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i in range(1, 6):
        batch = {b"data": rng.integers(0, 255, (n_train, 3072),
                                       dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n_train).tolist()}
        with open(d / f"data_batch_{i}", "wb") as f:
            pickle.dump(batch, f)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 255, (n_test, 3072),
                                           dtype=np.uint8),
                     b"labels": rng.integers(0, 10, n_test).tolist()}, f)


def _write_svhn(root, splits=("train", "test"), n=10000, seed=0):
    d = root / "svhn"
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for split in splits:
        x = rng.integers(0, 255, (32, 32, 3, n), dtype=np.uint8)
        y = rng.integers(1, 11, (n, 1))
        scipy.io.savemat(str(d / f"{split}_32x32.mat"), {"X": x, "y": y})


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """CIFAR-10 (5 x 20 training images, 10,000 test) and SVHN (10,000
    each) under one root, as ``--data_dir`` names it."""
    root = tmp_path_factory.mktemp("data")
    _write_cifar(root)
    _write_svhn(root, n=10000)
    return root


def _same_batches(t, j):
    if not isinstance(t, list):
        t, j = [t], [j]
    assert len(t) == len(j)
    for tl, jl in zip(t, j):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 0
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(ty, jy)
            assert tx.shape == jx.shape and tx.dtype == jx.dtype
            np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("splits,augment", [
    ("train", False), ("train", True), (("val", "test"), False)])
def test_cifar10_loader_matches_jax(data_root, splits, augment):
    """The same batches: shuffled training order, the seeded 5000/5000
    val/test split, the CIFAR normalization, and (``augment``) the random
    4-pixel crops and flips drawn from the same generator."""
    t = tloaders.cifar10(str(data_root), 32, augment=augment, splits=splits)
    j = jloaders.cifar10(str(data_root), 32, augment=augment, splits=splits)
    _same_batches(t, j)
    xb, _ = next(iter(t if not isinstance(t, list) else t[0]))
    assert xb.shape == (32, 32, 32, 3) and xb.min() < 0 < xb.max()


def test_svhn_mat_golden_bytes(tmp_path):
    """SVHN's .mat container: X is [32, 32, 3, N] uint8 (the sample axis
    last) and y is [N, 1] with label 10 meaning digit 0 (JAX
    tests/test_data.py:173-200): every pixel and label as JAX reads it."""
    d = tmp_path / "svhn"
    d.mkdir()
    rng = np.random.default_rng(0)
    n = 12
    x_raw = rng.integers(0, 255, (32, 32, 3, n), dtype=np.uint8)
    y_raw = np.concatenate([np.full(2, 10), rng.integers(1, 10, n - 2)])
    scipy.io.savemat(str(d / "train_32x32.mat"),
                     {"X": x_raw, "y": y_raw.reshape(-1, 1)})
    xb, yb = next(iter(tloaders.svhn(str(tmp_path), batch_size=n,
                                     splits="train")))
    assert sorted(yb) == sorted(y_raw % 10) and sorted(yb)[:2] == [0, 0]
    expect = x_raw.transpose(3, 0, 1, 2).astype(np.float32) / 255.0
    expect = (expect - tloaders.CIFAR_MEAN) / tloaders.CIFAR_STD
    order = np.argsort(xb.reshape(n, -1).sum(1))
    want = np.argsort(expect.reshape(n, -1).sum(1))
    np.testing.assert_allclose(xb[order], expect[want], rtol=1e-5)
    _same_batches(tloaders.svhn(str(tmp_path), n, splits="train"),
                  jloaders.svhn(str(tmp_path), n, splits="train"))


def test_svhn_val_test_split_matches_jax(data_root):
    t = tloaders.svhn(str(data_root), 256, splits=("val", "test"))
    assert [sum(len(y) for _, y in loader) for loader in t] == [5000, 5000]
    _same_batches(t, jloaders.svhn(str(data_root), 256,
                                   splits=("val", "test")))


def test_build_data_and_the_ood_pair_match_jax(data_root):
    """``--data cifar10`` through both packages' ``build_data``, and its
    OOD pair (SVHN's test split) through ``build_ood_data``."""
    argv = ["--platform", "cpu", "--model", "densenet121", "--data",
            "cifar10", "--data_dir", str(data_root), "--batch_size", "500"]
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    _same_batches(tcommon.build_data(t, "train"),
                  jcommon.build_data(j, "train"))
    t_in, t_ood = tcommon.build_ood_data(t)
    j_in, j_ood = jcommon.build_ood_data(j)
    _same_batches(t_in, j_in)
    _same_batches(t_ood, j_ood)
    assert tloaders.OOD_PAIRS == jloaders.OOD_PAIRS


# -- the native decoder -------------------------------------------------------

def test_native_decoder_matches_its_plain_version_and_jax():
    """Each entry point against its numpy version within one float32 ulp
    (and 1e-6 of the normalized value), and equal to JAX's native
    decoder (the same source and flags) where JAX built it."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 255, (64, 3072), dtype=np.uint8)
    mean = np.array([0.49, 0.48, 0.45], np.float32)
    std = np.array([0.2, 0.21, 0.19], np.float32)
    np.testing.assert_array_max_ulp(tnative.decode_cifar(raw),
                                    tnative.decode_cifar_plain(raw), 1)
    np.testing.assert_allclose(tnative.decode_cifar(raw, mean, std),
                               tnative.decode_cifar_plain(raw, mean, std),
                               rtol=1e-5, atol=1e-6)
    idx = rng.integers(0, 255, (32, 28, 28), dtype=np.uint8)
    np.testing.assert_array_max_ulp(tnative.decode_idx(idx),
                                    tnative.decode_idx_plain(idx), 1)
    x = rng.standard_normal((4, 5, 5, 3)).astype(np.float32)
    want = tnative.normalize_nhwc3_plain(x, mean, std)
    got = tnative.normalize_nhwc3(x.copy(), mean, std)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if jnative.available():
        np.testing.assert_array_equal(tnative.decode_cifar(raw),
                                      jnative.decode_cifar(raw))
        np.testing.assert_array_equal(tnative.decode_idx(idx),
                                      jnative.decode_idx(idx))
    assert tnative.library_path().parent.name == "build"
    assert tnative.library_path().name.startswith("libcurvdata-")


def test_native_build_failure_raises_with_the_compiler_error(
        tmp_path, monkeypatch):
    """No silent numpy fallback: a source g++ refuses raises, naming the
    compiler's complaint; nothing is left behind in the build directory."""
    bad = tmp_path / "decoder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        tnative.build()
    assert list((tmp_path / "build").iterdir()) == []


# -- the host pipeline --------------------------------------------------------

class _FailingLoader:
    """One good batch, then the error a corrupt file raises."""

    def __iter__(self):
        yield np.zeros((2, 3), np.float32), np.zeros((2,), np.int32)
        raise RuntimeError("corrupt batch")

    def __len__(self):
        return 2


def test_device_prefetcher_propagates_loader_errors():
    """A loader failure mid-epoch raises in the consumer (JAX
    tests/test_data.py:135-159): factors would otherwise be estimated
    from a truncated epoch with exit code 0."""
    it = iter(tprefetch.DevicePrefetcher(_FailingLoader(), depth=2,
                                         device="cpu"))
    x, y = next(it)
    assert torch.is_tensor(x) and x.shape == (2, 3)
    with pytest.raises(RuntimeError, match="corrupt batch"):
        next(it)


def test_device_prefetcher_yields_the_loaders_batches(data_root):
    """On the CPU the prefetcher hands out the loader's batches in order,
    as tensors, epoch after epoch (the loader's own shuffle each time)."""
    pre = tprefetch.DevicePrefetcher(
        tloaders.cifar10(str(data_root), 32, splits="train"), depth=3,
        device="cpu")
    want = tloaders.cifar10(str(data_root), 32, splits="train")
    assert len(pre) == len(want) == 4
    for _ in range(2):
        got = list(pre)
        assert len(got) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx.numpy(), wx)
            np.testing.assert_array_equal(gy.numpy(), wy)


class _Folder:
    """An image-folder loader's interface (``batch_indices``,
    ``load_batch``) over arrays."""

    def __init__(self):
        self.x = np.arange(40, dtype=np.float32).reshape(10, 2, 2, 1)

    def __len__(self):
        return 4

    def batch_indices(self):
        order = np.random.default_rng(3).permutation(10)
        return (order[i:i + 3] for i in range(0, 10, 3))

    def load_batch(self, sel):
        return self.x[sel], sel.astype(np.int32)


def test_parallel_decode_and_cached_loaders_match_jax():
    """``ParallelDecodeLoader`` yields the inner loader's batches in its
    order, as JAX's; ``CachedLoader`` serves the first epoch's batches
    from memory after it, as JAX's."""
    t = tprefetch.ParallelDecodeLoader(_Folder(), workers=2, lookahead=2)
    j = jprefetch.ParallelDecodeLoader(_Folder(), workers=2, lookahead=2)
    assert len(t) == len(j) == 4
    _same_batches(t, j)

    def array_loader(module):
        return module.ArrayLoader(np.arange(12.0).reshape(6, 2),
                                  np.arange(6), 4, shuffle=True)
    cached = tprefetch.CachedLoader(array_loader(tloaders))
    first = list(cached)
    assert len(cached) == 2
    _same_batches(cached, jprefetch.CachedLoader(array_loader(jloaders)))
    for (a, b), (c, d) in zip(first, cached):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("seed", [0, 5])
def test_transforms_match_jax(seed):
    """normalize, random_crop, random_hflip and compose draw the same
    numbers from the same generator and give JAX's arrays."""
    x = np.random.default_rng(9).standard_normal((6, 8, 8, 3)) \
        .astype(np.float32)
    mean, std = tloaders.CIFAR_MEAN, tloaders.CIFAR_STD
    for t, j in ((tloaders.normalize(mean, std),
                  jloaders.normalize(mean, std)),
                 (tloaders.random_crop(2), jloaders.random_crop(2)),
                 (tloaders.random_hflip, jloaders.random_hflip),
                 (tloaders.compose(tloaders.random_crop(4),
                                   tloaders.random_hflip,
                                   tloaders.normalize(mean, std)),
                  jloaders.compose(jloaders.random_crop(4),
                                   jloaders.random_hflip,
                                   jloaders.normalize(mean, std)))):
        np.testing.assert_array_equal(t(x, np.random.default_rng(seed)),
                                      j(x, np.random.default_rng(seed)))


# -- the regression sets ------------------------------------------------------

def test_uci_csv_matches_jax_pandas(tmp_path):
    """``uci`` reads the CSV with numpy as JAX's reads it with pandas:
    the header row skipped, float32, the same seeded 90/10 split."""
    d = tmp_path / "uci"
    d.mkdir()
    rng = np.random.default_rng(4)
    arr = np.round(rng.standard_normal((103, 9)) * 37.0, 4)
    arr[:, 3] = rng.integers(0, 500, 103)
    with open(d / "concrete.csv", "w") as f:
        f.write(",".join(f"col {i}" for i in range(9)) + "\n")
        for row in arr:
            f.write(",".join(repr(float(v)) for v in row) + "\n")
    for splits in (("train", "test"), ("train",), ("test",)):
        t = tloaders.uci(str(tmp_path), "concrete", splits=splits, seed=3)
        j = jloaders.uci(str(tmp_path), "concrete", splits=splits, seed=3)
        t, j = (t, j) if len(splits) > 1 else ([t], [j])
        for (tx, ty), (jx, jy) in zip(t, j):
            assert tx.dtype == jx.dtype == np.float32 and tx.shape[1] == 8
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_sarcos_and_kuka_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    scipy.io.savemat(str(tmp_path / "sarcos_inv.mat"),
                     {"sarcos_inv": rng.standard_normal((40, 28))})
    scipy.io.savemat(str(tmp_path / "sarcos_inv_test.mat"),
                     {"sarcos_inv_test": rng.standard_normal((10, 28))})
    np.savez(tmp_path / "kuka2.npz", X_train=rng.standard_normal((30, 21)),
             Y_train=rng.standard_normal((30, 7)),
             X_test=rng.standard_normal((5, 21)),
             Y_test=rng.standard_normal((5, 7)))
    for t, j in ((tloaders.sarcos(str(tmp_path)),
                  jloaders.sarcos(str(tmp_path))),
                 (tloaders.kuka(str(tmp_path), 2),
                  jloaders.kuka(str(tmp_path), 2))):
        for (tx, ty), (jx, jy) in zip(t, j):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    (x, y), _ = tloaders.sarcos(str(tmp_path))
    assert x.shape == (40, 21) and y.shape == (40,)
    assert os.path.exists(tmp_path / "kuka2.npz")
