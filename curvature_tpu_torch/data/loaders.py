"""Dataset loaders (file-based, no network access): the MNIST-format subset.

Port of ``ArrayLoader``, ``read_idx``, the idx decode, ``_val_test_split``,
``mnist``, ``kmnist`` and ``OOD_PAIRS`` of ``curvature_tpu/data/loaders.py``
(reference datasets.py:265-360): the same split protocol and the same
batches, NHWC float32 numpy as in JAX (the pipelines move them to NCHW on
the device). The idx bytes decode as ``uint8 / 255``, the numpy branch of
the JAX ``native.decode_idx``. The other datasets are not ported yet
(ROADMAP Queue 1 item 9). ``FIXTURE_DIR`` holds 1024 real handwritten
digits in the MNIST idx layout, a copy of the JAX package's fixture.
"""
import gzip
import os
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

MNIST_DIR = "MNIST/raw"
KMNIST_DIR = "KMNIST/raw"

#: ``--data_dir`` of the bundled digits (``<FIXTURE_DIR>/MNIST/raw``)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "digits")

_NOT_PORTED = ("cifar10", "svhn", "gtsrb", "imagenet", "art", "uci",
               "sarcos", "kuka", "ImageFolderLoader")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} loader is not ported yet (ROADMAP Queue 1 item 9)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ArrayLoader:
    """Mini-batch iterator over in-memory arrays (NHWC float32, int32)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int = 32,
                 shuffle: bool = False, transform=None, seed: int = 0,
                 sample_weights: Optional[np.ndarray] = None):
        self.x = x
        self.y = y.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.rng = np.random.default_rng(seed)
        self.sample_weights = sample_weights

    def __len__(self):
        return (len(self.x) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.x)
        if self.sample_weights is not None:
            idx = self.rng.choice(n, size=n, replace=True,
                                  p=self.sample_weights
                                  / self.sample_weights.sum())
        elif self.shuffle:
            idx = self.rng.permutation(n)
        else:
            idx = np.arange(n)
        for i in range(0, n, self.batch_size):
            sel = idx[i:i + self.batch_size]
            xb = self.x[sel]
            if self.transform is not None:
                xb = self.transform(xb, self.rng)
            if not np.issubdtype(xb.dtype, np.integer):
                xb = xb.astype(np.float32)
            yield xb, self.y[sel]


def binarize(x, rng):
    """Random Bernoulli binarization (reference Binarize, datasets.py:67-80),
    MNIST's ``--augment``."""
    return (rng.random(x.shape) < x).astype(np.float32)


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx(path: str) -> np.ndarray:
    """Parse an MNIST-style idx file (optionally gzipped)."""
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def decode_idx(raw: np.ndarray) -> np.ndarray:
    """[n, ...] uint8 -> float32 in [0, 1]."""
    return np.ascontiguousarray(raw, np.uint8).astype(np.float32) / 255.0


def _idx_dataset(root: str, subdir: str
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    d = os.path.join(root, subdir)
    xtr = read_idx(os.path.join(d, "train-images-idx3-ubyte"))
    ytr = read_idx(os.path.join(d, "train-labels-idx1-ubyte"))
    xte = read_idx(os.path.join(d, "t10k-images-idx3-ubyte"))
    yte = read_idx(os.path.join(d, "t10k-labels-idx1-ubyte"))
    return decode_idx(xtr)[..., None], ytr, decode_idx(xte)[..., None], yte


def _val_test_split(x, y, sizes: Sequence[int], seed: int = 0):
    """Deterministic random split (the reference's seeded random_split,
    datasets.py:26, 295). When the set is smaller than the requested sizes
    (the bundled 512-digit fixture against MNIST's 10k test split), the
    sizes shrink proportionally so no split comes back empty."""
    if sum(sizes) > len(x):
        frac = [s / sum(sizes) for s in sizes]
        sizes = [int(len(x) * f) for f in frac[:-1]]
        sizes.append(len(x) - sum(sizes))
    idx = np.random.default_rng(seed).permutation(len(x))
    out = []
    start = 0
    for s in sizes:
        sel = idx[start:start + s]
        out.append((x[sel], y[sel]))
        start += s
    return out


def _select_splits(loaders: List, splits: Union[str, Tuple[str, ...]]):
    if len(loaders) == 1:
        return loaders[0]
    return loaders


def mnist(root: str, batch_size: int = 32, workers: int = 0,
          augment: bool = False, splits=("train", "val")):
    """MNIST from idx files under ``<root>/MNIST/raw``
    (datasets.py:265-315)."""
    xtr, ytr, xte, yte = _idx_dataset(root, MNIST_DIR)
    loaders = []
    if "train" in splits:
        t = binarize if augment else None
        loaders.append(ArrayLoader(xtr, ytr, batch_size, shuffle=True,
                                   transform=t))
    if "val" in splits or "test" in splits:
        (xv, yv), (xt, yt) = _val_test_split(xte, yte, [5000, 5000])
        if "val" in splits:
            loaders.append(ArrayLoader(xv, yv, batch_size))
        if "test" in splits:
            loaders.append(ArrayLoader(xt, yt, batch_size))
    return _select_splits(loaders, splits)


def kmnist(root: str, batch_size: int = 32, workers: int = 0,
           augment: bool = False, splits=("train", "val")):
    """KMNIST (datasets.py:318-360); val carved from train like the
    reference (10000 from the training set)."""
    xtr, ytr, xte, yte = _idx_dataset(root, KMNIST_DIR)
    loaders = []
    if "train" in splits or "val" in splits:
        (xv, yv), (xt2, yt2) = _val_test_split(
            xtr, ytr, [10000, len(xtr) - 10000])
        if "train" in splits:
            loaders.append(ArrayLoader(xt2, yt2, batch_size, shuffle=True))
        if "val" in splits:
            loaders.append(ArrayLoader(xv, yv, batch_size))
    if "test" in splits:
        loaders.append(ArrayLoader(xte, yte, batch_size))
    return _select_splits(loaders, splits)


#: the reference's fixed in-domain -> OOD pairing (evaluate.py:221-243)
OOD_PAIRS = {
    "mnist": "kmnist",
    "cifar10": "svhn",
    "gtsrb": "cifar10",
    "tiny": "art",
    "imagenet": "art",
}
