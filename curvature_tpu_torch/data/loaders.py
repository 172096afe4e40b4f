"""Dataset loaders (file-based, no network access): the array formats.

Port of ``curvature_tpu/data/loaders.py`` (reference datasets.py:192-468):
``ArrayLoader``, the transforms, MNIST/KMNIST (idx files), CIFAR-10
(python pickle batches), SVHN (``.mat``), and the regression sets UCI
(CSV), SARCOS (``.mat``) and KUKA (npz), with the same normalization
constants, split protocol and batches, NHWC float32 numpy as in JAX (the
pipelines move them to NCHW on the device). The CIFAR bytes decode
through ``data.native`` (``native/decoder.cpp``), as in JAX; the idx
bytes by its numpy version, within one ulp of JAX's native decode. The
image-folder loaders (GTSRB, ImageNet, TinyImageNet, art) decode JPEG/PNG/
PPM through PIL, which the card's machine lacks: they wait (ROADMAP Queue
1 item 9). ``FIXTURE_DIR`` holds 1024 real handwritten digits in the
MNIST idx layout, a copy of the JAX package's fixture.
"""
import gzip
import os
import pickle
import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from curvature_tpu_torch.data import native

MNIST_DIR = "MNIST/raw"
KMNIST_DIR = "KMNIST/raw"

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
GTSRB_MEAN = np.array([0.34038433, 0.3119956, 0.32119358], np.float32)
GTSRB_STD = np.array([0.05087305, 0.05426421, 0.05859348], np.float32)

#: ``--data_dir`` of the bundled digits (``<FIXTURE_DIR>/MNIST/raw``)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "digits")

_NOT_PORTED = ("gtsrb", "imagenet", "art", "ImageFolderLoader")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} loader decodes image folders through PIL, which "
            "the card's machine lacks: not ported yet (ROADMAP Queue 1 "
            "item 9)")
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


# -- transforms --------------------------------------------------------------

def normalize(mean: np.ndarray, std: np.ndarray):
    def f(x, rng=None):
        return (x - mean) / std
    return f


def binarize(x, rng):
    """Random Bernoulli binarization (reference Binarize, datasets.py:67-80),
    MNIST's ``--augment``."""
    return (rng.random(x.shape) < x).astype(np.float32)


def random_crop(pad: int):
    """Zero-pad by ``pad`` and crop back at a random offset per image."""
    def f(x, rng):
        b, h, w, c = x.shape
        xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="constant")
        out = np.empty_like(x)
        for i in range(b):
            dy = rng.integers(0, 2 * pad + 1)
            dx = rng.integers(0, 2 * pad + 1)
            out[i] = xp[i, dy:dy + h, dx:dx + w]
        return out
    return f


def random_hflip(x, rng):
    flip = rng.random(x.shape[0]) < 0.5
    x = x.copy()
    x[flip] = x[flip, :, ::-1]
    return x


def compose(*fns):
    """Apply ``fns`` in order; those taking two arguments get the rng."""
    def f(x, rng):
        for fn in fns:
            x = fn(x, rng) if fn.__code__.co_argcount >= 2 else fn(x)
        return x
    return f


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


def _idx_dataset(root: str, subdir: str
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    d = os.path.join(root, subdir)
    xtr = read_idx(os.path.join(d, "train-images-idx3-ubyte"))
    ytr = read_idx(os.path.join(d, "train-labels-idx1-ubyte"))
    xte = read_idx(os.path.join(d, "t10k-images-idx3-ubyte"))
    yte = read_idx(os.path.join(d, "t10k-labels-idx1-ubyte"))
    # numpy's x / 255, within one ulp of JAX's native x * (1/255f): the
    # digits' numbers of every earlier port test (an FGSM sign test at
    # eps 0.3 tells the two apart)
    return (native.decode_idx_plain(xtr)[..., None], ytr,
            native.decode_idx_plain(xte)[..., None], yte)


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


def _cifar10_arrays(root: str):
    d = os.path.join(root, "cifar-10-batches-py")
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(batch[b"data"])
        ys.extend(batch[b"labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        batch = pickle.load(f, encoding="bytes")
    return (native.decode_cifar(np.concatenate(xs)), np.asarray(ys),
            native.decode_cifar(np.asarray(batch[b"data"])),
            np.asarray(batch[b"labels"]))


def cifar10(root: str, batch_size: int = 32, workers: int = 0,
            augment: bool = False, splits=("train", "val")):
    """CIFAR-10 pickle batches under ``<root>/cifar-10-batches-py``
    (datasets.py:363-421); ``augment``: random 4-pixel crops and flips."""
    xtr, ytr, xte, yte = _cifar10_arrays(root)
    norm = normalize(CIFAR_MEAN, CIFAR_STD)
    loaders = []
    if "train" in splits:
        t = compose(random_crop(4), random_hflip, norm) if augment else norm
        loaders.append(ArrayLoader(xtr, ytr, batch_size, shuffle=True,
                                   transform=t))
    if "val" in splits or "test" in splits:
        (xv, yv), (xt, yt) = _val_test_split(xte, yte, [5000, 5000])
        if "val" in splits:
            loaders.append(ArrayLoader(xv, yv, batch_size, transform=norm))
        if "test" in splits:
            loaders.append(ArrayLoader(xt, yt, batch_size, transform=norm))
    return _select_splits(loaders, splits)


def svhn(root: str, batch_size: int = 32, workers: int = 0,
         splits=("train", "val")):
    """SVHN ``<root>/svhn/{train,test}_32x32.mat`` (X [32, 32, 3, N],
    label 10 meaning digit 0), normalized with CIFAR-10's statistics like
    the reference (datasets.py:424-468)."""
    import scipy.io
    d = os.path.join(root, "svhn")
    norm = normalize(CIFAR_MEAN, CIFAR_STD)

    def load(split):
        mat = scipy.io.loadmat(os.path.join(d, f"{split}_32x32.mat"))
        x = mat["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0
        y = mat["y"].reshape(-1).astype(np.int64) % 10
        return x, y

    loaders = []
    if "train" in splits:
        x, y = load("train")
        loaders.append(ArrayLoader(x, y, batch_size, shuffle=True,
                                   transform=norm))
    if "val" in splits or "test" in splits:
        x, y = load("test")
        (xv, yv), (xt, yt) = _val_test_split(x, y, [5000, 5000])
        if "val" in splits:
            loaders.append(ArrayLoader(xv, yv, batch_size, transform=norm))
        if "test" in splits:
            loaders.append(ArrayLoader(xt, yt, batch_size, transform=norm))
    return _select_splits(loaders, splits)


# -- regression datasets (datasets.py:192-262) --------------------------------

def read_csv(path: str) -> np.ndarray:
    """A numeric CSV with one header row as float32 [rows, cols]: pandas'
    ``read_csv(path).to_numpy(np.float32)`` (the card has no pandas),
    parsed in float64 and rounded once."""
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2).astype(np.float32)


def uci(root: str, dataset: str = "concrete", batch_size: int = 32,
        splits=("train", "test"), seed: int = 0):
    """UCI regression CSVs under ``<root>/uci/<dataset>.csv`` (the last
    column the target), a seeded 90/10 split (datasets.py:192-238);
    ``(x, y)`` array pairs."""
    arr = read_csv(os.path.join(root, "uci", f"{dataset}.csv"))
    x, y = arr[:, :-1], arr[:, -1]
    idx = np.random.default_rng(seed).permutation(len(x))
    cut = int(0.9 * len(x))
    out = []
    if "train" in splits:
        out.append((x[idx[:cut]], y[idx[:cut]]))
    if "test" in splits:
        out.append((x[idx[cut:]], y[idx[cut:]]))
    return out[0] if len(out) == 1 else out


def sarcos(root: str):
    """SARCOS robot-arm inverse dynamics .mat (datasets.py:241-250): 21
    inputs, the first torque the target."""
    import scipy.io
    tr = scipy.io.loadmat(os.path.join(root, "sarcos_inv.mat"))["sarcos_inv"]
    te = scipy.io.loadmat(os.path.join(root, "sarcos_inv_test.mat"))[
        "sarcos_inv_test"]
    return (tr[:, :21], tr[:, 21]), (te[:, :21], te[:, 21])


def kuka(root: str, part: int = 1):
    """KUKA arm dynamics npz (datasets.py:253-262)."""
    d = np.load(os.path.join(root, f"kuka{part}.npz"))
    return (d["X_train"], d["Y_train"]), (d["X_test"], d["Y_test"])


#: the reference's fixed in-domain -> OOD pairing (evaluate.py:221-243)
OOD_PAIRS = {
    "mnist": "kmnist",
    "cifar10": "svhn",
    "gtsrb": "cifar10",
    "tiny": "art",
    "imagenet": "art",
}
