"""Synthetic data (copies of ``synthetic_images``,
``synthetic_classification`` and ``synthetic_tokens`` from
``curvature_tpu/data/synthetic.py``, drawing the same numbers from
the same generator; no dataset downloads are possible here). Images come
out NHWC as in the JAX package; transpose to NCHW for the port's
models."""
from typing import Tuple

import numpy as np


def synthetic_images(rng: np.random.Generator, num: int, height: int,
                     width: int, channels: int, num_classes: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    x = rng.standard_normal((num, height, width, channels), dtype=np.float32)
    y = rng.integers(0, num_classes, size=(num,))
    return x, y.astype(np.int32)


def synthetic_classification(rng: np.random.Generator, num: int, dim: int,
                             num_classes: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian features [N, dim] labelled by a random linear map plus
    noise."""
    x = rng.standard_normal((num, dim), dtype=np.float32)
    w = rng.standard_normal((dim, num_classes), dtype=np.float32)
    y = np.argmax(x @ w + rng.standard_normal((num, num_classes)) * 0.1,
                  axis=1)
    return x, y.astype(np.int32)


def synthetic_tokens(rng: np.random.Generator, num: int, seq_len: int,
                     vocab: int, order: float = 0.8,
                     perm: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Markov token streams for causal-LM pipelines: (inputs [N, T],
    next-token labels [N, T]). Each step follows a fixed random
    permutation of the vocab with probability ``order``, else jumps
    uniformly; pass the same ``perm`` across splits so they share the
    process while drawing disjoint sequences."""
    if perm is None:
        perm = rng.permutation(vocab)
    seq = np.empty((num, seq_len + 1), dtype=np.int64)
    seq[:, 0] = rng.integers(0, vocab, size=num)
    for t in range(seq_len):
        follow = rng.random(num) < order
        seq[:, t + 1] = np.where(follow, perm[seq[:, t]],
                                 rng.integers(0, vocab, size=num))
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
