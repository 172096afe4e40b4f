"""Synthetic data (a copy of ``synthetic_images`` from
``curvature_tpu/data/synthetic.py``; no dataset downloads are possible
here). Images come out NHWC as in the JAX package; transpose to NCHW for
the port's models."""
from typing import Tuple

import numpy as np


def synthetic_images(rng: np.random.Generator, num: int, height: int,
                     width: int, channels: int, num_classes: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    x = rng.standard_normal((num, height, width, channels), dtype=np.float32)
    y = rng.integers(0, num_classes, size=(num,))
    return x, y.astype(np.int32)
