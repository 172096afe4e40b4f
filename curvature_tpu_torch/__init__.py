"""PyTorch/CUDA port of ``curvature_tpu``: the KFAC Laplace loop on an
NVIDIA Hopper card.

The subpackages mirror the JAX package (``nn``, ``ops``, ``estimators``,
``eval``, ``models``, ``data``, ``utils``) so each module has an obvious
counterpart there. Modules are NCHW ``torch.nn.Module``s with OIHW weights
and torchvision state-dict names; the conv-patch Gram kernels that the JAX
package wrote in Pallas are hand-written CUDA C++ under ``ops/cuda``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.

The package exports the JAX package's public names where a counterpart
exists (its ``__init__`` files' ``__all__``, name for name, in the same
subpackage); the README's port section lists the names that have none and
why. Importing it does no CUDA work: the kernels build at first use.
"""
__version__ = "0.1.0"

from curvature_tpu_torch import data, estimators, models, nn, ops, parallel
from curvature_tpu_torch.estimators import (
    EFB, INF, KFAC, BlockDiagonal, Diagonal)
from curvature_tpu_torch import laplace
from curvature_tpu_torch.utils.device import resolve_device

__all__ = [
    "nn", "ops", "models", "estimators", "parallel", "data",
    "Diagonal", "BlockDiagonal", "KFAC", "EFB", "INF", "resolve_device",
]
