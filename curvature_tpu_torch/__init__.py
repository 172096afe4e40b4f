"""PyTorch/CUDA port of ``curvature_tpu``: the KFAC Laplace loop on an
NVIDIA Hopper card.

The subpackages mirror the JAX package (``nn``, ``ops``, ``estimators``,
``eval``, ``models``, ``data``, ``utils``) so each module has an obvious
counterpart there. Modules are NCHW ``torch.nn.Module``s with OIHW weights
and torchvision state-dict names; the conv-patch Gram kernels that the JAX
package wrote in Pallas are hand-written CUDA C++ under ``ops/cuda``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.
"""
from curvature_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
