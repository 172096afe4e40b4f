"""A small MLP (port of ``curvature_tpu/models/mlp.py``): dense layers
``fc1``.. with ReLUs between them, on flat ``[B, in_features]`` inputs
(the regression sets). JAX infers the input width at ``init``; here it
is ``in_features``."""
from typing import Sequence

from curvature_tpu_torch.nn import Dense, ReLU, Sequential
from curvature_tpu_torch.utils.device import resolve_device


def mlp(features: Sequence[int], num_classes: int, in_features: int,
        device=None) -> Sequential:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    layers, cin = [], in_features
    for i, f in enumerate(features):
        layers += [Dense(cin, f, name=f"fc{i + 1}"), ReLU()]
        cin = f
    layers.append(Dense(cin, num_classes, name=f"fc{len(features) + 1}"))
    return Sequential(layers).to(resolve_device(device))
