"""Shared dtype-cast helpers.

Port of ``curvature_tpu/utils/casting.py``: the estimators' compute-dtype
capture casts a parameter dict with :func:`cast_floats` and the model
input with :func:`cast_input`.
"""
from typing import Dict, Optional

import torch


def cast_floats(params: Dict[str, torch.Tensor], dtype: Optional[torch.dtype]
                ) -> Dict[str, torch.Tensor]:
    """Cast every floating-point tensor of a ``{name: tensor}`` dict to
    ``dtype`` (detached: the cast copy is an input, not a leaf to train);
    integer and bool tensors pass through. ``dtype=None`` returns the dict
    as it is."""
    if dtype is None:
        return params
    return {k: v.detach().to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def cast_input(x: torch.Tensor, dtype: Optional[torch.dtype]
               ) -> torch.Tensor:
    """Cast a model input to ``dtype`` only when it is floating-point
    (integer inputs such as token ids pass through unchanged)."""
    if dtype is None or not x.is_floating_point():
        return x
    return x.to(dtype)
