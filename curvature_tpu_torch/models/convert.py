"""Carry weights across from the JAX package's ``variables`` layout.

The JAX package keeps ``{"params": {layer: {...}}, "batch_stats": {layer:
{"mean", "var"}}}`` with HWIO conv kernels and ``[in, out]`` dense
kernels. :func:`state_dict_from_jax` turns such variables, given as numpy
arrays, into this port's state dict; :func:`seeded_variables` makes
variables in that layout from a numpy seed (there are no ResNet weights
in the repository, so tests and the chip smoke build them this way and
hand the same numbers to both packages).
"""
from typing import Dict

import numpy as np
import torch
from torch import nn

from curvature_tpu_torch.nn import BatchNorm, Conv, Dense


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy variables -> this port's state dict (CPU tensors):
    conv HWIO -> OIHW, dense [in, out] -> [out, in], BN scale/bias ->
    weight/bias, batch_stats mean/var -> running_mean/running_var."""
    sd = {}
    for layer, p in variables["params"].items():
        if "kernel" in p:
            k = np.asarray(p["kernel"], np.float32)
            k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            sd[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
            if "bias" in p:
                sd[f"{layer}.bias"] = torch.from_numpy(
                    np.asarray(p["bias"], np.float32).copy())
        else:
            sd[f"{layer}.weight"] = torch.from_numpy(
                np.asarray(p["scale"], np.float32).copy())
            sd[f"{layer}.bias"] = torch.from_numpy(
                np.asarray(p["bias"], np.float32).copy())
    for layer, s in variables.get("batch_stats", {}).items():
        sd[f"{layer}.running_mean"] = torch.from_numpy(
            np.asarray(s["mean"], np.float32).copy())
        sd[f"{layer}.running_var"] = torch.from_numpy(
            np.asarray(s["var"], np.float32).copy())
    return sd


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load JAX-layout numpy variables into ``model`` (strict)."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def seeded_variables(model: nn.Module, seed: int,
                     residual_gain: float = 0.2) -> Dict:
    """Random JAX-layout numpy variables for ``model`` from a numpy seed:
    He-normal conv/dense kernels, small dense biases, BN scale near 1 and
    bias near 0, running statistics near (0, 1). The last BN of each
    residual block has its scale multiplied by ``residual_gain`` (the
    usual damped-residual init), so that eval-mode activations do not grow
    block by block and the random network's softmax stays unsaturated."""
    from curvature_tpu_torch.models.resnet import BasicBlock, Bottleneck
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    residual_bns = set()
    for name, m in model.named_modules():
        if isinstance(m, Bottleneck):
            residual_bns.add(f"{name}.bn3")
        elif isinstance(m, BasicBlock):
            residual_bns.add(f"{name}.bn2")
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            o, c, kh, kw = m.weight.shape
            std = np.sqrt(2.0 / (c * kh * kw))
            params[name] = {"kernel": (std * rng.standard_normal(
                (kh, kw, c, o))).astype(np.float32)}
            if m.bias is not None:
                params[name]["bias"] = (0.01 * rng.standard_normal(o)
                                        ).astype(np.float32)
        elif isinstance(m, Dense):
            o, i = m.weight.shape
            params[name] = {"kernel": (np.sqrt(1.0 / i) * rng.standard_normal(
                (i, o))).astype(np.float32)}
            if m.bias is not None:
                params[name]["bias"] = (0.01 * rng.standard_normal(o)
                                        ).astype(np.float32)
        elif isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            gain = residual_gain if name in residual_bns else 1.0
            params[name] = {
                "scale": (gain * rng.uniform(0.8, 1.2, n)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}
            stats[name] = {
                "mean": (0.05 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.8, 1.2, n).astype(np.float32)}
    return {"params": params, "batch_stats": stats}
