"""Carry weights across from the JAX package's ``variables`` layout.

The JAX package keeps ``{"params": {layer: {...}}, "batch_stats": {layer:
{"mean", "var"}}}`` with HWIO conv kernels and ``[in, out]`` dense
kernels (``[depth, in, out]`` in a ScanBlocks stack; a grouped conv's
kernel is ``[kh, kw, C/g, O]``, torch's ``[O, C/g, kh, kw]``), and raw
parameters such as ConvNeXt's ``layer_scale``, ViT's ``class_token`` and
``encoder.pos_embedding`` or Swin's bias tables as ``{"value": ...}``,
where the port keeps buffers among them too (Swin's and MaxViT's
``relative_position_index``, Swin V2's ``relative_coords_table``: JAX
keeps them as params). An attention projection is ``<attn>/in_proj`` in
JAX and the module ``<attn>.in_proj`` here (``nn.core.param_key``).
:func:`state_dict_from_jax` turns such variables, given as numpy arrays,
into this port's state dict; :func:`seeded_variables` makes variables in
that layout from a numpy seed (there are no ResNet or GPT-2 weights in the
repository, so tests and the chip smoke build them this way and hand the
same numbers to both packages). :func:`variables_to_jax` is the inverse
of :func:`state_dict_from_jax`: it writes a model's state in the JAX
layout (the training pipeline's checkpoints, read by both packages).
:func:`stack_scan_groups` and
:func:`unstack_scan_groups` move such variables between a stacked model's
``h.*`` names and an unrolled model's ``h.{i}.*`` (JAX
models/torch_convert.py:123-195).
"""
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from curvature_tpu_torch.nn import (BatchNorm, Conv, Dense, LayerNorm,
                                    param_key)


def state_dict_from_jax(variables: Dict, lead: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """JAX-layout numpy variables -> this port's state dict (CPU tensors):
    conv HWIO -> OIHW (grouped: [kh, kw, C/g, O] -> [O, C/g, kh, kw]),
    dense [(depth,) in, out] -> [(depth,) out, in] (``<attn>/in_proj`` ->
    ``<attn>.in_proj.weight``), BN and LayerNorm scale/bias ->
    weight/bias, embedding tables (``wte``, ``wpe``: ``weight``) as they
    are, a raw parameter group ``{"value": v}`` (JAX ConvNeXt's
    ``{block}.layer_scale``) -> the parameter or buffer ``{block}.
    layer_scale``, any other group's leaves (the encoder transformer's
    ``embed`` ``table`` and ``pos``) under their own names, batch_stats
    mean/var -> running_mean/running_var. ``lead`` leading axes of every
    leaf pass through untouched (SWAG's ``[K, ...]`` deviation buffer): a
    kernel is a conv's when it has four axes past them."""
    sd = {}
    for layer, p in variables["params"].items():
        if "kernel" in p:
            k = np.asarray(p["kernel"], np.float32)
            if k.ndim - lead == 4:
                k = k.transpose(tuple(range(lead)) + tuple(
                    lead + i for i in (3, 2, 0, 1)))
            else:
                k = k.swapaxes(-1, -2)
            sd[param_key(layer, "weight")] = torch.from_numpy(
                np.ascontiguousarray(k))
            if "bias" in p:
                sd[param_key(layer, "bias")] = torch.from_numpy(
                    np.asarray(p["bias"], np.float32).copy())
        elif "weight" in p:
            sd[param_key(layer, "weight")] = torch.from_numpy(
                np.asarray(p["weight"], np.float32).copy())
        elif "value" in p:
            sd[layer] = torch.from_numpy(
                np.asarray(p["value"], np.float32).copy())
        elif "scale" not in p:
            for key, val in p.items():
                sd[param_key(layer, key)] = torch.from_numpy(
                    np.asarray(val, np.float32).copy())
        else:
            sd[param_key(layer, "weight")] = torch.from_numpy(
                np.asarray(p["scale"], np.float32).copy())
            sd[param_key(layer, "bias")] = torch.from_numpy(
                np.asarray(p["bias"], np.float32).copy())
    for layer, s in variables.get("batch_stats", {}).items():
        sd[f"{layer}.running_mean"] = torch.from_numpy(
            np.asarray(s["mean"], np.float32).copy())
        sd[f"{layer}.running_var"] = torch.from_numpy(
            np.asarray(s["var"], np.float32).copy())
    return sd


def variables_to_jax(model: nn.Module,
                     state: Optional[Dict[str, torch.Tensor]] = None,
                     lead: int = 0) -> Dict:
    """Inverse of :func:`state_dict_from_jax`: ``state`` (state-dict keys
    -> tensors; the model's own state dict by default) as JAX-layout
    numpy variables. Each leaf is placed by the type of the module that
    owns it, never by its rank: a ``Conv`` weight OIHW -> HWIO (grouped
    [O, C/g, kh, kw] -> [kh, kw, C/g, O]), a ``Dense`` weight [(depth,)
    out, in] -> [(depth,) in, out] under the layer's name (an attention
    projection's ``<attn>/in_proj``), ``BatchNorm``/``LayerNorm`` weight
    -> ``scale``, an embedding's ``weight`` as it is, a module's raw
    parameter or buffer (ConvNeXt's ``layer_scale``, ViT's
    ``class_token``, Swin's ``relative_position_index``) -> ``{"value":
    ...}`` (a buffer as float32, as JAX keeps it), the leaves of a module
    marked ``jax_group`` (the encoder transformer's ``embed``) under one
    group, ``running_mean``/``running_var`` -> ``batch_stats``
    ``mean``/``var``.
    ``lead`` leading axes of every leaf pass through untouched (SWAG's
    ``[K, ...]`` deviation buffer). A state holding only parameters gives
    no ``batch_stats``; a key no rule places raises ``KeyError``."""
    state = model.state_dict() if state is None else state
    params, stats = {}, {}
    kept = set()
    lead_axes = tuple(range(lead))

    def arr(key):
        kept.add(key)
        return np.ascontiguousarray(state[key].detach().float().cpu().numpy())

    for name, m in model.named_modules():
        keys = {leaf: f"{name}.{leaf}" for leaf in ("weight", "bias",
                                                    "running_mean",
                                                    "running_var")}
        if isinstance(m, (Conv, Dense)) and keys["weight"] in state:
            w = arr(keys["weight"])
            if isinstance(m, Conv):
                w = w.transpose(lead_axes + tuple(lead + i
                                                  for i in (2, 3, 1, 0)))
            else:
                w = w.swapaxes(-1, -2)
            layer = m.name or name
            params[layer] = {"kernel": np.ascontiguousarray(w)}
            if keys["bias"] in state:
                params[layer]["bias"] = arr(keys["bias"])
        elif isinstance(m, (BatchNorm, LayerNorm)) \
                and keys["weight"] in state:
            params[name] = {"scale": arr(keys["weight"]),
                            "bias": arr(keys["bias"])}
        elif isinstance(m, nn.Embedding) and keys["weight"] in state:
            params[name] = {"weight": arr(keys["weight"])}
        if isinstance(m, BatchNorm) and keys["running_mean"] in state:
            stats[name] = {"mean": arr(keys["running_mean"]),
                           "var": arr(keys["running_var"])}
        if isinstance(m, (Conv, Dense, BatchNorm, LayerNorm, nn.Embedding)):
            continue
        raw = [p for p, _ in m.named_parameters(recurse=False)] \
            + [b for b, _ in m.named_buffers(recurse=False)]
        for pname in raw:
            key = f"{name}.{pname}" if name else pname
            if key not in state or key in kept:
                continue
            if getattr(m, "jax_group", False):
                params.setdefault(name, {})[pname] = arr(key)
            else:
                params[key] = {"value": arr(key)}
    left = [k for k in state if k not in kept]
    if left:
        raise KeyError(f"no JAX layout for {sorted(left)}")
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def state_from_jax(state, device, dtype: torch.dtype = torch.float32):
    """A JAX estimator's state (a nested dict of arrays: KFAC factors, EFB
    lambdas, diags or eigenvectors) as the port's: the same nesting, each
    leaf a ``dtype`` tensor on ``device``. Every layout is the same
    ``[out, cols]`` matrix view (or square factor) in both packages, so
    nothing is transposed."""
    if isinstance(state, dict):
        return {k: state_from_jax(v, device, dtype) for k, v in state.items()}
    return torch.tensor(np.asarray(state), dtype=dtype, device=device)


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Load JAX-layout numpy variables into ``model`` (strict)."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def seeded_variables(model: nn.Module, seed: int,
                     residual_gain: float = 0.2) -> Dict:
    """Random JAX-layout numpy variables for ``model`` from a numpy seed:
    He-normal conv/dense kernels (a grouped conv's over its (C/g)*kh*kw
    fan-in), small conv/dense biases, BN and LayerNorm scales near 1 and
    biases near 0, running statistics near (0, 1). The last BN of each
    residual branch (a block's ``residual_bn``: ResNet's Bottleneck and
    BasicBlock, MobileNet's and MNASNet's inverted residuals, MBConv,
    FusedMBConv, RegNet's ResBottleneckBlock, where they add to their
    input) has its scale multiplied by ``residual_gain``, and so has
    ConvNeXt's ``layer_scale``, which plays that BN's part (the usual
    damped-residual init), so that eval-mode activations do not grow
    block by block and the random network's softmax stays unsaturated.
    Other raw parameters are N(0, 0.02) (ViT's ``class_token`` and
    ``pos_embedding``, the bias tables, the encoder's ``embed`` group)
    but Swin V2's ``logit_scale``, log(10) as JAX initializes it; buffers
    (the relative-position indices, Swin V2's coordinate table) keep the
    model's own values. A stacked layer's leaves carry its ``[depth]``
    axis. A GPT-2 gets :func:`~curvature_tpu_torch.models.gpt.
    seeded_gpt2`."""
    from curvature_tpu_torch.models.gpt import GPT2, seeded_gpt2
    if isinstance(model, GPT2):
        return seeded_gpt2(model, seed)
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    residual_bns = {f"{name}.{m.residual_bn}"
                    for name, m in model.named_modules()
                    if getattr(m, "residual_bn", None)}
    for name, m in model.named_modules():
        scale = getattr(m, "layer_scale", None)
        if isinstance(scale, nn.Parameter):
            params[f"{name}.layer_scale"] = {"value": (
                residual_gain * rng.uniform(0.8, 1.2, scale.shape)
            ).astype(np.float32)}
        if isinstance(m, Conv):
            o, c, kh, kw = m.weight.shape
            std = np.sqrt(2.0 / (c * kh * kw))
            params[name] = {"kernel": (std * rng.standard_normal(
                (kh, kw, c, o))).astype(np.float32)}
            if m.bias is not None:
                params[name]["bias"] = (0.01 * rng.standard_normal(o)
                                        ).astype(np.float32)
        elif isinstance(m, Dense):
            *lead, o, i = m.weight.shape
            layer = m.name or name
            params[layer] = {"kernel": (np.sqrt(1.0 / i) * rng.standard_normal(
                tuple(lead) + (i, o))).astype(np.float32)}
            if m.bias is not None:
                params[layer]["bias"] = (0.01 * rng.standard_normal(
                    tuple(m.bias.shape))).astype(np.float32)
        elif isinstance(m, LayerNorm):
            n = tuple(m.weight.shape)
            params[name] = {
                "scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}
        elif isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            gain = residual_gain if name in residual_bns else 1.0
            params[name] = {
                "scale": (gain * rng.uniform(0.8, 1.2, n)).astype(np.float32),
                "bias": (0.05 * rng.standard_normal(n)).astype(np.float32)}
            stats[name] = {
                "mean": (0.05 * rng.standard_normal(n)).astype(np.float32),
                "var": rng.uniform(0.8, 1.2, n).astype(np.float32)}
        else:
            _seed_raw(m, name, rng, params)
    return {"params": params, "batch_stats": stats}


def _seed_raw(m: nn.Module, name: str, rng, params: Dict):
    """Seeded values of a module's raw parameters and its buffers (see
    :func:`seeded_variables`), in the JAX layout."""
    for pname, p in m.named_parameters(recurse=False):
        if pname == "layer_scale":
            continue
        if pname == "logit_scale":
            val = np.full(tuple(p.shape), np.log(10.0), np.float32)
        else:
            val = (0.02 * rng.standard_normal(tuple(p.shape))
                   ).astype(np.float32)
        if getattr(m, "jax_group", False):
            params.setdefault(name, {})[pname] = val
        else:
            params[f"{name}.{pname}" if name else pname] = {"value": val}
    for bname, b in m.named_buffers(recurse=False):
        params[f"{name}.{bname}" if name else bname] = {
            "value": b.detach().float().cpu().numpy()}


def stack_scan_groups(variables: Dict, model) -> Dict:
    """Fold per-depth JAX-layout params (``h.{i}.attn.c_attn``) into a
    stacked model's ``[depth, ...]`` entries (``h.attn.c_attn``), from its
    ``scan_groups``; entries already stacked pass through."""
    params = dict(variables.get("params", {}))
    for prefix, info in getattr(model, "scan_groups", {}).items():
        for layer in info["param_layers"]:
            if layer in params:
                continue
            rest = layer[len(prefix):]
            names = [pd + rest for pd in info["per_depth_names"]]
            params[layer] = {k: np.stack([np.asarray(params[n][k])
                                          for n in names])
                             for k in params[names[0]]}
            for n in names:
                del params[n]
    return dict(variables, params=params)


def unstack_scan_groups(variables: Dict, model) -> Dict:
    """Inverse of :func:`stack_scan_groups`: a stacked model's JAX-layout
    variables as the unrolled model's (``h.{i}.*``)."""
    params = dict(variables.get("params", {}))
    for prefix, info in getattr(model, "scan_groups", {}).items():
        for layer in info["param_layers"]:
            stacked = params.pop(layer)
            rest = layer[len(prefix):]
            for i, pd in enumerate(info["per_depth_names"]):
                params[pd + rest] = {k: np.asarray(v)[i]
                                     for k, v in stacked.items()}
    return dict(variables, params=params)
