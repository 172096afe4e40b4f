"""PyTorch checkpoints (``.pth``) of the reference's models.

Port of ``curvature_tpu/models/torch_convert.py``: the port's modules
carry torchvision's names and layouts (OIHW convs, ``[out, in]`` dense
weights, BatchNorm ``weight``/``bias``/``running_mean``/``running_var``,
raw tensors such as ViT's ``class_token`` and Swin's bias tables and
index buffers), so a torchvision-named state dict loads almost as it is.
:func:`convert_torch_state_dict` renames layers by a ``key_map`` (LeNet-5's
positional ``TORCH_KEY_MAP``), drops ``num_batches_tracked`` and unpacks
``nn.MultiheadAttention``'s ``in_proj_weight``/``in_proj_bias`` into the
port's ``in_proj`` Dense (JAX :46-84; its ``out_proj`` is a submodule in
both); :func:`load_torch_checkpoint` reads a file with ``torch.load(...,
weights_only=True)``, gathers a ScanBlocks model's per-depth entries into
its stacks, and returns the model's weights in the JAX layout
(``models.variables_to_jax``), so both packages load one ``.pth`` to the
same numbers and share one shape check (``pipelines.common.build_model``);
:func:`export_torch_state_dict` writes a state dict back in the torch
layout, the attention projections packed again (JAX :231-234), each
BatchNorm with a zero ``num_batches_tracked``.
"""
from typing import Dict, Optional

import torch
from torch import nn


def _rename(key: str, key_map: Optional[Dict[str, str]]) -> str:
    layer, _, pname = key.rpartition(".")
    if key_map is not None:
        layer = key_map.get(layer, layer)
    return f"{layer}.{pname}" if layer else pname


def convert_torch_state_dict(state_dict: Dict,
                             key_map: Optional[Dict[str, str]] = None
                             ) -> Dict[str, torch.Tensor]:
    """A torch state dict (tensors or numpy arrays) as the port's: layer
    prefixes renamed by ``key_map`` (torch prefix -> layer name; identity
    for torchvision-named models), ``num_batches_tracked`` dropped, every
    leaf a float32 CPU tensor (JAX :25-58)."""
    attn = {k[:-len(".in_proj_weight")] for k in state_dict
            if k.endswith(".in_proj_weight")}
    for layer in attn:
        if f"{layer}.in_proj_bias" not in state_dict:
            raise ValueError(
                f"{layer}: bias-free MultiheadAttention is not supported by "
                "the conversion (our in_proj Dense expects a bias)")
    out = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        layer, _, pname = key.rpartition(".")
        if pname in _UNPACKED:
            raise ValueError(
                f"{layer}: unpacked attention projections ({pname}) are not "
                "supported — only the packed in_proj_weight layout converts")
        if pname in ("in_proj_weight", "in_proj_bias"):
            key = f"{layer}.in_proj.{pname[len('in_proj_'):]}"
        out[_rename(key, key_map)] = torch.as_tensor(val).detach().to(
            "cpu", torch.float32).clone()
    return out


#: torch's separate q/k/v projections (``kdim``/``vdim`` differ): no Dense
#: of the port holds them (JAX :77-87)
_UNPACKED = ("q_proj_weight", "k_proj_weight", "v_proj_weight", "bias_k",
             "bias_v")


def _stack_scan_blocks(state: Dict[str, torch.Tensor], model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """A checkpoint's per-depth entries (``encoder.layers.encoder_layer_{i}
    .mlp.0.weight``) gathered into each ScanBlocks stack's ``[depth, ...]``
    entry (``encoder.layers.mlp.0.weight``; JAX :123-165); a model without
    stacks, or a state already stacked, passes through."""
    from curvature_tpu_torch.nn.scan import ScanBlocks
    state = dict(state)
    for sb in model.modules():
        if not isinstance(sb, ScanBlocks) or not sb.per_depth_names:
            continue
        for pname in sb.param_names:
            names = [f"{pd}.{pname}" for pd in sb.per_depth_names]
            if all(n in state for n in names):
                state[f"{sb.name}.{pname}"] = torch.stack(
                    [state.pop(n) for n in names])
    return state


def load_torch_checkpoint(path: str, model: nn.Module,
                          key_map: Optional[Dict[str, str]] = None) -> Dict:
    """Read a ``.pth`` (a state dict, or a pickled module's) and return
    ``model``'s weights from it as JAX-layout variables (what JAX's
    ``load_torch_checkpoint`` gives for the same file). Entries no module
    of ``model`` owns (torchvision's auxiliary heads) are dropped, as
    JAX's ``apply`` never reads them; a missing one raises at load."""
    from curvature_tpu_torch.models.convert import variables_to_jax
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    state = _stack_scan_blocks(convert_torch_state_dict(state, key_map),
                               model)
    own = model.state_dict()
    return variables_to_jax(model, {k: v for k, v in state.items()
                                    if k in own})


def export_torch_state_dict(state: Dict[str, torch.Tensor],
                            key_map: Optional[Dict[str, str]] = None
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_torch_state_dict`: the port's state dict
    in the torch layout, float32 CPU tensors, an attention's
    ``<attn>.in_proj.weight``/``.bias`` as ``<attn>.in_proj_weight``/
    ``in_proj_bias``, each BatchNorm's ``num_batches_tracked`` (a zero
    int64) after its running variance, where torch keeps it. ``key_map``
    maps the port's layer names back to torch prefixes: the inverse of the
    map used at conversion (JAX :177-213). A ScanBlocks model's stacked
    state must be unstacked first (``models.unstack_scan_groups``), as in
    JAX."""
    out = {}
    for key, val in state.items():
        layer, _, pname = key.rpartition(".")
        if layer.endswith(".in_proj") or layer == "in_proj":
            key = f"{layer[:-len('in_proj')]}in_proj_{pname}"
        name = _rename(key, key_map)
        out[name] = val.detach().to("cpu", torch.float32).clone()
        if name.endswith(".running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return out
