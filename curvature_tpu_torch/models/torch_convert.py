"""PyTorch checkpoints (``.pth``) of the reference's models.

Port of ``curvature_tpu/models/torch_convert.py`` for the conv families:
the port's modules carry torchvision's names and layouts (OIHW convs,
``[out, in]`` dense weights, BatchNorm ``weight``/``bias``/
``running_mean``/``running_var``), so a torchvision-named state dict
loads almost as it is. :func:`convert_torch_state_dict` renames layers by
a ``key_map`` (LeNet-5's positional ``TORCH_KEY_MAP``) and drops
``num_batches_tracked``; :func:`load_torch_checkpoint` reads a file with
``torch.load(..., weights_only=True)`` and returns the model's weights in
the JAX layout (``models.variables_to_jax``), so both packages load one
``.pth`` to the same numbers and share one shape check
(``pipelines.common.build_model``); :func:`export_torch_state_dict`
writes a state dict back in the torch layout, each BatchNorm with a zero
``num_batches_tracked``. The attention and ScanBlocks branches of the JAX
module wait for the transformers (ROADMAP Queue 1 item 6).
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
    out = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        out[_rename(key, key_map)] = torch.as_tensor(val).detach().to(
            "cpu", torch.float32).clone()
    return out


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
    state = convert_torch_state_dict(state, key_map)
    own = model.state_dict()
    return variables_to_jax(model, {k: v for k, v in state.items()
                                    if k in own})


def export_torch_state_dict(state: Dict[str, torch.Tensor],
                            key_map: Optional[Dict[str, str]] = None
                            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_torch_state_dict`: the port's state dict
    in the torch layout, float32 CPU tensors, each BatchNorm's
    ``num_batches_tracked`` (a zero int64) after its running variance,
    where torch keeps it. ``key_map`` maps the port's layer names back to
    torch prefixes: the inverse of the map used at conversion (JAX
    :177-213)."""
    out = {}
    for key, val in state.items():
        name = _rename(key, key_map)
        out[name] = val.detach().to("cpu", torch.float32).clone()
        if name.endswith(".running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return out
