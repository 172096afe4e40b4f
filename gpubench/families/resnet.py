"""The program's side of a ResNet configuration: the port's
``models.resnet.ResNet`` at the configuration's widths, given the seeded
weights, in the memory format the configuration states."""
import torch

from gpubench.reference import resnet as reference


def build(cfg, weights, device):
    from curvature_tpu_torch.models.resnet import (
        BasicBlock, Bottleneck, ResNet)
    block = Bottleneck if cfg["block"] == "bottleneck" else BasicBlock
    with torch.device(device):
        model = ResNet(block, cfg["layers"], cfg["num_classes"], cfg["stem"],
                       groups=cfg.get("groups", 1),
                       base_width=cfg.get("width_per_group", 64))
    model.load_state_dict(weights)
    return model.to(memory_format=_format(cfg))


def program_input(cfg, x: torch.Tensor) -> torch.Tensor:
    """The images as the program is fed them."""
    return x.contiguous(memory_format=_format(cfg))


def _format(cfg):
    return getattr(torch, cfg.get("memory_format", "contiguous_format"))
