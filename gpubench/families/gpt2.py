"""The program's side of a GPT-2 configuration: the port's
``models.gpt.GPT2`` with its blocks depth-stacked (``scan_blocks``), the
layout of the reference's parameters and factors, given the seeded
weights."""
import torch

from gpubench.reference import gpt2 as reference


def build(cfg, weights, device):
    from curvature_tpu_torch.models.gpt import GPT2
    if not cfg.get("scan_blocks"):
        raise ValueError(f"{cfg['name']}: the benchmark runs GPT-2 with "
                         "scan_blocks true")
    with torch.device(device):
        model = GPT2(cfg["vocab_size"], cfg["n_embd"], cfg["n_layer"],
                     cfg["n_head"], cfg["n_positions"], scan_blocks=True)
    model.load_state_dict(weights)
    return model


def program_input(cfg, x: torch.Tensor) -> torch.Tensor:
    """Token ids as they are."""
    return x
