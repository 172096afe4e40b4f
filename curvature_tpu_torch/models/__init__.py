from curvature_tpu_torch.models.convert import (
    load_jax_variables, seeded_variables, stack_scan_groups,
    state_dict_from_jax, state_from_jax, unstack_scan_groups,
)
from curvature_tpu_torch.models.gpt import (
    GPT2, convert_gpt2_state_dict, gpt2, gpt2_custom, gpt2_large,
    gpt2_medium, gpt2_tiny, gpt2_xl,
)
from curvature_tpu_torch.models.lenet5 import lenet5
from curvature_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet, resnet, resnet18, resnet50,
)

#: the ported families, by the JAX registry's names (models/__init__.py)
MODEL_REGISTRY = {"lenet5": lenet5, "resnet18": resnet18,
                  "resnet50": resnet50, "gpt2_tiny": gpt2_tiny, "gpt2": gpt2,
                  "gpt2_medium": gpt2_medium, "gpt2_large": gpt2_large,
                  "gpt2_xl": gpt2_xl}


def build(name: str, num_classes: int = 1000, device=None, **kw):
    """Build a model by its JAX registry name on ``device`` (CUDA unless
    ``"cpu"`` is passed); ``kw`` go to the constructor (``stem``; for
    GPT-2 ``scan_blocks`` and ``max_len``). The other families of the JAX
    zoo are not ported yet."""
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue 1 item 9); "
            f"ported: {', '.join(sorted(MODEL_REGISTRY))}")
    return MODEL_REGISTRY[name](num_classes=num_classes, device=device, **kw)


__all__ = ["load_jax_variables", "seeded_variables", "stack_scan_groups",
           "state_dict_from_jax", "state_from_jax", "unstack_scan_groups",
           "GPT2", "convert_gpt2_state_dict", "gpt2", "gpt2_custom",
           "gpt2_large", "gpt2_medium", "gpt2_tiny", "gpt2_xl", "lenet5", "BasicBlock", "Bottleneck", "ResNet",
           "resnet", "resnet18", "resnet50", "MODEL_REGISTRY", "build"]
