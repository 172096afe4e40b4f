from curvature_tpu_torch.models.convert import (
    load_jax_variables, seeded_variables, state_dict_from_jax,
)
from curvature_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet, resnet, resnet18, resnet50,
)

__all__ = ["load_jax_variables", "seeded_variables", "state_dict_from_jax",
           "BasicBlock", "Bottleneck", "ResNet", "resnet", "resnet18",
           "resnet50"]
