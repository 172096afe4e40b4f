from functools import partial

from curvature_tpu_torch.models.convert import (
    load_jax_variables, seeded_variables, stack_scan_groups,
    state_dict_from_jax, state_from_jax, unstack_scan_groups,
    variables_to_jax,
)
from curvature_tpu_torch.models.alexnet import AlexNet, alexnet
from curvature_tpu_torch.models.convnext import (
    ConvNeXt, convnext, convnext_tiny,
)
from curvature_tpu_torch.models.deepseek import (
    MOONLIGHT_16B_A3B, DeepseekV3, deepseek_v3, deepseek_v3_tiny,
    moonlight_16b_a3b,
)
from curvature_tpu_torch.models.densenet import (
    DenseNet, densenet, densenet121, densenet161, densenet169, densenet201,
)
from curvature_tpu_torch.models.efficientnet import (
    EfficientNet, efficientnet, efficientnet_b0,
)
from curvature_tpu_torch.models.googlenet import GoogLeNet, googlenet
from curvature_tpu_torch.models.gpt import (
    GPT2, convert_gpt2_state_dict, gpt2, gpt2_custom, gpt2_large,
    gpt2_medium, gpt2_moe_custom, gpt2_moe_tiny, gpt2_tiny, gpt2_xl,
)
from curvature_tpu_torch.models.inception import InceptionV3, inception_v3
from curvature_tpu_torch.models.lenet5 import TORCH_KEY_MAP, lenet5
from curvature_tpu_torch.models.maxvit import MaxVit, maxvit, maxvit_t
from curvature_tpu_torch.models.mlp import mlp
from curvature_tpu_torch.models.mnasnet import MNASNet, mnasnet, mnasnet1_0
from curvature_tpu_torch.models.mobilenet import (
    MobileNetV2, MobileNetV3, mobilenet_v2, mobilenet_v3_large,
    mobilenet_v3_small,
)
from curvature_tpu_torch.models.regnet import RegNet, regnet
from curvature_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet, resnet, resnet18, resnet34, resnet50,
    resnet101, resnet152,
)
from curvature_tpu_torch.models.shufflenet import (
    ShuffleNetV2, shufflenet_v2, shufflenet_v2_x1_0,
)
from curvature_tpu_torch.models.squeezenet import (
    SqueezeNet, squeezenet, squeezenet1_0, squeezenet1_1,
)
from curvature_tpu_torch.models.swin import SwinTransformer, swin, swin_t
from curvature_tpu_torch.models.torch_convert import (
    convert_torch_state_dict, export_torch_state_dict, load_torch_checkpoint,
)
from curvature_tpu_torch.models.transformer import (
    TinyTransformer, tiny_transformer,
)
from curvature_tpu_torch.models.transformer2 import (
    Encoder, transformer_encoder,
)
from curvature_tpu_torch.models.vgg import VGG, vgg, vgg11, vgg13, vgg16, vgg19
from curvature_tpu_torch.models.vit import (
    VisionTransformer, vit, vit_arch, vit_b_16, vit_b_32, vit_h_14, vit_l_16,
    vit_l_32,
)

#: the ported families, by the JAX registry's names (models/__init__.py);
#: a named constructor where the family defines one with the registry's
#: defaults (``resnet18``'s own default is the CIFAR stem, the registry's
#: the ImageNet one, as in JAX)
MODEL_REGISTRY = {
    "lenet5": lenet5,
    # flat inputs: pass ``in_features`` (JAX infers it at init)
    "mlp": partial(mlp, (128, 64)),
    "resnet18": partial(resnet, "resnet18"),
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    **{a: partial(resnet, a) for a in
       ("resnext50_32x4d", "resnext101_32x8d", "resnext101_64x4d",
        "wide_resnet50_2", "wide_resnet101_2")},
    "densenet121": densenet121,
    "densenet161": densenet161,
    "densenet169": densenet169,
    "densenet201": densenet201,
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    **{f"{a}_bn": partial(vgg, a, batch_norm=True)
       for a in ("vgg11", "vgg13", "vgg16", "vgg19")},
    "googlenet": googlenet,
    "inception_v3": inception_v3,
    "mobilenet_v2": mobilenet_v2,
    "mobilenet_v3_large": mobilenet_v3_large,
    "mobilenet_v3_small": mobilenet_v3_small,
    **{a: partial(efficientnet, a) for a in
       ("efficientnet_b0", "efficientnet_b1", "efficientnet_b2",
        "efficientnet_b3", "efficientnet_b4", "efficientnet_b5",
        "efficientnet_b6", "efficientnet_b7",
        "efficientnet_v2_s", "efficientnet_v2_m", "efficientnet_v2_l")},
    **{a: partial(shufflenet_v2, a) for a in
       ("shufflenet_v2_x0_5", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0")},
    "shufflenet_v2_x1_0": shufflenet_v2_x1_0,
    "squeezenet1_0": squeezenet1_0,
    "squeezenet1_1": squeezenet1_1,
    "convnext_tiny": convnext_tiny,
    **{a: partial(convnext, a) for a in
       ("convnext_small", "convnext_base", "convnext_large")},
    **{a: partial(regnet, a) for a in
       ("regnet_y_400mf", "regnet_y_800mf", "regnet_y_1_6gf",
        "regnet_y_3_2gf", "regnet_y_8gf", "regnet_y_16gf", "regnet_y_32gf",
        "regnet_y_128gf",
        "regnet_x_400mf", "regnet_x_800mf", "regnet_x_1_6gf",
        "regnet_x_3_2gf", "regnet_x_8gf", "regnet_x_16gf",
        "regnet_x_32gf")},
    "alexnet": alexnet,
    **{f"mnasnet{s}": partial(mnasnet, a)
       for s, a in (("0_5", 0.5), ("0_75", 0.75), ("1_3", 1.3))},
    "mnasnet1_0": mnasnet1_0,
    **{a: partial(vit_arch, a) for a in
       ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14")},
    **{a: partial(swin, a) for a in
       ("swin_t", "swin_s", "swin_b", "swin_v2_t", "swin_v2_s",
        "swin_v2_b")},
    "maxvit_t": maxvit_t,
    "gpt2_tiny": gpt2_tiny,
    "gpt2": gpt2,
    "gpt2_medium": gpt2_medium,
    "gpt2_large": gpt2_large,
    "gpt2_xl": gpt2_xl,
    "gpt2_moe_tiny": gpt2_moe_tiny,
    # port-only: the DeepSeek-V3 block (MLA, sigmoid-routed MoE)
    "deepseek_v3_tiny": deepseek_v3_tiny,
    "moonlight_16b_a3b": moonlight_16b_a3b,
}


def build(name: str, num_classes: int = 1000, device=None, **kw):
    """Build a model by its JAX registry name on ``device`` (CUDA unless
    ``"cpu"`` is passed); ``kw`` go to the constructor (``stem`` for the
    ResNets; for GPT-2 ``scan_blocks`` and ``max_len``; ``in_features``
    for ``mlp``; ``image_size`` and ``scan_blocks`` for the ViTs,
    ``partition`` for MaxViT; ``experts`` for ``gpt2_moe_tiny``)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{', '.join(sorted(MODEL_REGISTRY))}")
    return MODEL_REGISTRY[name](num_classes=num_classes, device=device, **kw)


__all__ = ["AlexNet", "alexnet", "DenseNet", "densenet", "GoogLeNet",
           "googlenet", "InceptionV3", "inception_v3", "mlp", "SqueezeNet",
           "squeezenet", "VGG", "vgg", "TORCH_KEY_MAP",
           "convert_torch_state_dict", "export_torch_state_dict",
           "load_torch_checkpoint", "load_jax_variables", "seeded_variables", "stack_scan_groups",
           "state_dict_from_jax", "state_from_jax", "unstack_scan_groups",
           "variables_to_jax",
           "ConvNeXt", "convnext", "EfficientNet", "efficientnet",
           "efficientnet_b0", "GPT2", "convert_gpt2_state_dict", "gpt2",
           "gpt2_custom", "gpt2_large", "gpt2_medium", "gpt2_moe_custom",
           "gpt2_moe_tiny", "gpt2_tiny", "gpt2_xl", "lenet5", "MNASNet",
           "mnasnet", "MobileNetV2", "MobileNetV3", "mobilenet_v2", "mobilenet_v3_large",
           "mobilenet_v3_small", "RegNet", "regnet", "BasicBlock",
           "Bottleneck", "ResNet", "resnet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "densenet121",
           "densenet161", "densenet169", "densenet201", "vgg11", "vgg13",
           "vgg16", "vgg19", "mnasnet1_0", "shufflenet_v2_x1_0",
           "squeezenet1_0", "squeezenet1_1", "convnext_tiny",
           "ShuffleNetV2", "shufflenet_v2", "MaxVit", "maxvit", "maxvit_t",
           "SwinTransformer", "swin", "swin_t", "TinyTransformer",
           "tiny_transformer", "Encoder", "transformer_encoder",
           "VisionTransformer", "vit", "vit_arch", "vit_b_16", "vit_b_32",
           "vit_h_14", "vit_l_16", "vit_l_32", "MODEL_REGISTRY", "build"]
