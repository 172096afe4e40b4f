"""Tiny configurations of the benchmark's families for the CPU tests:
the published configurations' keys at widths a test run can hold."""
import json
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(file_stem: str, /, **changes):
    cfg = json.loads((CONFIGS / f"{file_stem}.json").read_text())
    cfg.update(changes)
    return cfg


def resnet(**changes):
    """ResNet-50's file at one Bottleneck a stage, 10 classes, 64^2."""
    return config("resnet50-imagenet", **dict(
        dict(name="tiny-resnet", layers=[1, 1, 1, 1], num_classes=10,
             image_size=64), **changes))


def basic_resnet(**changes):
    """A BasicBlock ResNet with the CIFAR stem at 16^2."""
    return resnet(**dict(dict(name="tiny-basic", block="basic",
                              stem="cifar", image_size=16), **changes))


def gpt2(**changes):
    """GPT-2's file at vocabulary 64, width 32, two blocks, 16 positions."""
    return config("gpt2-124m", **dict(
        dict(name="tiny-gpt2", vocab_size=64, n_embd=32, n_layer=2,
             n_head=2, n_positions=16, n_ctx=16), **changes))
