"""Shared model/data construction for the pipeline CLIs.

Port of ``curvature_tpu/pipelines/common.py`` for the ported families
(the conv zoo, the GPT-2s) and every dataset (mnist, kmnist, cifar10,
svhn, synthetic, tokens, and the image folders of gtsrb, tiny, imagenet
and art, decoded by ``data.images``). The loaders yield NHWC numpy batches (or [B, T]
token ids) as in JAX; :func:`device_batch` moves one to the device, and
:func:`model_input` views an image batch in the models' NCHW order (a
channels_last view: the data is transposed once, in the view). ``--data
tokens`` is the synthetic Markov token stream (512 train / 256 test
sequences of ``--seq_len``, vocabulary ``--vocab`` or 256) with the
per-token Fisher (``loss='lm'``); its OOD set is order-0 (uniform) tokens.
"""
import dataclasses
import os
from typing import Tuple

import numpy as np
import torch

from curvature_tpu_torch import models
from curvature_tpu_torch.data import loaders as D
from curvature_tpu_torch.data.synthetic import (
    synthetic_images, synthetic_tokens)
from curvature_tpu_torch.utils.checkpoint import load_pytree
from curvature_tpu_torch.utils.config import device as config_device

NUM_CLASSES = {"mnist": 10, "kmnist": 10, "cifar10": 10, "svhn": 10,
               "gtsrb": 43, "tiny": 200, "imagenet": 1000, "synthetic": 10,
               "tokens": 256}


def loss_kind(cfg) -> str:
    """Estimator loss for the dataset: the per-token categorical Fisher
    (``'lm'``) for token streams, classification cross-entropy
    otherwise."""
    return "lm" if cfg.data == "tokens" else "cross_entropy"


def seq_len(cfg) -> int:
    return int(getattr(cfg, "seq_len", 0) or 64)


def vocab(cfg) -> int:
    """The token vocabulary: ``--vocab``, else the dataset's 256."""
    return getattr(cfg, "vocab", 0) or NUM_CLASSES["tokens"]


def input_shape(data: str, model: str = "") -> Tuple[int, int, int]:
    """(H, W, C) of the dataset's images."""
    if data in ("mnist", "kmnist"):
        return (28, 28, 1)
    if data in ("cifar10", "svhn", "gtsrb", "synthetic"):
        return (32, 32, 3)
    if data == "tiny":
        return (64, 64, 3)
    if data == "imagenet":
        s = 299 if model == "inception_v3" else 224
        return (s, s, 3)
    raise ValueError(f"unknown dataset {data!r}")


def device_batch(x, device) -> torch.Tensor:
    """One NHWC numpy batch (or a tensor already staged by
    ``data.prefetch.DevicePrefetcher``) as a tensor on ``device`` (same
    layout)."""
    if torch.is_tensor(x):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC [..., H, W, C] -> NCHW [..., C, H, W] view (channels_last
    memory: the kernels read the layer inputs back in NHWC)."""
    return x.movedim(-1, -3)


def model_input(x: torch.Tensor) -> torch.Tensor:
    """A loader batch as the model takes it: image batches (floating
    point) as NCHW views, token ids as they are."""
    return nchw(x) if x.is_floating_point() else x


def on_device(data, device):
    """(model input on ``device``, labels) for each batch of ``data``."""
    for x, y in data:
        yield model_input(device_batch(x, device)), y


def build_model(cfg):
    """Construct the model on the configuration's device and load its
    weights, searched in JAX's order: ``<root>/weights/<model>_<data>.npz``
    (JAX layout), a torch ``.pth`` of the same stem (torchvision names;
    LeNet-5's positional ones through ``TORCH_KEY_MAP``), the bundled
    asset ``models/assets/<model>_<data>.npz``, else a seeded
    initialization (``models.seeded_variables``, the port's own numbers:
    torch and JAX initializers never agree). On CUDA the model is
    channels_last. A GPT-2 goes through :func:`_build_lm_model`."""
    device = config_device(cfg)
    num_classes = NUM_CLASSES.get(cfg.data, 10)
    if cfg.model.startswith("gpt"):
        # --vocab overrides the dataset default (256): 50257 builds the
        # real GPT-2 head, whose KFAC G factor goes blocked
        return _build_lm_model(cfg, vocab(cfg), device)
    kw = {}
    if cfg.model.startswith("resnet"):
        # CIFAR-style 3x3 stride-1 stem off ImageNet (reference
        # resnet.py:128-130)
        kw["stem"] = "imagenet" if cfg.data in ("imagenet", "tiny") \
            else "cifar"
    if cfg.model.startswith("vit"):
        # the positional embedding follows the patch grid (JAX :68-74)
        kw["image_size"] = input_shape(cfg.data, cfg.model)[0]
        kw["scan_blocks"] = bool(getattr(cfg, "scan_blocks", False))
    if cfg.model == "lenet5":
        # the input's channels and size, as JAX infers them at init
        h, _, c = input_shape(cfg.data, cfg.model)
        kw.update(in_channels=c, image_size=h)
    if cfg.model.startswith("maxvit"):
        # the partition must divide every stage's map (input/4 ..
        # input/32): input/32, torchvision's 7 at 224² (JAX :75-79)
        kw["partition"] = max(1, input_shape(cfg.data, cfg.model)[0] // 32)
    model = models.build(cfg.model, num_classes, device=device, **kw)
    h, w, _ = input_shape(cfg.data, cfg.model)
    variables = models.seeded_variables(model, cfg.seed)

    stem = f"{cfg.model}_{cfg.data}"
    weights_npz = os.path.join(cfg.root_dir, "weights", f"{stem}.npz")
    weights_pth = os.path.join(cfg.root_dir, "weights", f"{stem}.pth")
    bundled_npz = os.path.join(os.path.dirname(models.__file__), "assets",
                               f"{stem}.npz")
    loaded = None
    if os.path.exists(weights_npz):
        loaded = load_pytree(weights_npz)
    elif os.path.exists(weights_pth):
        loaded = models.load_torch_checkpoint(
            weights_pth, model,
            models.TORCH_KEY_MAP if cfg.model == "lenet5" else None)
    elif os.path.exists(bundled_npz):
        loaded = load_pytree(bundled_npz)
    if loaded is not None:
        # per-depth entries (a torchvision layout) into a stacked model
        loaded = models.stack_scan_groups(loaded, model)
        # a checkpoint of another input size would fail deep inside the
        # forward; name the layer here
        init_params = variables["params"]
        for layer, group in loaded.get("params", {}).items():
            for pname, arr in group.items():
                want = init_params.get(layer, {}).get(pname)
                if want is not None and tuple(want.shape) != \
                        tuple(np.shape(arr)):
                    raise ValueError(
                        f"checkpoint shape mismatch for {layer}.{pname}: "
                        f"file has {tuple(np.shape(arr))}, the model built "
                        f"for {cfg.data} ({h}x{w}) expects "
                        f"{tuple(want.shape)} — was the checkpoint trained "
                        "at a different input size?")
        variables = dict(loaded)
        variables.setdefault("batch_stats", {})
    models.load_jax_variables(model, variables)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def _build_lm_model(cfg, num_tokens: int, device):
    """Causal-LM branch of :func:`build_model` (JAX :136-183): context
    ``--seq_len``, ``--scan_blocks`` stacks. Weights: a JAX-layout npz
    (per-depth entries folded into a stack), a Hugging Face GPT-2 state
    dict saved with ``torch.save`` (``.pth``), else seeded ones; a
    checkpoint's longer position table gives its prefix."""
    t = seq_len(cfg)
    model = models.build(cfg.model, num_tokens, device=device, max_len=t,
                         scan_blocks=bool(getattr(cfg, "scan_blocks",
                                                  False)))
    stem = f"{cfg.model}_{cfg.data}"
    weights_npz = os.path.join(cfg.root_dir, "weights", f"{stem}.npz")
    weights_pth = os.path.join(cfg.root_dir, "weights", f"{stem}.pth")
    if os.path.exists(weights_npz):
        variables = models.stack_scan_groups(load_pytree(weights_npz), model)
        sd = models.state_dict_from_jax(variables)
    elif os.path.exists(weights_pth):
        sd = models.convert_gpt2_state_dict(
            torch.load(weights_pth, map_location="cpu"), model)
    else:
        sd = models.state_dict_from_jax(models.seeded_variables(model,
                                                                cfg.seed))
    own = model.state_dict()
    for key, arr in sd.items():
        want = own.get(key)
        if want is not None and tuple(want.shape) != tuple(arr.shape):
            if key == "wpe.weight" and arr.shape[1:] == want.shape[1:] \
                    and arr.shape[0] > want.shape[0]:
                sd[key] = arr[:want.shape[0]]
                continue
            raise ValueError(
                f"checkpoint shape mismatch for {key}: file has "
                f"{tuple(arr.shape)}, the model built with --seq_len {t} / "
                f"vocab {num_tokens} expects {tuple(want.shape)}")
    model.load_state_dict(sd, strict=True)
    return model


def build_data(cfg, splits="train"):
    """Dataset dispatch (reference factors.py:89-110): NHWC numpy batches.
    ``synthetic`` is 512 train / 256 test random 32x32x3 images;
    ``tokens`` the Markov token streams, one transition permutation shared
    by every split, each split drawn from its own seed (JAX :185-205);
    ``gtsrb``, ``tiny`` and ``imagenet`` the image folders under
    ``<data_dir>/gtsrb`` (32²) and ``<data_dir>/imagenet`` (64² for tiny,
    else the model's input size, 299² for Inception v3), as JAX
    :224-233."""
    root = cfg.data_dir
    if cfg.data == "tokens":
        v = vocab(cfg)
        perm = np.random.default_rng(cfg.seed).permutation(v)
        split_list = [splits] if isinstance(splits, str) else list(splits)
        out = []
        for s in split_list:
            rng = np.random.default_rng(cfg.seed + {"train": 1, "val": 2,
                                                    "test": 3}.get(s, 4))
            n = 512 if s == "train" else 256
            x, y = synthetic_tokens(rng, n, seq_len(cfg), v, perm=perm)
            out.append(D.ArrayLoader(x, y, cfg.batch_size,
                                     shuffle=(s == "train")))
        return out[0] if len(out) == 1 else out
    if cfg.data == "synthetic":
        h, w, c = input_shape("synthetic")
        rng = np.random.default_rng(cfg.seed)
        n = 512 if splits == "train" else 256
        x, y = synthetic_images(rng, n, h, w, c, NUM_CLASSES["synthetic"])
        split_list = [splits] if isinstance(splits, str) else list(splits)
        out = [D.ArrayLoader(x, y, cfg.batch_size, shuffle=(s == "train"))
               for s in split_list]
        return out[0] if len(out) == 1 else out
    if cfg.data == "mnist":
        return D.mnist(root, cfg.batch_size, cfg.workers, cfg.augment, splits)
    if cfg.data == "kmnist":
        return D.kmnist(root, cfg.batch_size, cfg.workers, cfg.augment,
                        splits)
    if cfg.data == "cifar10":
        return D.cifar10(root, cfg.batch_size, cfg.workers, cfg.augment,
                         splits)
    if cfg.data == "svhn":
        return D.svhn(root, cfg.batch_size, cfg.workers, splits)
    if cfg.data == "gtsrb":
        return D.gtsrb(os.path.join(root, "gtsrb"), 32, cfg.batch_size,
                       cfg.workers, splits)
    if cfg.data == "tiny":
        return D.imagenet(os.path.join(root, "imagenet"), 64, cfg.batch_size,
                          cfg.workers, splits, tiny=True)
    if cfg.data == "imagenet":
        h, _, _ = input_shape("imagenet", cfg.model)
        return D.imagenet(os.path.join(root, "imagenet"), h, cfg.batch_size,
                          cfg.workers, splits)
    raise ValueError(f"unknown dataset {cfg.data!r}")


def build_ood_data(cfg, batch_size=None):
    """In-domain/OOD test loader pair (reference evaluate.py:221-243): the
    synthetic OOD set is seed + 1 and ``x * 2 + 1``; a dataset's pair is
    ``loaders.OOD_PAIRS`` (MNIST's is KMNIST, CIFAR-10's SVHN, whose files
    must be under ``--data_dir``; ImageNet's and TinyImageNet's the art
    folder ``<data_dir>/imagenet/art`` at the in-domain size, JAX
    :258-260)."""
    bs = batch_size or cfg.batch_size
    in_data = build_data(cfg, splits="test")
    if cfg.data == "synthetic":
        rng = np.random.default_rng(cfg.seed + 1)
        h, w, c = input_shape("synthetic")
        x, y = synthetic_images(rng, 256, h, w, c, 10)
        return in_data, D.ArrayLoader(x * 2.0 + 1.0, y, bs)
    if cfg.data == "tokens":
        # structureless streams: uniform i.i.d. tokens (order 0)
        rng = np.random.default_rng(cfg.seed + 7)
        x, y = synthetic_tokens(rng, 256, seq_len(cfg), vocab(cfg),
                                order=0.0)
        return in_data, D.ArrayLoader(x, y, bs)
    ood_name = D.OOD_PAIRS[cfg.data]
    if ood_name == "art":
        h, _, _ = input_shape(cfg.data, cfg.model)
        return in_data, D.art(os.path.join(cfg.data_dir, "imagenet"), h, bs)
    ood_cfg = dataclasses.replace(cfg, data=ood_name)
    return in_data, build_data(ood_cfg, splits="test")


def layer_filter(cfg):
    """--layers flag -> estimator ``layer_filter`` argument: '' = all,
    'last' = last-layer Laplace, else comma-separated fnmatch patterns."""
    spec = getattr(cfg, "layers", "") or ""
    if not spec:
        return None
    if spec == "last":
        return "last"
    return [p.strip() for p in spec.split(",") if p.strip()]
