"""ResNet as torchvision publishes it (He et al., 2016; v1.5: the stride
on the Bottleneck's 3x3 conv), as a function of a parameter dict under
torchvision's state-dict keys.

A configuration gives ``block`` (``"bottleneck"`` or ``"basic"``),
``layers`` (blocks per stage), ``stem`` (``"imagenet"``: 7x7 stride-2 conv
and a 3x3 stride-2 max pool; ``"cifar"``: a 3x3 stride-1 conv and the same
pool), ``num_classes``, ``in_channels`` and ``image_size``. Every conv and
the ``fc`` is a tracked layer. Train mode normalizes with the batch's
statistics and leaves the running ones as they are; eval mode uses the
running ones.
"""
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.layers import Layer, Recorder, conv, dense

PLANES = (64, 128, 256, 512)
BN_EPS = 1e-5


def _expansion(cfg) -> int:
    return 4 if cfg["block"] == "bottleneck" else 1


def _blocks(cfg) -> Iterator[Tuple[str, int, int, int, bool]]:
    """(prefix, inplanes, planes, stride, has downsample) per block."""
    inplanes, exp = 64, _expansion(cfg)
    for stage, (planes, n) in enumerate(zip(PLANES, cfg["layers"])):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            down = i == 0 and (stride != 1 or inplanes != planes * exp)
            yield f"layer{stage + 1}.{i}", inplanes, planes, stride, down
            inplanes = planes * exp


def _block_convs(cfg, prefix, inplanes, planes, stride, down
                 ) -> List[Tuple[str, Layer]]:
    """(batch-norm prefix, conv) pairs of one block in forward order; the
    downsample pair last."""
    if cfg["block"] == "bottleneck":
        convs = [(f"{prefix}.bn1", _conv(f"{prefix}.conv1", inplanes,
                                         planes, 1, 1, 0)),
                 (f"{prefix}.bn2", _conv(f"{prefix}.conv2", planes, planes,
                                         3, stride, 1)),
                 (f"{prefix}.bn3", _conv(f"{prefix}.conv3", planes,
                                         planes * 4, 1, 1, 0))]
    else:
        convs = [(f"{prefix}.bn1", _conv(f"{prefix}.conv1", inplanes,
                                         planes, 3, stride, 1)),
                 (f"{prefix}.bn2", _conv(f"{prefix}.conv2", planes, planes,
                                         3, 1, 1))]
    if down:
        convs.append((f"{prefix}.downsample.1", _conv(
            f"{prefix}.downsample.0", inplanes, planes * _expansion(cfg), 1,
            stride, 0)))
    return convs


def _conv(name, cin, cout, k, stride, pad) -> Layer:
    return Layer(name, "conv", cout, cin * k * k, False, (k, k),
                 (stride, stride), (pad, pad))


def _stem(cfg) -> Layer:
    if cfg["stem"] == "cifar":
        return _conv("conv1", cfg["in_channels"], 64, 3, 1, 1)
    return _conv("conv1", cfg["in_channels"], 64, 7, 2, 3)


def layers(cfg) -> Dict[str, Layer]:
    """Every conv and the ``fc``, in forward order."""
    out = {"conv1": _stem(cfg)}
    for blk in _blocks(cfg):
        out.update((c.name, c) for _, c in _block_convs(cfg, *blk))
    out["fc"] = Layer("fc", "dense", cfg["num_classes"],
                      512 * _expansion(cfg), True)
    return out


def param_specs(cfg) -> List[Tuple[str, tuple, tuple]]:
    """(state-dict key, shape, init) of every parameter and buffer.

    Convs He-normal, the fc N(0, 1/fan_in) with an N(0, 0.01^2) bias;
    batch-norm scales gain * (1 + 0.1 z) (the gain ``residual_gain`` on the
    last norm of each residual branch, 1 elsewhere, so that eval-mode
    activations do not grow block by block), biases and running means
    N(0, 0.05^2), running variances exp(0.1 z)."""
    gain = float(cfg.get("residual_gain", 1.0))
    last = "bn3" if cfg["block"] == "bottleneck" else "bn2"
    specs = []

    def norm(prefix, c, g=1.0):
        specs.extend([(f"{prefix}.weight", (c,), ("normal", g, 0.1 * g)),
                      (f"{prefix}.bias", (c,), ("normal", 0.0, 0.05)),
                      (f"{prefix}.running_mean", (c,), ("normal", 0.0, 0.05)),
                      (f"{prefix}.running_var", (c,),
                       ("lognormal", 0.0, 0.1))])

    def conv_w(layer: Layer):
        kh, kw = layer.kernel
        specs.append((f"{layer.name}.weight",
                      (layer.out, layer.fan_in // (kh * kw), kh, kw),
                      ("normal", 0.0, (2.0 / layer.fan_in) ** 0.5)))

    conv_w(_stem(cfg))
    norm("bn1", 64)
    for blk in _blocks(cfg):
        for bn, c in _block_convs(cfg, *blk):
            conv_w(c)
            norm(bn, c.out, gain if bn.endswith(last) else 1.0)
    fc = layers(cfg)["fc"]
    specs.append(("fc.weight", (fc.out, fc.fan_in),
                  ("normal", 0.0, (1.0 / fc.fan_in) ** 0.5)))
    specs.append(("fc.bias", (fc.out,), ("normal", 0.0, 0.01)))
    return specs


def _bn(p, prefix, x, train):
    if train:
        return F.batch_norm(x, None, None, p[f"{prefix}.weight"],
                            p[f"{prefix}.bias"], training=True, eps=BN_EPS)
    return F.batch_norm(x, p[f"{prefix}.running_mean"],
                        p[f"{prefix}.running_var"], p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], training=False, eps=BN_EPS)


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            train: bool, rec: Recorder = None) -> torch.Tensor:
    """Logits [B, classes] of NCHW images ``x``."""
    stem = _stem(cfg)
    x = F.relu(_bn(p, "bn1", conv(rec, stem, x, p["conv1.weight"]), train))
    x = F.max_pool2d(x, 3, 2, 1)
    for blk in _blocks(cfg):
        convs = _block_convs(cfg, *blk)
        main = convs[:3] if cfg["block"] == "bottleneck" else convs[:2]
        out = x
        for i, (bn, c) in enumerate(main):
            out = _bn(p, bn, conv(rec, c, out, p[f"{c.name}.weight"]), train)
            if i < len(main) - 1:
                out = F.relu(out)
        identity = x
        if blk[4]:
            bn, c = convs[-1]
            identity = _bn(p, bn, conv(rec, c, x, p[f"{c.name}.weight"]),
                           train)
        x = F.relu(out + identity)
    x = x.mean(dim=(2, 3))
    return dense(rec, "fc", x, p["fc.weight"], p["fc.bias"])


def make_inputs(cfg, traffic, generator, device) -> tuple:
    """A batch of ``traffic["batch"]`` N(0, 1) images [B, C, H, W] of the
    configuration's dtype and uniform class labels [B], drawn with
    ``generator``."""
    s, batch = cfg["image_size"], traffic["batch"]
    x = torch.randn((batch, cfg["in_channels"], s, s), generator=generator,
                    device=device, dtype=getattr(torch, cfg["dtype"]))
    y = torch.randint(0, cfg["num_classes"], (batch,), generator=generator,
                      device=device)
    return x, y


def units(x: torch.Tensor) -> int:
    """Images in a batch."""
    return x.shape[0]


def loss_count(x: torch.Tensor) -> int:
    """The positions the mean loss averages over: the images."""
    return x.shape[0]
