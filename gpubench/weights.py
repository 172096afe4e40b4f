"""Seeded weights and noise, made on the device in one draw each.

A reference model lists its parameters as ``(key, shape, init)``, ``init``
``("normal", mean, std)`` or ``("lognormal", 0, std)`` (exp of N(0,
std^2)). :func:`make` draws every standard normal of the model in one
``torch.randn`` call with the run's generator and turns each slice into
its parameter in place, so the weights cost one kernel and a few hundred
small ones, and the same seed gives the same weights. The program and the
reference are handed the same dict.
"""
import math
from typing import Dict, List

import torch


def make(specs, generator: torch.Generator, device, dtype=torch.float32
         ) -> Dict[str, torch.Tensor]:
    """{key: tensor} of the specs, views into one seeded buffer."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    z = torch.randn(total, generator=generator, device=device, dtype=dtype)
    out, off = {}, 0
    for key, shape, (kind, mean, std) in specs:
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        v.mul_(std).add_(mean)
        if kind == "lognormal":
            v.exp_()
        elif kind != "normal":
            raise ValueError(f"{key}: unknown init {kind!r}")
        out[key] = v
    return out


def noise(shapes: Dict[str, tuple], members: int,
          generator: torch.Generator, device, dtype=torch.float32
          ) -> List[Dict[str, torch.Tensor]]:
    """``members`` dicts of standard normals of ``shapes``, from one
    draw."""
    per = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(members * per, generator=generator, device=device,
                    dtype=dtype)
    out, off = [], 0
    for _ in range(members):
        draw = {}
        for name, shape in shapes.items():
            n = math.prod(shape)
            draw[name] = z[off:off + n].view(shape)
            off += n
        out.append(draw)
    return out
