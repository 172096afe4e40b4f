"""The work of a step, counted from the cell's layer shapes and never from
which kernel ran, so the count reads the same whatever implements it.

The shapes come from the reference model run on the ``meta`` device (no
memory, no arithmetic) with the traffic's batch:

- the forward: 2 FLOPs per multiply-add of every conv and dense layer and
  of the matmuls that are no layer (attention's QK^T and AV);
- the capture's backward: input gradients only (KFAC takes no weight
  gradient), of every layer after the first (the first layer's input
  needs none) and twice the attention matmuls' (dQ, dK; dP, dV);
- the factors: each A and G factor of each tracked layer a Gram of its
  tokens, :func:`~gpubench.peaks.gram_flops`, with
  :func:`~gpubench.peaks.gram_bytes` (a conv's A reads its input once);
- the eval: ``samples`` forwards a unit.
"""
import math
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from gpubench import peaks
from gpubench.reference.kfac import select
from gpubench.reference.layers import Recorder


@dataclass
class Work:
    """Counts of one batch: ``units`` (images or tokens), multiply-adds of
    the forward and of the capture's backward, and each factor Gram as
    ``(layer, "a" | "g", tokens, side, bytes)``."""
    units: int
    forward_macs: int
    backward_macs: int
    grams: List[Tuple[str, str, int, int, int]] = field(default_factory=list)

    @property
    def gram_flops(self) -> int:
        return sum(peaks.gram_flops(n, side) for _, _, n, side, _
                   in self.grams)

    @property
    def gram_bytes(self) -> int:
        return sum(b for *_, b in self.grams)

    @property
    def state_floats(self) -> int:
        """Floats of the factor state (one Gram per factor and depth)."""
        return sum(side * side for _, _, _, side, _ in self.grams)

    def fit_flops(self) -> int:
        """FLOPs of one update: forward, backward and factor Grams."""
        return 2 * (self.forward_macs + self.backward_macs) + self.gram_flops

    def eval_flops(self, samples: int) -> int:
        """FLOPs of one batch through a ``samples``-member ensemble."""
        return 2 * samples * self.forward_macs

    def factor_seconds(self) -> float:
        """The least time of the batch's factor Grams on the card."""
        return peaks.least_seconds(self.gram_flops, self.gram_bytes)


def count(model, cfg, traffic, layer_filter=None) -> Work:
    """The :class:`Work` of one batch of ``traffic`` through the reference
    ``model`` at ``cfg``, the factors of the layers ``layer_filter``
    keeps."""
    with torch.device("meta"):
        params = {k: torch.empty(shape) for k, shape, _ in
                  model.param_specs(cfg)}
        x, _ = model.make_inputs(cfg, traffic, None, "meta")
        rec = Recorder()
        model.forward(params, x, cfg, train=True, rec=rec)
    layers = model.layers(cfg)
    macs = [sum(y.numel() * layers[n].fan_in for y in rec.outputs[n])
            for n in rec.outputs]
    work = Work(units=model.units(x),
                forward_macs=sum(macs) + rec.extra_macs,
                backward_macs=sum(macs[1:]) + 2 * rec.extra_macs)
    for name, layer in select(layers, layer_filter).items():
        for act, y in zip(rec.inputs[name], rec.outputs[name]):
            n = y.numel() // layer.out
            work.grams.append((name, "a", n, layer.cols,
                               peaks.gram_bytes(act.numel(), layer.cols)))
            work.grams.append((name, "g", n, layer.out,
                               peaks.gram_bytes(y.numel(), layer.out)))
    return work


def parameters(model, cfg) -> int:
    """Parameters of the model (buffers such as running statistics
    left out)."""
    return sum(math.prod(shape) for key, shape, _ in model.param_specs(cfg)
               if not key.endswith(("running_mean", "running_var")))
