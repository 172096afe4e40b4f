"""Depth-stacked block stacks.

Port of ``curvature_tpu/nn/scan.py``. :class:`ScanBlocks` builds ``depth``
structurally identical blocks from one template and keeps each parameter
once, stacked ``[depth, ...]``, under the template's names
(``h.attn.c_attn.weight`` of shape ``[depth, out, in]``): the layout of the
JAX stack's parameters and of its factor state. Its forward is a Python
loop over depth that runs the template on slice ``i`` of every parameter
with ``torch.func.functional_call``. JAX scans with ``lax.scan`` to
compile one block instead of ``depth``; PyTorch runs eagerly, so the loop
is the idiom.

The tracked layers inside are one stacked layer each (a ``Dense`` with a
``[depth, out, in]`` weight has ``LayerMeta.stacked = depth``): the capture context records their inputs
per depth and returns them stacked, and their probe is one ``[depth,
...preact]`` tensor (nn/core.py), so every estimator sees the JAX shapes.
``scan_groups`` records, per stack, its depth, ``per_depth_names`` (the
unrolled names, ``h.{i}``, that checkpoint converters gather from) and its
parameter layers, as the JAX model records them.
"""
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.func import functional_call

from curvature_tpu_torch.nn.core import Context


def _owner(module: nn.Module, path: str):
    """(the submodule holding a dotted parameter path, the leaf name)."""
    *mods, leaf = path.split(".")
    for m in mods:
        module = getattr(module, m)
    return module, leaf


class ScanBlocks(nn.Module):
    """``depth`` blocks of one template with stacked parameters.

    ``make_block(prefix)`` builds a block whose tracked layers are named
    under ``prefix``; it is called ``depth`` times, and each parameter of
    the stack is the ``[depth, ...]`` stack of the blocks' own
    initializations (JAX draws each depth's parameters apart too). The
    template's child modules are registered directly on the stack, so the
    state-dict keys are ``f"{name}.{param}"``. Buffers are not supported
    (the JAX stacks of this port's models hold none).
    """

    def __init__(self, make_block: Callable[[str], nn.Module], depth: int,
                 name: str, per_depth_names: Optional[List[str]] = None):
        super().__init__()
        if depth < 1:
            raise ValueError("ScanBlocks needs depth >= 1")
        self.name = name
        self.depth = depth
        self.per_depth_names = per_depth_names
        blocks = [make_block(name) for _ in range(depth)]
        template = blocks[0]
        if next(template.buffers(), None) is not None:
            raise ValueError("ScanBlocks templates with buffers are not "
                             "supported")
        # the template is run, not registered: its children are ours
        object.__setattr__(self, "block", template)
        for cname, child in template.named_children():
            self.add_module(cname, child)
        self.param_names = [n for n, _ in template.named_parameters()]
        per = [dict(b.named_parameters()) for b in blocks]
        for pname in self.param_names:
            stacked = torch.stack([p[pname].detach() for p in per])
            setattr(*_owner(template, pname), nn.Parameter(stacked))

    @property
    def scan_group(self) -> Dict:
        """The JAX ``scan_groups`` entry of this stack: its parameter
        layers by JAX name (a tracked layer's ``name``, so an attention
        projection's ``<attn>/in_proj``)."""
        layers = set()
        for n in self.param_names:
            owner, _ = _owner(self.block, n)
            layers.add(getattr(owner, "name", None)
                       or f"{self.name}." + n.rsplit(".", 1)[0])
        return {"depth": self.depth,
                "per_depth_names": self.per_depth_names,
                "param_layers": sorted(layers),
                "stat_layers": []}

    def forward(self, x, ctx: Optional[Context] = None):
        # the registered parameters, or the tensors an outer
        # functional_call put in their place
        stacked = {n: getattr(*_owner(self, n)) for n in self.param_names}
        if ctx is not None and ctx.scan is not None:
            raise ValueError("nested ScanBlocks are not supported")
        try:
            for i in range(self.depth):
                if ctx is not None:
                    ctx.scan = (i, self.depth)
                x = functional_call(self.block,
                                    {n: t[i] for n, t in stacked.items()},
                                    (x, ctx))
        finally:
            if ctx is not None:
                ctx.scan = None
        if ctx is not None:
            ctx.stack_acts()
        return x
