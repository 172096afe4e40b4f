"""Bring-your-own-model: run the estimators on a stock ``torch.nn.Module``.

The port's counterpart of the JAX package's ``from_flax``
(``nn/flax_adapter.py``) and ``from_haiku``: the reference takes any
``torch.nn.Module`` through hooks (curvatures.py:44-46), and so does
:func:`from_torch`. Its model shares the user's modules (the same
parameter and buffer tensors, under the same state-dict names) and calls
the user's own ``forward``; during a capture forward it hooks every
tracked child to record its input and probe its output, and removes the
hooks after. The user's model is not rewritten.

Tracked: every ``nn.Linear``, and every ``nn.Conv2d`` with one group,
unit dilation and zero padding; their torch layouts (``[out, in]``,
OIHW) are already the port's matrix view. Everything else (activations,
pools, ``nn.Flatten``, ``nn.BatchNorm2d``, grouped convs) runs untracked.
A capture runs the model in train mode and leaves the running statistics
of its batch norms as they were (the forward updates copies of them), as
the port's own ``BatchNorm`` does. torch's batch norms do not sync over
ranks: a meshed capture of a model that has one in train mode raises.

Usage::

    model = from_torch(my_module, sample_input)
    kfac = estimators.KFAC(model)
"""
from typing import Dict, List

import torch
from torch import nn

from curvature_tpu_torch.nn.core import Context, LayerMeta
from curvature_tpu_torch.parallel.mesh import group_size


def _meta(name: str, m: nn.Module) -> LayerMeta:
    if isinstance(m, nn.Linear):
        return LayerMeta(name, "dense", m.out_features, m.in_features,
                         m.bias is not None)
    kh, kw = m.kernel_size
    if isinstance(m.padding, str):
        padding = m.padding.upper()
    else:
        padding = tuple((p, p) for p in m.padding)
    return LayerMeta(name, "conv", m.out_channels, m.in_channels * kh * kw,
                     m.bias is not None, kernel_size=(kh, kw),
                     strides=tuple(m.stride), padding=padding)


def _tracked(m: nn.Module) -> bool:
    if isinstance(m, nn.Linear):
        return True
    return (isinstance(m, nn.Conv2d) and m.groups == 1
            and tuple(m.dilation) == (1, 1) and m.padding_mode == "zeros")


class TorchModel(nn.Module):
    """A stock module seen by the estimators: ``metas`` names its tracked
    children by their module paths, ``forward(x, ctx=None)`` runs the
    user's forward (capturing under a context), and its parameters are
    the user's, under the user's names."""

    def __init__(self, module: nn.Module, metas: Dict[str, LayerMeta]):
        super().__init__()
        # the user's children, shared: named_parameters() yields the
        # user's tensors under the user's state-dict keys
        for name, child in module.named_children():
            self.add_module(name, child)
        for name, p in module.named_parameters(recurse=False):
            self.register_parameter(name, p)
        for name, b in module.named_buffers(recurse=False):
            self.register_buffer(name, b)
        object.__setattr__(self, "module", module)
        self._metas = metas
        self.training = module.training

    @property
    def metas(self) -> Dict[str, LayerMeta]:
        return dict(self._metas)

    def train(self, mode: bool = True):
        super().train(mode)
        self.module.train(mode)
        return self

    def _norms(self) -> List[nn.Module]:
        return [m for m in self.module.modules()
                if isinstance(m, nn.modules.batchnorm._BatchNorm)
                and m.track_running_stats and m.training]

    def forward(self, x, ctx: Context = None):
        if ctx is None:
            return self.module(x)
        norms = self._norms()
        if norms and group_size(ctx.data_group) > 1:
            raise NotImplementedError(
                "torch's batch norms do not sync over the ranks of a mesh; "
                "build the model from curvature_tpu_torch.nn (its "
                "BatchNorm syncs) to capture it under a data axis")
        # a capture's batch norms update copies of their buffers
        saved = [(m, dict(m._buffers)) for m in norms] \
            if not ctx.update_stats else []
        for m, bufs in saved:
            for k, b in bufs.items():
                if b is not None:
                    m._buffers[k] = b.clone()
        modules = dict(self.module.named_modules())
        handles = []
        for name in ctx.track & set(self._metas):
            m = modules[name]
            conv = isinstance(m, nn.Conv2d)

            def pre(mod, args, name=name, conv=conv):
                a = args[0]
                ctx.record_act(name, a.permute(0, 2, 3, 1) if conv else a)

            def post(mod, args, out, name=name):
                return ctx.probe(name, out)
            handles.append(m.register_forward_pre_hook(pre))
            handles.append(m.register_forward_hook(post))
        try:
            return self.module(x)
        finally:
            for h in handles:
                h.remove()
            for m, bufs in saved:
                m._buffers.update(bufs)


def from_torch(module: nn.Module, sample_input: torch.Tensor) -> TorchModel:
    """The estimators' model of ``module``; ``sample_input`` (one batch,
    as the module takes it) runs once, in eval mode and without gradients,
    to find which tracked children the forward reaches. The module's
    parameters, buffers and mode are left as they were."""
    was_training = module.training
    seen: List[str] = []
    handles = [m.register_forward_pre_hook(
                   lambda mod, args, name=name: seen.append(name))
               for name, m in module.named_modules() if _tracked(m)]
    module.eval()
    try:
        with torch.no_grad():
            module(sample_input)
    finally:
        for h in handles:
            h.remove()
        module.train(was_training)
    modules = dict(module.named_modules())
    metas = {name: _meta(name, modules[name])
             for name in modules if name in seen}
    if not metas:
        raise ValueError("the module's forward reaches no nn.Linear or "
                         "nn.Conv2d to track")
    return TorchModel(module, metas)
