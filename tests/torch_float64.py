"""Float64 through both packages' BatchNorm, for the zoo tests whose
factors pass back through batch-statistics BatchNorm over a few values
per channel (a 2x2 or 1x1 map at B=2..4): there the normalization's
backward cancels most of its input and multiplies either package's f32
rounding far past a 1e-4 bar, on code that is right.

Both BatchNorms compute in f32 whatever their input (JAX
nn/layers.py:154, the port's nn/layers.py ``BatchNorm.forward``); inside
:func:`float64` each computes in float64 instead, patched at run time (no
file of either package changes), and JAX runs with x64 on. The caller
casts the weights, inputs and estimators to float64.
"""
import contextlib

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from curvature_tpu.nn import layers as jlayers
from curvature_tpu_torch.nn import layers as tlayers


def _jax_batchnorm(self, ctx, x):
    """JAX ``BatchNorm.__call__`` (layers.py:145-171) in float64."""
    f64 = jnp.float64
    feat = x.shape[-1]
    scale = ctx.param(self.name, "scale", (feat,),
                      lambda k, s: jnp.ones(s, f64))
    bias = ctx.param(self.name, "bias", (feat,),
                     lambda k, s: jnp.zeros(s, f64))
    mean = ctx.stat(self.name, "mean", (feat,), 0.0)
    var = ctx.stat(self.name, "var", (feat,), 1.0)
    xf = x.astype(f64)
    if ctx.train:
        axes = tuple(range(x.ndim - 1))
        batch_mean = jnp.mean(xf, axis=axes)
        batch_var = jnp.var(xf, axis=axes)
        n = x.size // feat
        unbiased = batch_var * (n / max(n - 1, 1))
        ctx.update_stat(self.name, "mean",
                        (1 - self.momentum) * mean
                        + self.momentum * batch_mean)
        ctx.update_stat(self.name, "var",
                        (1 - self.momentum) * var + self.momentum * unbiased)
        use_mean, use_var = batch_mean, batch_var
    else:
        use_mean, use_var = mean, var
    inv = jax.lax.rsqrt(use_var + self.eps)
    out = (xf - use_mean) * inv * scale.astype(f64) + bias.astype(f64)
    return out.astype(x.dtype)


def _port_batchnorm(self, x, ctx=None):
    """The port's ``BatchNorm.forward`` in float64."""
    update = ctx is None or ctx.update_stats
    keep = self.training and not update
    out = F.batch_norm(
        x.double(),
        None if keep else self.running_mean.double(),
        None if keep else self.running_var.double(),
        self.weight.double(), self.bias.double(),
        training=self.training, momentum=self.momentum, eps=self.eps)
    return out.to(x.dtype)


@contextlib.contextmanager
def float64(monkeypatch):
    """Both BatchNorms in float64, and JAX's x64 mode, while it is open."""
    monkeypatch.setattr(jlayers.BatchNorm, "__call__", _jax_batchnorm)
    monkeypatch.setattr(tlayers.BatchNorm, "forward", _port_batchnorm)
    with jax.enable_x64(True):
        yield


def to_float64(tree):
    """A nested dict of numpy arrays with its floating leaves as
    float64 (JAX-layout variables)."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: to_float64(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) \
        else a
