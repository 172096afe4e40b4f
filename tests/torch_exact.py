"""Small model pairs for the exact-curvature tests (ops/matfree.py,
eval/fidelity.py, estimators/subspace.py, eval/influence.py): ``pair``
returns the port's model, the JAX model, the JAX-layout numpy variables
both were loaded from (``models.seeded_variables`` of the port's model),
and a numpy input batch in JAX's layout with the port's NCHW view.

  * ``mlp``: JAX ``mlp([7], 4)`` on [16, 5] inputs;
  * ``bn``: conv -> BatchNorm -> ReLU -> conv s2 -> BatchNorm -> ReLU ->
    fc (train-mode BatchNorm under the exact products);
  * ``grouped``: conv -> grouped conv -> depthwise conv -> fc (the
    group-major matrix views);
  * ``stacked``: a depth-scanned ViT (dim 32, 4 heads, depth 2, 16² with
    8² patches): ``[depth, ...]`` matrix views and the attention
    projections' ``/in_proj`` names.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import models as jmodels
from curvature_tpu import nn as jnn
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn


class _JBNNet(jnn.Module):
    def __init__(self, classes=5):
        self.c1 = jnn.Conv(8, 3, padding=1, use_bias=False, name="c1")
        self.b1 = jnn.BatchNorm(name="b1")
        self.c2 = jnn.Conv(8, 3, strides=2, padding=1, use_bias=False,
                           name="c2")
        self.b2 = jnn.BatchNorm(name="b2")
        self.fc = jnn.Dense(classes, name="fc")

    def __call__(self, ctx, x):
        x = jnn.ReLU()(ctx, self.b1(ctx, self.c1(ctx, x)))
        x = jnn.ReLU()(ctx, self.b2(ctx, self.c2(ctx, x)))
        return self.fc(ctx, jnn.Flatten()(ctx, x))


def _named(module, name):
    module.name = name
    return module


def _t_bn_net(classes=5):
    return tnn.Sequential([
        tnn.Conv(3, 8, 3, padding=1, bias=False, name="c1"),
        _named(tnn.BatchNorm(8), "b1"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, 2, padding=1, bias=False, name="c2"),
        _named(tnn.BatchNorm(8), "b2"), tnn.ReLU(),
        tnn.Flatten(), tnn.Dense(72, classes, name="fc")])


class _JGroupedNet(jnn.Module):
    def __init__(self):
        self.c1 = jnn.Conv(8, 3, padding=1, name="c1")
        self.c2 = jnn.Conv(8, 3, padding=1, groups=4, name="c2")
        self.dw = jnn.Conv(8, 3, strides=2, padding=1, groups=8, name="dw")
        self.fc = jnn.Dense(5, name="fc")

    def __call__(self, ctx, x):
        x = jnn.ReLU()(ctx, self.c1(ctx, x))
        x = jnn.ReLU()(ctx, self.c2(ctx, x))
        x = jnn.ReLU()(ctx, self.dw(ctx, x))
        x = jnn.Flatten()(ctx, x)
        return self.fc(ctx, x)


def _t_grouped_net():
    return tnn.Sequential([
        tnn.Conv(3, 8, 3, padding=1, name="c1"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, padding=1, groups=4, name="c2"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, 2, padding=1, groups=8, name="dw"), tnn.ReLU(),
        tnn.Flatten(), tnn.Dense(72, 5, name="fc")])


#: arch -> (JAX-layout input shape, classes)
SHAPES = {"mlp": ((16, 5), 4), "bn": ((4, 6, 6, 3), 5),
          "grouped": ((4, 6, 6, 3), 5), "stacked": ((2, 16, 16, 3), 6)}
ARCHS = tuple(SHAPES)


def pair(arch: str, seed: int = 0):
    """(port model, JAX model, JAX-layout numpy variables, numpy input
    [JAX layout], port input tensor [NCHW for images])."""
    shape, classes = SHAPES[arch]
    if arch == "mlp":
        tm = tmodels.mlp([7], classes, in_features=shape[1], device="cpu")
        jm = jmodels.mlp([7], classes)
    elif arch == "bn":
        tm, jm = _t_bn_net(classes), jnn.Model(_JBNNet(classes))
    elif arch == "grouped":
        tm, jm = _t_grouped_net(), jnn.Model(_JGroupedNet())
    else:
        tm = tmodels.vit(16, 8, 32, 2, 4, 64, classes, scan_blocks=True,
                         device="cpu")
        jm = jmodels.vit(16, 8, 32, 2, 4, 64, classes, scan_blocks=True)
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return tm, jm, variables, x, to_port_input(x)


def to_port_input(x: np.ndarray) -> torch.Tensor:
    """A JAX-layout numpy batch as the port's model takes it."""
    if x.ndim == 4:
        x = x.transpose(0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(x))


def jv(variables):
    """JAX-layout numpy variables as jnp arrays, with ``batch_stats``."""
    out = jax.tree_util.tree_map(jnp.asarray, dict(variables))
    out.setdefault("batch_stats", {})
    return out


def np_(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def close(got, want, rel, what=""):
    """Within ``rel`` of max|want|."""
    got, want = np_(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               rtol=0, err_msg=what)


def to_jax(tree):
    """A dict of tensors (nested) as jnp arrays."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(np_(tree))


def to_torch(tree, dtype=torch.float32):
    """A dict of arrays (nested) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=dtype)


def running_stats(model):
    """Copies of every BatchNorm running buffer."""
    return {k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}
