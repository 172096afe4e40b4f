"""KFAC-preconditioned training (natural-gradient descent).

Port of ``curvature_tpu/optim.py``: the Kronecker factors that build the
Laplace posterior double as a second-order preconditioner (Martens &
Grosse, 2015). Per tracked layer the gradient matrix ``[out, cols]`` is
preconditioned with the inverted damped factors the sampler computes,

    precond(G) = (G_d)^-1  Gmat  (A_d)^-1
               = g_chol g_chol^T  Gmat  a_chol a_chol^T,

and the result goes to a ``torch.optim`` optimizer as the parameters'
gradients (momentum and weight decay apply to the preconditioned
gradients, as JAX's optax chain does). Untracked parameters (BatchNorm's,
biases of untracked layers) keep their plain gradients. The factors are an
EMA of each step's fresh factors and are re-inverted every
``invert_every`` steps: a Python branch where JAX has ``lax.cond``. The
fresh factors come from ``KFAC.update_state``, so on CUDA every step's
conv A factors take the patch-Gram kernels where JAX's dispatch picks
them. With a ``mesh`` the step is the single-process step on the global
batch: each rank runs its rows of the data axis, BatchNorm normalizes
over the whole batch, the gradients are summed over the data ranks and
the fresh factors come from the meshed capture (``Estimator.use_mesh``).
"""
from typing import Dict

import torch
import torch.nn.functional as F

from curvature_tpu_torch.estimators.base import normalize_damping
from curvature_tpu_torch.estimators.capture import (
    collect, softmax_cross_entropy)
from curvature_tpu_torch.nn.core import (
    Context, matrix_to_delta, param_key, param_matrix)
from curvature_tpu_torch.parallel.mesh import all_reduce, all_reduce_tree


def loss_backward(model, x, y, mesh=None) -> torch.Tensor:
    """The mean cross-entropy of the batch, its gradient accumulated into
    the parameters' ``.grad``; returns the loss, detached. Under ``mesh``
    (a batch that divides its data axis) each rank runs its rows with
    BatchNorm synced over the data ranks, its rows' loss divided by the
    global batch, and the gradients and the loss are summed over the data
    ranks: every rank holds the global batch's loss and gradient."""
    rows = None if mesh is None else mesh.rows(x.shape[0])
    if rows is None:
        loss = softmax_cross_entropy(model(x), y)
        loss.backward()
        return loss.detach()
    group = mesh.group("data")
    logits = model(x[rows], Context(update_stats=True, data_group=group))
    loss = F.cross_entropy(logits, y[rows], reduction="sum") / x.shape[0]
    loss.backward()
    all_reduce_tree([p.grad for p in model.parameters()
                     if p.grad is not None], group)
    return all_reduce(loss.detach(), group)


def precondition(metas: Dict, inv_state: Dict,
                 grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Apply the inverse damped Kronecker factors to ``grads`` (state-dict
    keys -> gradients). Tracked layers get ``G_d^-1 Gmat A_d^-1`` (a
    grouped conv per group block, a stacked layer per depth); every other
    entry passes through unchanged. Factors with extra block axes (JAX's
    split attention factors, a blocked G) are a posterior-only layout and
    raise ``ValueError``."""
    new = dict(grads)
    for name, meta in metas.items():
        if name not in inv_state:
            continue
        inv = inv_state[name]
        a_chol, g_chol = inv["a_chol"], inv["g_chol"]
        grouped = meta.kind == "conv" and meta.groups > 1
        base = 2 + (1 if meta.stacked else 0) + (1 if grouped else 0)
        if "a_bias_chol" in inv or a_chol.ndim != base \
                or g_chol.ndim != base:
            raise ValueError(f"{name}: split attention factors (qkv/head) "
                             "are posterior-only; build the optimizer KFAC "
                             "without attention_qkv_split/head_split")
        weight = grads[param_key(name, "weight")]
        gmat = param_matrix(meta, weight, grads.get(param_key(name, "bias")))
        if grouped:
            blocks = gmat.reshape(meta.groups, meta.out_features
                                  // meta.groups, -1)
            pmat = (g_chol @ (g_chol.mT @ blocks) @ a_chol @ a_chol.mT
                    ).reshape(meta.out_features, -1)
        else:
            # batched over an optional leading depth axis (ScanBlocks)
            pmat = g_chol @ (g_chol.mT @ gmat) @ a_chol @ a_chol.mT
        for key, val in matrix_to_delta(meta, pmat).items():
            full = param_key(name, key)
            new[full] = val.reshape(grads[full].shape).to(grads[full].dtype)
    return new


def make_kfac_train_step(model, est, optimizer, ema: float = 0.95,
                         damping: float = 1e-2, fisher_scale: float = 1.0,
                         invert_every: int = 10, mc_fisher: bool = True,
                         mesh=None):
    """One natural-gradient step.

    ``est`` is a ``KFAC`` over the layers to precondition (its
    ``layer_filter`` restricts preconditioning to a subnetwork);
    ``optimizer`` a ``torch.optim`` optimizer over the model's
    parameters. ``mc_fisher=True`` draws one label per example from the
    model's distribution with the step's ``generator`` (the true Fisher);
    ``False`` takes the training labels (the empirical Fisher). Returns
    ``step(factors, inv, count, x, y, generator)`` -> (factors, inv,
    count + 1, loss), which updates the model's parameters, its BatchNorm
    running statistics and the optimizer's state in place, and
    ``init(x0, y0, generator)`` -> (factors, inv) from one batch.
    ``mesh`` splits each step over its data axis (the module docstring);
    the fresh factors' labels are then drawn per rank."""
    metas = est.metas
    if mesh is not None:
        est.use_mesh(mesh)

    def batch_factors(x, y, generator):
        if mesh is not None:
            return est.batch_state(est.capture(
                x, None if mc_fisher else y[None], generator, 1))
        # train-mode BatchNorm on batch statistics; the capture leaves the
        # running statistics alone, as JAX discards the capture's stats
        if mc_fisher:
            cap = collect(model, metas, x, generator=generator,
                          num_samples=1, need_param_grads=False,
                          need_probe_grads=True, loss=est.loss)
        else:
            cap = collect(model, metas, x, labels=y[None],
                          need_param_grads=False, need_probe_grads=True,
                          loss=est.loss)
        return est.update_state(est.init_state(), cap)

    def invert(factors):
        add, mult = normalize_damping(damping, fisher_scale, len(metas),
                                      est.device, est.dtype)
        return est.invert_state(factors, add, mult)

    def step(factors, inv, count, x, y, generator=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = loss_backward(model, x, y, mesh)
        fresh = batch_factors(x, y, generator)
        with torch.no_grad():
            factors = {n: {k: ema * v + (1.0 - ema) * fresh[n][k]
                           for k, v in f.items()}
                       for n, f in factors.items()}
            if count % invert_every == 0:
                inv = invert(factors)
            params = dict(model.named_parameters())
            grads = precondition(metas, inv, {k: p.grad for k, p in
                                              params.items()
                                              if p.grad is not None})
            for k, g in grads.items():
                params[k].grad = g
        optimizer.step()
        return factors, inv, count + 1, loss

    def init(x0, y0, generator=None):
        """Initial (factors, inv) from one real batch."""
        factors = batch_factors(x0, y0, generator)
        with torch.no_grad():
            return factors, invert(factors)

    return step, init
