"""Influence functions from curvature inverse-vector products.

Port of ``curvature_tpu/eval/influence.py``. Koh & Liang (2017): the
influence of a training example ``z`` on the loss at a test point ``z'``
is

    I(z, z') = - g(z')^T  H^{-1}  g(z),

with ``H`` the damped curvature at the MAP and ``g`` per-example loss
gradients. Every estimator applies its own damped precision's inverse
exactly (``precision_solve``), so influence needs one solve for the test
gradient and one vmapped per-example gradient pass over the candidates.
``self_influence`` (I(z, z), the gradient on both sides) is the
memorization / atypicality score (Feldman & Zhang, 2020).

The losses run the model in train mode (batch-statistics BatchNorm, as
JAX's ``train=True``) under a statistics-preserving context: the running
statistics are never touched, and BatchNorm normalizes by plain tensor
ops (``nn.core.Context``'s ``decompose_norm``), which ``torch.func.vmap``
batches on the card. The gradients are taken under ``no_grad``
(``torch.func.grad`` ignores it), so they carry no graph back to the
untracked parameters.
"""
from typing import Dict, Optional

import torch
from torch.func import functional_call, grad, vmap

from curvature_tpu_torch.estimators.base import normalize_damping
from curvature_tpu_torch.nn.core import Context
from curvature_tpu_torch.ops.matfree import _forward_fn, _matrices, _mode

__all__ = ["loss_grad_matrix", "per_example_grad_matrix",
           "influence_scores", "self_influence"]


def _loss_sum(logits: torch.Tensor, y: torch.Tensor, loss: str
              ) -> torch.Tensor:
    """Summed loss over the batch (sum, not mean: influence is defined per
    example; token models sum over label positions)."""
    if loss == "gaussian":
        return 0.5 * torch.sum((logits - y.to(logits.dtype)) ** 2)
    logits = logits.reshape(-1, logits.shape[-1])
    labels = y.reshape(-1).long()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.gather(logp, -1, labels[:, None]))


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row inner products of [N, ...] with [N or 1, ...]: a product
    and a pairwise ``sum`` (a matmul's one long f32 dot over a layer's
    millions of entries rounds ~1e-4 away)."""
    return (a * b).flatten(1).sum(1)


def loss_grad_matrix(model, metas: Dict, x: torch.Tensor, y: torch.Tensor,
                     loss: str = "cross_entropy") -> Dict[str, torch.Tensor]:
    """Gradient of the summed batch loss, restricted to the tracked
    blocks, in the estimators' matrix view."""
    primals, f = _forward_fn(model, metas, x)
    y = torch.as_tensor(y, device=x.device)

    def total(p):
        return _loss_sum(f(p), y, loss)

    with _mode(model, True), torch.no_grad():
        grads = grad(total)(primals)
    return _matrices(metas, grads, metas)


def per_example_grad_matrix(model, metas: Dict, x: torch.Tensor,
                            y: torch.Tensor, loss: str = "cross_entropy"
                            ) -> Dict[str, torch.Tensor]:
    """[N, ...]-stacked per-example loss gradients in the matrix view:
    ``torch.func.vmap`` of ``torch.func.grad`` over single examples, as
    JAX vmaps them."""
    primals, _ = _forward_fn(model, metas, x)

    def one(xi, yi):
        def total(p):
            logits = functional_call(
                model, p, (xi[None], Context(decompose_norm=True)))
            return _loss_sum(logits, yi[None], loss)
        return _matrices(metas, grad(total)(primals), metas)

    with _mode(model, True), torch.no_grad():
        return vmap(one)(x, torch.as_tensor(y, device=x.device))


def influence_scores(est, x_train, y_train, x_test, y_test,
                     add: float = 1.0, multiply: float = 1.0,
                     test_grad: Optional[Dict] = None) -> torch.Tensor:
    """``[N_train]`` influences of each training example on the test loss.

    Negative scores are HELPFUL examples (their upweighting lowers the
    test loss), positive ones harmful. ``add``/``multiply`` are the
    estimator's damping knobs. Pass ``test_grad`` to reuse a test
    gradient across candidate batches."""
    if test_grad is None:
        test_grad = loss_grad_matrix(est.model, est.metas, x_test, y_test,
                                     est.loss)
    solved = est.precision_solve(test_grad, add, multiply)
    grads = per_example_grad_matrix(est.model, est.metas, x_train, y_train,
                                    est.loss)
    return -sum(_rowdot(grads[n].to(est.dtype), solved[n][None])
                for n in est.metas)


def self_influence(est, x, y, add: float = 1.0,
                   multiply: float = 1.0) -> torch.Tensor:
    """``[N]`` self-influences ``g_i^T P^{-1} g_i``: the memorization /
    atypicality score of each example under the fitted curvature (one
    invert, then ``solve_state`` vmapped over the examples)."""
    grads = per_example_grad_matrix(est.model, est.metas, x, y, est.loss)
    grads = {n: g.to(est.dtype) for n, g in grads.items()}
    a, m = normalize_damping(add, multiply, len(est.metas), est.device,
                             est.dtype)
    with torch.no_grad():
        inv = est._wrap_inv(est.invert_state(est.state, a, m))
        solved = vmap(lambda g: est.solve_state(inv, g))(grads)
    return sum(_rowdot(grads[n], solved[n]) for n in est.metas)
