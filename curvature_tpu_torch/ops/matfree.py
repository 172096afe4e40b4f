"""Matrix-free exact curvature operators (GGN = model-distribution Fisher).

Port of ``curvature_tpu/ops/matfree.py``. For softmax cross-entropy the
generalized Gauss-Newton matrix equals the model-distribution Fisher the
estimators approximate from Monte-Carlo label draws:

    F = (1/B) sum_i J_i^T H_i J_i,   H_i = diag(p_i) - p_i p_i^T

(H = I for the unit-variance Gaussian regression loss; every other loss
takes the softmax branch, as in JAX). One forward-mode ``torch.func.jvp``
of ``functional_call`` gives the quadratic form v^T F v; the matrix-vector
product adds the ``torch.func.vjp`` of the same forward at the same point
(JAX shares one ``jax.linearize`` between J and its transpose; here the
jvp recomputes the primal, which the vjp keeps as its residuals). No
[p, p] matrix is ever formed.

Products restrict to the tracked layers' parameters, with tangents in the
estimators' matrix view (``[(depth,) out, fan_in(+1)]`` per layer, the
bias column last: ``nn.core.param_matrix``). The forward runs the model
in train mode (batch-statistics BatchNorm) under a
:class:`~curvature_tpu_torch.nn.Context` with ``update_stats=False`` and
``decompose_norm``: the running statistics are never touched, as JAX
discards the new ``batch_stats`` (:63-71), and BatchNorm normalizes by
plain tensor ops, which ``torch.func.vmap`` batches on the card. Random
draws take a ``torch.Generator`` or are injected (``jax.random`` and
torch streams never agree).
"""
import contextlib
import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.func import functional_call, jvp, vjp

from curvature_tpu_torch.nn.core import (
    Context, LayerMeta, matrix_to_delta, param_key, param_matrix)

__all__ = [
    "delta_shapes", "random_deltas", "ggn_quad", "ggn_matvec",
    "lanczos_topk", "hutchinson_trace",
]


def delta_shapes(metas: Dict[str, LayerMeta]) -> Dict[str, Tuple[int, ...]]:
    """Matrix-view delta shape per tracked layer (stacked axis included)."""
    return {
        name: ((m.stacked,) if m.stacked else ())
        + (m.out_features, m.mat_cols)
        for name, m in metas.items()
    }


def random_deltas(metas: Dict[str, LayerMeta],
                  generator: Optional[torch.Generator] = None,
                  kind: str = "rademacher", dtype=torch.float32,
                  device=None) -> Dict[str, torch.Tensor]:
    """A random probe dict in the estimators' matrix view: Rademacher
    signs or standard normals, drawn layer by layer from ``generator``."""
    if device is None and generator is not None:
        device = generator.device
    out = {}
    for name, shape in delta_shapes(metas).items():
        if kind == "rademacher":
            bits = torch.randint(0, 2, shape, generator=generator,
                                 device=device)
            out[name] = (2 * bits - 1).to(dtype)
        else:
            out[name] = torch.randn(shape, generator=generator, dtype=dtype,
                                    device=device)
    return out


@contextlib.contextmanager
def _mode(model, train: bool):
    """The model in train (or eval) mode for the block, its mode restored
    after."""
    was_training = model.training
    model.train(train)
    try:
        yield model
    finally:
        model.train(was_training)


def _leaf_keys(metas: Dict[str, LayerMeta], names: Iterable[str]
               ) -> List[str]:
    return [param_key(n, leaf) for n in names
            for leaf in (("weight", "bias") if metas[n].has_bias
                         else ("weight",))]


def _forward_fn(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
                names: Optional[Iterable[str]] = None,
                params: Optional[Dict[str, torch.Tensor]] = None):
    """(primals, f): the tracked layers' leaves of ``names`` (default:
    every tracked layer) as a ``{state-dict key: tensor}`` dict, and
    ``f(primals)`` the model's output on ``x`` with them in place.
    ``params`` (state-dict keys, e.g. a compute-dtype cast) replace the
    model's own parameters; the rest come from the module. Each call
    runs under a fresh statistics-preserving context whose BatchNorm is
    decomposed (``nn.core.Context``)."""
    own = dict(model.named_parameters()) if params is None else params
    keys = _leaf_keys(metas, metas if names is None else names)
    primals = {k: own[k].detach() for k in keys}
    base = {} if params is None else dict(params)

    def f(p):
        return functional_call(model, {**base, **p},
                               (x, Context(decompose_norm=True)))

    return primals, f


def _tangent(metas: Dict[str, LayerMeta], primals: Dict[str, torch.Tensor],
             deltas: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The primals' tangent: each layer's matrix-view delta as its weight
    and bias leaves (zeros for a leaf without one), in the primal's
    dtype."""
    out = {}
    for name, mat in deltas.items():
        for leaf, val in matrix_to_delta(metas[name], mat).items():
            key = param_key(name, leaf)
            if key in primals:
                out[key] = val.reshape(primals[key].shape).to(
                    primals[key].dtype)
    return {k: out[k] if k in out else torch.zeros_like(v)
            for k, v in primals.items()}


def _h_quad(loss: str, logits: torch.Tensor, u: torch.Tensor
            ) -> torch.Tensor:
    """sum_i u_i^T H_i u_i for the loss's output-space Hessian H."""
    if loss == "gaussian":
        return torch.sum(u * u)
    p = torch.softmax(logits, dim=-1)
    return torch.sum(p * u * u) - torch.sum(torch.sum(p * u, dim=-1) ** 2)


def _h_apply(loss: str, logits: torch.Tensor, u: torch.Tensor
             ) -> torch.Tensor:
    """H_i u_i per sample."""
    if loss == "gaussian":
        return u
    p = torch.softmax(logits, dim=-1)
    return p * u - p * torch.sum(p * u, dim=-1, keepdim=True)


def _matrices(metas: Dict[str, LayerMeta], grads: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """Per-leaf gradients -> the matrix view of each layer in ``names``."""
    return {n: param_matrix(metas[n], grads[param_key(n, "weight")],
                            grads.get(param_key(n, "bias")))
            for n in names}


def ggn_quad(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
             deltas: Dict[str, torch.Tensor], loss: str = "cross_entropy",
             train: bool = True,
             params: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
    """v^T F v with F the batch-mean GGN/Fisher: ONE forward jvp, no
    backward pass, v^T J^T H J v = (Jv)^T H (Jv). ``deltas`` may name a
    subset of the tracked layers (the others' directions are zero)."""
    primals, f = _forward_fn(model, metas, x, names=list(deltas),
                             params=params)
    with _mode(model, train), torch.no_grad():
        logits, u = jvp(f, (primals,), (_tangent(metas, primals, deltas),))
    return _h_quad(loss, logits, u) / x.shape[0]


def ggn_matvec(model, metas: Dict[str, LayerMeta], x: torch.Tensor,
               deltas: Dict[str, torch.Tensor], loss: str = "cross_entropy",
               train: bool = True,
               params: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """F v restricted to the tracked blocks, in the matrix view: J v by
    ``torch.func.jvp``, then J^T (H J v) / B by the ``torch.func.vjp`` of
    the same forward at the same point (JAX's ``jax.linearize`` +
    ``jax.linear_transpose``, :122-127)."""
    primals, f = _forward_fn(model, metas, x, params=params)
    with _mode(model, train), torch.no_grad():
        logits, pullback = vjp(f, primals)
        _, u = jvp(f, (primals,), (_tangent(metas, primals, deltas),))
        hu = _h_apply(loss, logits, u) / x.shape[0]
        (grads,) = pullback(hu)
    return _matrices(metas, grads, metas)


def _flatten(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in tree.values()])


def _unflatten(flat: torch.Tensor, example: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for name, v in example.items():
        out[name] = flat[i:i + v.numel()].reshape(v.shape)
        i += v.numel()
    return out


def lanczos_topk(matvec: Callable[[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]],
                 example: Dict[str, torch.Tensor], k: int,
                 generator: Optional[torch.Generator] = None,
                 q0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top Ritz values of a symmetric PSD operator by k Lanczos steps.

    Full reorthogonalization against the ``[k, p]`` Krylov basis (k p
    floats of device memory). The start vector is ``q0`` (flat ``[p]`` or
    a dict like ``example``; normalized here), else a standard normal from
    ``generator``. Returns (Ritz values, descending ``[k]``;
    first-component weights ``[k]``): the weights are the
    spectral-density moments nu_j = (q_0^T y_j)^2 of Lanczos
    quadrature."""
    v0 = _flatten(example)
    p = v0.shape[0]
    if q0 is None:
        q = torch.randn(p, generator=generator, dtype=v0.dtype,
                        device=v0.device)
    else:
        q = (_flatten(q0) if isinstance(q0, dict)
             else torch.as_tensor(q0)).to(v0.dtype).to(v0.device).reshape(-1)
    q = q / torch.linalg.vector_norm(q)
    basis = torch.zeros((k, p), dtype=v0.dtype, device=v0.device)
    alphas = torch.zeros(k, dtype=v0.dtype, device=v0.device)
    betas = torch.zeros(k, dtype=v0.dtype, device=v0.device)
    for j in range(k):
        basis[j] = q
        w = _flatten(matvec(_unflatten(q, example))).to(v0.dtype)
        alpha = q @ w
        # full reorthogonalization against every stored basis vector
        # subsumes the three-term recurrence (unfilled rows are zero)
        w = w - alpha * q
        w = w - basis.T @ (basis @ w)
        beta = torch.linalg.vector_norm(w)
        q = w / torch.clamp(beta, min=1e-30)
        alphas[j], betas[j] = alpha, beta
    t = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, evecs = torch.linalg.eigh(t)
    order = torch.argsort(evals, descending=True)
    return evals[order], (evecs[0, :] ** 2)[order]


def hutchinson_trace(quad: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                     metas: Dict[str, LayerMeta],
                     generator: Optional[torch.Generator] = None,
                     num_probes: int = 16,
                     probes: Optional[List[Dict[str, torch.Tensor]]] = None
                     ) -> torch.Tensor:
    """tr(F) estimate from Rademacher quadratic forms, E[v^T F v] = tr(F):
    the mean over ``probes`` (injected matrix-view dicts), else over
    ``num_probes`` drawn from ``generator``."""
    if probes is None:
        probes = [random_deltas(metas, generator)
                  for _ in range(num_probes)]
    vals = [torch.as_tensor(quad(v)) for v in probes]
    return torch.mean(torch.stack(vals))


def num_params(metas: Dict[str, LayerMeta]) -> int:
    """Tracked parameter count p (the matrix views' entries)."""
    return sum(math.prod(s) for s in delta_shapes(metas).values())
