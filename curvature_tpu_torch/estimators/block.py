"""Exact per-layer (block-diagonal) Fisher.

Port of ``curvature_tpu/estimators/block.py`` (the reference's
``BlockDiagonal``, curvatures.py:196-261): the outer product of each
layer's flattened gradient, a [p, p] state for p = out * cols parameters
(``[depth, p, p]`` for a stacked layer, every transform batched over
depth, JAX :37-123), O(p^2) memory (practical for small layers only: the exact
reference the other estimators are checked against).

  update:  state += B * sum_s v_s v_s^T     (v_s: flattened gradient)
  invert:  L = chol(inv(sym(multiply * state + add * I)))
  sample:  L @ z

The flat order is torch's ``view(-1)`` of the weight, then the bias
(curvatures.py:214-216). The reference samples ``z @ L``, whose covariance
is L^T L, not inv(F) (block.py:8-11); ``L @ z`` has covariance inv(F).
"""
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import Estimator
from curvature_tpu_torch.estimators.capture import Captured
from curvature_tpu_torch.nn.core import LayerMeta
from curvature_tpu_torch.ops.linalg import (
    chol_inv, chol_logdet, diag_add, sym)


def _flatten_grad(mat: torch.Tensor, has_bias: bool) -> torch.Tensor:
    """[..., out, cols] matrix view -> [..., p] in torch ``view(-1)`` order
    (weight rows first, then the bias)."""
    lead = mat.shape[:-2]
    if has_bias:
        return torch.cat([mat[..., :-1].reshape(lead + (-1,)),
                          mat[..., -1]], dim=-1)
    return mat.reshape(lead + (-1,))


def _unflatten(vec: torch.Tensor, meta: LayerMeta) -> torch.Tensor:
    """Inverse of :func:`_flatten_grad`: [..., p] -> [..., out, cols]."""
    lead = vec.shape[:-1]
    nw = meta.out_features * meta.fan_in
    w = vec[..., :nw].reshape(lead + (meta.out_features, meta.fan_in))
    if meta.has_bias:
        return torch.cat([w, vec[..., nw:, None]], dim=-1)
    return w


class BlockDiagonal(Estimator):

    need_probe_grads = False

    def init_state(self):
        return {name: torch.zeros(((m.stacked,) if m.stacked else ())
                                  + (m.out_features * m.mat_cols,) * 2,
                                  dtype=self.dtype, device=self.device)
                for name, m in self.metas.items()}

    def update_state(self, state, cap: Captured):
        for name, meta in self.metas.items():
            v = _flatten_grad(cap.param_grads[name].to(self.dtype),
                              meta.has_bias)            # [S, (depth,) p]
            v = v.movedim(0, -2)                        # [(depth,) S, p]
            state[name] += cap.batch_size * (v.mT @ v)
        return state

    def _damped(self, state, add, multiply, i, name):
        return diag_add(multiply[i] * state[name], add[i])

    def invert_state(self, state, add, multiply):
        return {name: chol_inv(sym(self._damped(state, add, multiply, i,
                                                name)))
                for i, name in enumerate(self.metas)}

    def logdet_state(self, state, add, multiply):
        """Damped and factorized in float64: the p diagonal terms of an f32
        Cholesky
        each carry its rounding, and their sum drifts by ~p * 1e-7 (3.7e-5
        of the logdet of a 5,130-parameter block on the CPU, 19x JAX's
        own f32 error against float64)."""
        tot = torch.zeros((), dtype=torch.float64, device=self.device)
        for i, name in enumerate(self.metas):
            tot = tot + chol_logdet(diag_add(
                multiply[i].double() * state[name].double(), add[i])).sum()
        return tot.to(self.dtype)

    def quad_state(self, state, add, multiply, deltas):
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, (name, meta) in enumerate(self.metas.items()):
            damped = sym(self._damped(state, add, multiply, i, name))
            v = _flatten_grad(deltas[name], meta.has_bias)[..., None]
            tot = tot + (v * (damped @ v)).sum()
        return tot

    def solve_state(self, inv_state, deltas):
        # inv_state holds L = chol(P^{-1}), so P^{-1} d = L (L^T d)
        out = {}
        for name, meta in self.metas.items():
            l = inv_state[name]
            v = _flatten_grad(deltas[name], meta.has_bias)[..., None]
            out[name] = _unflatten((l @ (l.mT @ v))[..., 0], meta)
        return out

    def noise_shapes(self) -> Dict[str, tuple]:
        return {name: ((m.stacked,) if m.stacked else ())
                + (m.out_features * m.mat_cols,)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        return {name: _unflatten((inv_state[name] @ noise[name][..., None])
                                 [..., 0], meta)
                for name, meta in self.metas.items()}
