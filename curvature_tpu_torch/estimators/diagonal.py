"""Diagonal Fisher estimator.

Port of ``curvature_tpu/estimators/diagonal.py`` (the reference's
``Diagonal``, curvatures.py:132-193); a stacked layer's state carries a
leading depth axis, and every transform is elementwise (JAX :32-36):

  update:  state += B * sum_s g_s^2     (g_s: [out, fan_in(+1)] gradient of
                                         the mean loss for MC sample s)
  invert:  inv = sqrt(1 / (multiply * state + add))
  sample:  z * inv                      (z: [out, cols] standard normals)

The state is updated in place. Under a mesh a column-parallel layer's
state keeps its block of output rows, beside the layer's block of
columns (JAX :22-29); its gradient is that block already.
"""
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import Estimator
from curvature_tpu_torch.estimators.capture import Captured


def damped(state, add, multiply, names) -> Dict[str, torch.Tensor]:
    """``{name: multiply_i * state + add_i}``: the damped precision of an
    elementwise state (Diagonal's, and EFB's in its Kronecker eigenbasis),
    with per-layer damping in ``names`` order."""
    return {name: multiply[i] * state[name] + add[i]
            for i, name in enumerate(names)}


class Diagonal(Estimator):

    need_probe_grads = False
    shards_tensor_rows = True

    def _state_leaf_spec(self, name, keys, shape, ax):
        """The [out, cols] matrix view of a column-parallel layer shards its
        output rows over the tensor axis."""
        spec = super()._state_leaf_spec(name, keys, shape, ax)
        if (ax["tensor"] and name in ax["tp"] and len(shape) >= 2
                and spec[-2] is None and shape[-2] % ax["tensor_size"] == 0):
            spec[-2] = ax["tensor"]
        return spec

    def init_state(self):
        return {name: torch.zeros(shape, dtype=self.dtype, device=self.device)
                for name, shape in self.noise_shapes().items()}

    def update_state(self, state, cap: Captured):
        for name in self.metas:
            g = cap.param_grads[name].to(self.dtype)       # [S, out, cols]
            state[name] += cap.batch_size * (g * g).sum(0)
        return state

    def invert_state(self, state, add, multiply):
        prec = damped(state, add, multiply, self.metas)
        return {name: torch.sqrt(1.0 / p) for name, p in prec.items()}

    def noise_shapes(self) -> Dict[str, tuple]:
        return {name: ((m.stacked,) if m.stacked else ())
                + (m.out_features, m.mat_cols)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        return {name: noise[name] * inv_state[name] for name in self.metas}

    def solve_state(self, inv_state, deltas):
        # inv_state is sqrt(1 / (m*state + a)), so P^{-1} d = inv^2 * d
        return {name: inv_state[name] ** 2 * deltas[name]
                for name in self.metas}

    def logdet_state(self, state, add, multiply):
        return sum(torch.log(p).sum()
                   for p in damped(state, add, multiply, self.metas).values())

    def quad_state(self, state, add, multiply, deltas):
        return sum((p * deltas[name] ** 2).sum() for name, p in
                   damped(state, add, multiply, self.metas).items())
