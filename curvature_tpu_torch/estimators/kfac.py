"""Kronecker-factored approximate curvature (KFAC), plain layers.

Port of ``curvature_tpu/estimators/kfac.py`` for plain Conv/Dense layers:

  update (per batch, per MC label sample s):
    A += (a_1^T a_1) / N          a_1: [N, fan_in+1] activations (+ones col),
                                  conv inputs expanded into patches
    G += (g_s^T g_s) * B^2 / N    g_s: [N, out] pre-activation gradients of
                                  the mean loss (the reference's hook scales
                                  grads by B before the Gram)
  invert: split damping, chol(inv(sqrt(mult)*F + sqrt(add)*I)) per factor.
  sample: matrix-normal A_chol @ Z @ G_chol^T, transposed to [out, cols].

The conv A factor is dispatched three ways, as in JAX (kfac.py:349-400):
the correlation Gram (ops/corr_gram.py) for stride-1 3x3 with many
channels and a large extent; the CUDA patch-Gram kernels
(ops/cuda/patch_gram.py) where ``select_patch_gram`` picks one; the patch
extraction + Gram otherwise. ``use_kernels`` is the JAX ``use_pallas``:
``"auto"`` enables the kernels on CUDA; ``False`` is the A/B switch.

Out of this slice: grouped convs, attention/qkv/head splits, blocked G,
``stack_grams``, ``fused_g``, ``token_subsample < 1`` and
``compute_dtype``.
"""
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import (
    Estimator, act_tokens, grad_tokens)
from curvature_tpu_torch.estimators.capture import Captured
from curvature_tpu_torch.ops.corr_gram import (
    corr_gram_supported, corr_patch_gram)
from curvature_tpu_torch.ops.cuda.patch_gram import (
    patch_gram_tiled, patch_gram_v2, select_patch_gram)
from curvature_tpu_torch.ops.linalg import (
    chol_logdet, damped_inverse_cholesky)
from curvature_tpu_torch.ops.patches import resolve_padding


def _split_damped_logdet(factor, add, multiply):
    """logdet of the split-damped factor sqrt(s)*F + sqrt(n)*I."""
    eye = torch.eye(factor.shape[-1], dtype=factor.dtype,
                    device=factor.device)
    return chol_logdet(torch.sqrt(multiply) * factor + torch.sqrt(add) * eye)


def _gram_aligned(a: torch.Tensor, dtype) -> torch.Tensor:
    """``a^T a`` in ``dtype``. (The JAX version zero-pads the column count
    to a multiple of 128 for the MXU; cuBLAS needs no such help.)"""
    a = a.to(dtype)
    return a.T @ a


def _conv_token_count(meta, act) -> int:
    """B * H_out * W_out for a conv layer's explicit padding."""
    b, h, w, _ = act.shape
    kh, kw = meta.kernel_size
    sh, sw = meta.strides
    (pt, pb), (pl, pr) = meta.padding
    h_out = (h + pt + pb - kh) // sh + 1
    w_out = (w + pl + pr - kw) // sw + 1
    return b * h_out * w_out


class KFAC(Estimator):

    #: channel gate of the correlation-Gram route (the JAX default)
    corr_gram_min_channels = 128

    def __init__(self, model, *, use_kernels="auto",
                 corr_gram_min_extent: int = 14, **kwargs):
        super().__init__(model, **kwargs)
        if use_kernels == "auto":
            self.use_kernels = self.device.type == "cuda"
        else:
            self.use_kernels = bool(use_kernels)
        self.corr_gram_min_extent = int(corr_gram_min_extent)

    def init_state(self):
        z = dict(dtype=self.dtype, device=self.device)
        return {name: {"a": torch.zeros((m.mat_cols, m.mat_cols), **z),
                       "g": torch.zeros((m.out_features,) * 2, **z)}
                for name, m in self.metas.items()}

    # -- A factor -----------------------------------------------------------
    def _a_factor(self, meta, act):
        """Per-batch A factor (already divided by its token count)."""
        if self._corr_gram_ok(meta, act):
            return self._corr_a_factor(meta, act)
        if (self.use_kernels and meta.kind == "conv"
                and not isinstance(meta.padding, str)):
            which = select_patch_gram(
                act.shape[-1], meta.kernel_size, meta.strides,
                act.shape[1], act.shape[2], act.shape[0],
                act.element_size())
            if which is not None:
                fn = patch_gram_v2 if which == "v2" else patch_gram_tiled
                gram = fn(act, meta.kernel_size, meta.padding, meta.strides)
                if not meta.has_bias:
                    gram = gram[:meta.fan_in, :meta.fan_in]
                return gram.to(self.dtype) / _conv_token_count(meta, act)
        return self._a_factor_xla(meta, act)

    def _corr_a_factor(self, meta, act):
        from dataclasses import replace
        gram = corr_patch_gram(act, meta.kernel_size, meta.padding,
                               has_bias=meta.has_bias)
        pad = resolve_padding(meta.padding, act.shape[1], act.shape[2],
                              meta.kernel_size, meta.strides)
        return gram.to(self.dtype) / _conv_token_count(
            replace(meta, padding=pad), act)

    def _corr_gram_ok(self, meta, act) -> bool:
        return (meta.kind == "conv"
                and corr_gram_supported(meta.kernel_size, meta.strides)
                and max(meta.kernel_size) <= 5
                and act.shape[-1] >= self.corr_gram_min_channels
                and min(act.shape[1], act.shape[2])
                >= self.corr_gram_min_extent)

    def _a_factor_xla(self, meta, act):
        """Patch extraction + Gram (the name keeps the JAX counterpart's)."""
        a = act_tokens(meta, act, append_ones=meta.has_bias)
        return _gram_aligned(a, self.dtype) / a.shape[0]

    # -- transforms -----------------------------------------------------------
    def update_state(self, state, cap: Captured):
        """Adds this batch's factors into ``state`` in place."""
        num_mc = next(iter(cap.probe_grads.values())).shape[0]
        for name, meta in self.metas.items():
            # [S, ...preact] -> [S*N, out]: the S samples' Grams in one
            g = grad_tokens(meta, cap.probe_grads[name]).to(self.dtype)
            n_tok = g.shape[0] // num_mc
            # (B*g)^T (B*g) = B^2 * g^T g: scale the [out, out] result
            g_factor = (g.T @ g) * (cap.batch_size ** 2 / n_tok)
            a_factor = self._a_factor(meta, cap.acts[name])
            state[name]["a"] += num_mc * a_factor.to(self.dtype)
            state[name]["g"] += g_factor
        return state

    def invert_state(self, state, add, multiply):
        return {name: {
            "a_chol": damped_inverse_cholesky(state[name]["a"], add[i],
                                              multiply[i]),
            "g_chol": damped_inverse_cholesky(state[name]["g"], add[i],
                                              multiply[i]),
        } for i, name in enumerate(self.metas)}

    def logdet_state(self, state, add, multiply):
        """logdet(A (x) G) = out * logdet(A) + cols * logdet(G) per layer
        of the split-damped factors, summed."""
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, name in enumerate(self.metas):
            fac = state[name]
            la = _split_damped_logdet(fac["a"], add[i], multiply[i])
            lg = _split_damped_logdet(fac["g"], add[i], multiply[i])
            tot = tot + fac["g"].shape[-1] * la + fac["a"].shape[-1] * lg
        return tot

    def noise_shapes(self) -> Dict[str, tuple]:
        return {name: (m.mat_cols, m.out_features)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.metas:
            a_chol = inv_state[name]["a_chol"]
            g_chol = inv_state[name]["g_chol"]
            out[name] = (a_chol @ noise[name] @ g_chol.T).T    # [out, cols]
        return out
