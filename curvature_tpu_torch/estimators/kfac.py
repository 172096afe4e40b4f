"""Kronecker-factored approximate curvature (KFAC).

Port of ``curvature_tpu/estimators/kfac.py`` for plain Conv/Dense layers,
depth-stacked (ScanBlocks) Dense layers and blocked-G vocabulary heads:

  update (per batch, per MC label sample s):
    A += (a_1^T a_1) / N          a_1: [N, fan_in+1] activations (+ones col),
                                  conv inputs expanded into patches
    G += (g_s^T g_s) * B^2 / N    g_s: [N, out] pre-activation gradients of
                                  the mean loss (the reference's hook scales
                                  grads by B before the Gram)
  invert: split damping, chol(inv(sqrt(mult)*F + sqrt(add)*I)) per factor.
  sample: matrix-normal A_chol @ Z @ G_chol^T, transposed to [out, cols].
  quad:   sum(d * (G_d d A_d)) with the split-damped factors A_d, G_d;
  solve:  G_d^-1 d A_d^-1 = (g_chol g_chol^T) d (a_chol a_chol^T).

The conv A factor is dispatched three ways, as in JAX (kfac.py:349-400):
the correlation Gram (ops/corr_gram.py) for stride-1 3x3 with many
channels and a large extent; the CUDA patch-Gram kernels
(ops/cuda/patch_gram.py) where ``select_patch_gram`` picks one; the patch
extraction + Gram otherwise. ``use_kernels`` is the JAX ``use_pallas``:
``"auto"`` enables the kernels on CUDA; ``False`` is the A/B switch.

``token_subsample < 1`` estimates the conv factors from a strided grid of
spatial positions, stride k = round(1/sqrt(token_subsample)) per dimension,
shifted by ``subsample_offset`` (JAX kfac.py:102-110, 254-259); it turns
off the kernel and correlation routes, so every conv A factor takes the
patch route. Under ``compute_dtype`` the Grams take the bf16 operands,
upcast to f32 before a strict-f32 matmul: each product of two bf16 values
is exact in f32, so this is JAX's bf16 einsum with
``preferred_element_type=f32``.

``corr_gram=False`` switches the correlation route off (JAX
kfac.py:194-198); ``corr_gram_min_channels``/``corr_gram_min_extent`` are
its gate. ``max_factor_dim`` bounds every factor's side, checked before
any factor is allocated (JAX kfac.py:147, :154-172, with its messages).
:meth:`KFAC.a_route` names the route of each conv layer from shapes alone.

A stacked layer (``LayerMeta.stacked`` = depth) keeps ``[depth, cols,
cols]`` A and ``[depth, out, out]`` G factors: per-depth Grams of its
``[depth, N, ...]`` tokens in one batched product, inverted, sampled and
summed over depth as JAX does (kfac.py:354-359, :438-450). A dense layer
whose ``out_features`` exceed ``max_factor_dim`` (a vocabulary head) gets
a block-diagonal G of ``ceil(out / g_block_size)`` ``[bs, bs]`` blocks
over zero-padded output features, sharing its A (``_is_gblock``, JAX
:228-241); the padded tail is sliced away at sample, solve and logdet.
``g_block_size=0`` restores the hard error. These Grams are products that
JAX leaves to XLA (no Pallas kernel): here they are cuBLAS matmuls.

A grouped or depthwise conv (``LayerMeta.groups`` = g > 1) keeps
block-diagonal per-group factors, ``[g, cols, cols]`` A and ``[g, og,
og]`` G (og = out / g): each group is an independent convolution, so the
cross-group covariance is exactly zero in its weight space (JAX
kfac.py:243-252). Its A factor takes the batched per-group Gram of
``grouped_act_tokens`` before any kernel route, as in JAX (:363-386: the
patch-Gram kernels hold one [F, F] accumulator), or the within-group
correlation Gram where ``corr_gram_grouped`` (default off, as in JAX)
and the correlation gate allow. Output channels are group-major, so its
G tokens, offsets and noise split the group axis with one reshape; its
noise is JAX's ``[g, cols, og]``.

Out of this slice: the attention qkv/head splits (they key on
``/in_proj`` names, which only ``nn.MultiheadAttention`` has),
``stack_grams`` and ``fused_g`` (whose fused-G capture set must leave
grouped layers out, JAX :282-302).
"""
import math
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import (
    Estimator, act_tokens, grad_tokens, group_rows, grouped_act_tokens,
    is_grouped, ungroup_rows)
from curvature_tpu_torch.estimators.capture import Captured
from curvature_tpu_torch.ops.corr_gram import (
    corr_gram_supported, corr_patch_gram)
from curvature_tpu_torch.ops.cuda.patch_gram import (
    patch_gram_tiled, patch_gram_v2, select_patch_gram)
from curvature_tpu_torch.ops.linalg import (
    chol_logdet, damped_inverse_cholesky, diag_add, sym)
from curvature_tpu_torch.ops.patches import resolve_padding


def _split_damped_logdet(factor, add, multiply):
    """logdet of the split-damped factor sqrt(s)*F + sqrt(n)*I."""
    eye = torch.eye(factor.shape[-1], dtype=factor.dtype,
                    device=factor.device)
    return chol_logdet(torch.sqrt(multiply) * factor + torch.sqrt(add) * eye)


def _gram_aligned(a: torch.Tensor, dtype) -> torch.Tensor:
    """``a^T a`` in ``dtype`` over the last two dims (batched over leading
    ones), the operands upcast first (bf16 x bf16 is exact in f32; a
    bf16-output matmul would round the result). The JAX version zero-pads
    the column count to a multiple of 128 for the MXU; cuBLAS needs no
    such help."""
    a = a.to(dtype)
    return a.transpose(-1, -2) @ a


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

    need_param_grads = False

    def __init__(self, model, *, use_kernels="auto",
                 token_subsample: float = 1.0, subsample_offset=(0, 0),
                 corr_gram: bool = True, corr_gram_grouped: bool = False,
                 corr_gram_min_channels: int = 128,
                 corr_gram_min_extent: int = 14, max_factor_dim: int = 16384,
                 g_block_size: int = 1024, **kwargs):
        # read by init_state, which the base constructor calls
        self.max_factor_dim = int(max_factor_dim)
        self.g_block_size = int(g_block_size)
        super().__init__(model, **kwargs)
        if use_kernels == "auto":
            self.use_kernels = self.device.type == "cuda"
        else:
            self.use_kernels = bool(use_kernels)
        if not 0.0 < token_subsample <= 1.0:
            raise ValueError("token_subsample must be in (0, 1]")
        self.token_subsample = float(token_subsample)
        self.subsample_offset = (int(subsample_offset[0]),
                                 int(subsample_offset[1]))
        self.corr_gram = bool(corr_gram)
        self.corr_gram_grouped = bool(corr_gram_grouped)
        self.corr_gram_min_channels = int(corr_gram_min_channels)
        self.corr_gram_min_extent = int(corr_gram_min_extent)
        # an offset outside [0, k) no longer indexes one of the k^2
        # partition grids (a biased estimate, or zero tokens and NaN)
        k = self._spatial_stride()
        if not all(0 <= o < k for o in self.subsample_offset):
            raise ValueError(
                f"subsample_offset {self.subsample_offset} must lie in "
                f"[0, {k}) per dim for token_subsample={self.token_subsample} "
                f"(spatial stride {k})")

    def _is_gblock(self, meta) -> bool:
        """Block-diagonal G for an oversized dense layer (a vocabulary
        head): out_features > max_factor_dim, blocks of g_block_size,
        shared A. Stacked layers keep the hard error (JAX :228-236)."""
        return (self.g_block_size > 0 and meta.kind == "dense"
                and not meta.stacked
                and meta.out_features > self.max_factor_dim)

    def _gblock_dims(self, meta):
        """(num_blocks, block_size, padded_out) of a blocked-G layer."""
        bs = min(self.g_block_size, meta.out_features)
        nb = -(-meta.out_features // bs)
        return nb, bs, nb * bs

    def _check_factor_dims(self):
        """JAX's guard (kfac.py:153-175), before any factor exists: a
        blocked-G layer bounds only its A side; any other factor side past
        ``max_factor_dim`` raises."""
        for name, meta in self.metas.items():
            if self._is_gblock(meta):
                if meta.fan_in + 1 > self.max_factor_dim:
                    raise ValueError(
                        f"{name}: A-factor dimension {meta.fan_in + 1} "
                        f"exceeds max_factor_dim={self.max_factor_dim}; "
                        "blocked-G only bounds the G side. Exclude the "
                        "layer with layer_filter or use Diagonal for it.")
                continue
            worst = max(meta.out_features, meta.fan_in + 1)
            if worst > self.max_factor_dim:
                raise ValueError(
                    f"{name}: KFAC factor dimension {worst} exceeds "
                    f"max_factor_dim={self.max_factor_dim} "
                    f"({worst}^2 f32 = {worst * worst * 4 / 2 ** 30:.1f} GB "
                    "per factor). Exclude the layer with layer_filter "
                    "(CLI --layers, e.g. 'h.*' to skip a vocab-sized "
                    "lm_head), use Diagonal for it, raise max_factor_dim, "
                    "or (dense layers) enable g_block_size.")

    def _spatial_stride(self) -> int:
        """Per-spatial-dim stride k such that ~token_subsample = 1/k^2."""
        if self.token_subsample >= 1.0:
            return 1
        return max(int(round(1.0 / math.sqrt(self.token_subsample))), 1)

    def init_state(self):
        self._check_factor_dims()
        z = dict(dtype=self.dtype, device=self.device)
        state = {}
        for name, m in self.metas.items():
            lead = (m.stacked,) if m.stacked else ()
            if is_grouped(m):
                if m.stacked:
                    raise ValueError(
                        f"{name}: grouped convs inside ScanBlocks are not "
                        "supported")
                og = m.out_features // m.groups
                state[name] = {
                    "a": torch.zeros((m.groups,) + (m.mat_cols,) * 2, **z),
                    "g": torch.zeros((m.groups, og, og), **z)}
                continue
            if self._is_gblock(m):
                nb, bs, _ = self._gblock_dims(m)
                g = torch.zeros((nb, bs, bs), **z)
            else:
                g = torch.zeros(lead + (m.out_features,) * 2, **z)
            state[name] = {"a": torch.zeros(lead + (m.mat_cols,) * 2, **z),
                           "g": g}
        return state

    # -- A factor -----------------------------------------------------------
    def a_route(self, meta, shape, itemsize: int) -> str:
        """The route of a layer's A factor for an input of ``shape`` (JAX
        layout) and ``itemsize`` bytes an element: ``"corr"`` (the
        correlation Gram), ``"grouped"`` (a grouped conv's batched
        per-group Gram), ``"tiled"`` or ``"v2"`` (the CUDA patch-Gram
        kernels, as ``select_patch_gram`` picks), or ``"patches"`` (patch
        extraction + Gram, every dense layer too), as in JAX
        kfac.py:363-400: a grouped conv takes the correlation Gram only
        under ``corr_gram_grouped``, and never a kernel."""
        if is_grouped(meta):
            return ("corr" if self.corr_gram_grouped
                    and self._corr_gram_ok(meta, shape) else "grouped")
        if self._corr_gram_ok(meta, shape):
            return "corr"
        if (self.use_kernels and meta.kind == "conv"
                and self.token_subsample >= 1.0
                and not isinstance(meta.padding, str)):
            which = select_patch_gram(shape[-1], meta.kernel_size,
                                      meta.strides, shape[1], shape[2],
                                      shape[0], itemsize)
            if which is not None:
                return which
        return "patches"

    def _a_factor(self, meta, act):
        """Per-batch A factor (already divided by its token count); a
        stacked layer's [depth, cols, cols], its depth axis batching the
        Gram (JAX :354-359)."""
        if meta.stacked:
            a = act.reshape(meta.stacked, -1, meta.fan_in)
            if meta.has_bias:
                a = torch.cat([a, a.new_ones(a.shape[:-1] + (1,))], dim=-1)
            return _gram_aligned(a, self.dtype) / a.shape[1]
        route = self.a_route(meta, act.shape, act.element_size())
        if route == "grouped":
            t = grouped_act_tokens(meta, act, append_ones=meta.has_bias,
                                   extra_stride=self._spatial_stride(),
                                   offset=self.subsample_offset)
            return _gram_aligned(t.transpose(0, 1), self.dtype) / t.shape[0]
        if route == "corr":
            return self._corr_a_factor(meta, act)
        if route in ("tiled", "v2"):
            fn = patch_gram_v2 if route == "v2" else patch_gram_tiled
            gram = fn(act, meta.kernel_size, meta.padding, meta.strides)
            if not meta.has_bias:
                gram = gram[:meta.fan_in, :meta.fan_in]
            return gram.to(self.dtype) / _conv_token_count(meta, act)
        return self._a_factor_xla(meta, act)

    def _corr_a_factor(self, meta, act):
        from dataclasses import replace
        gram = corr_patch_gram(act, meta.kernel_size, meta.padding,
                               has_bias=meta.has_bias, groups=meta.groups)
        pad = resolve_padding(meta.padding, act.shape[1], act.shape[2],
                              meta.kernel_size, meta.strides)
        return gram.to(self.dtype) / _conv_token_count(
            replace(meta, padding=pad), act)

    def _corr_gram_ok(self, meta, act) -> bool:
        """The correlation route's gate; ``act`` is the layer input or its
        shape."""
        shape = act.shape if torch.is_tensor(act) else act
        return (self.corr_gram and meta.kind == "conv"
                and corr_gram_supported(meta.kernel_size, meta.strides,
                                        meta.groups)
                and max(meta.kernel_size) <= 5
                and self.token_subsample >= 1.0
                and shape[-1] >= self.corr_gram_min_channels
                and min(shape[1], shape[2]) >= self.corr_gram_min_extent)

    def _a_factor_xla(self, meta, act):
        """Patch extraction + Gram (the name keeps the JAX counterpart's);
        also the subsampled route: the skipped positions are never
        generated."""
        a = act_tokens(meta, act, append_ones=meta.has_bias,
                       extra_stride=self._spatial_stride(),
                       offset=self.subsample_offset)
        return _gram_aligned(a, self.dtype) / a.shape[0]

    def _g_tokens(self, meta, g):
        """[S, ...preact] probe gradient -> ([S*N, out] tokens, N): the
        strided spatial grid of a conv when token_subsample < 1; a stacked
        layer's [S, depth, ...] -> [depth, S*N, out]."""
        if meta.stacked:
            s, depth = g.shape[:2]
            t = g.reshape(s, depth, -1, meta.out_features).transpose(0, 1)
            return t.reshape(depth, -1, meta.out_features), \
                t.shape[2]
        k = self._spatial_stride()
        if meta.kind == "conv" and k > 1:
            o0, o1 = self.subsample_offset
            g = g[:, :, o0::k, o1::k, :]
        t = grad_tokens(meta, g)
        return t, t.shape[0] // g.shape[0]

    def _gblock_gram(self, meta, g):
        """Per-block token Grams [nb, bs, bs] of [n, out] tokens whose
        columns are zero-padded to nb * bs: the padded tail's rows and
        columns are exactly zero (JAX :574-590)."""
        nb, bs, padded = self._gblock_dims(meta)
        g = torch.nn.functional.pad(g, (0, padded - meta.out_features))
        return _gram_aligned(g.reshape(-1, nb, bs).transpose(0, 1),
                             self.dtype)

    # -- transforms -----------------------------------------------------------
    def update_state(self, state, cap: Captured):
        """Adds this batch's factors into ``state`` in place."""
        num_mc = next(iter(cap.probe_grads.values())).shape[0]
        for name, meta in self.metas.items():
            # [S, ...preact] -> [S*N, out]: the S samples' Grams in one
            g, n_tok = self._g_tokens(meta, cap.probe_grads[name])
            if self._is_gblock(meta):
                gram = self._gblock_gram(meta, g)
            elif is_grouped(meta):
                # output channels are group-major: one reshape splits the
                # group axis (JAX :586-595)
                gq = g.reshape(-1, meta.groups, meta.out_features
                               // meta.groups)
                gram = _gram_aligned(gq.transpose(0, 1), self.dtype)
            else:
                gram = _gram_aligned(g, self.dtype)
            # (B*g)^T (B*g) = B^2 * g^T g: scale the [out, out] result
            g_factor = gram * (cap.batch_size ** 2 / n_tok)
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
        (per depth of a stacked one, per group of a grouped one) of the
        split-damped factors, summed.
        A blocked G's padded dims each add log(sqrt(add)) to its blocks'
        logdet, subtracted so the sum runs over the real out_features only
        (JAX :679-695)."""
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, (name, meta) in enumerate(self.metas.items()):
            fac = state[name]
            la = _split_damped_logdet(fac["a"], add[i], multiply[i])
            lg = _split_damped_logdet(fac["g"], add[i], multiply[i])
            cols = fac["a"].shape[-1]
            if self._is_gblock(meta):
                _, _, padded = self._gblock_dims(meta)
                pad = padded - meta.out_features
                lg_real = lg.sum() - pad * 0.5 * torch.log(add[i])
                tot = tot + meta.out_features * la + cols * lg_real
                continue
            tot = tot + (fac["g"].shape[-1] * la + cols * lg).sum()
        return tot

    def _blocks(self, meta, d):
        """A blocked-G layer's [out, cols] offset as zero-padded [nb, bs,
        cols] row blocks, a grouped conv's as [g, og, cols] group blocks;
        any other layer's as it is."""
        if not self._is_gblock(meta):
            return group_rows(meta, d)
        nb, bs, padded = self._gblock_dims(meta)
        d = torch.nn.functional.pad(d, (0, 0, 0, padded - meta.out_features))
        return d.reshape(nb, bs, -1)

    def _unblocks(self, meta, d):
        """Inverse of :meth:`_blocks`: the padded tail rows sliced away."""
        if not self._is_gblock(meta):
            return ungroup_rows(meta, d)
        return d.reshape(-1, d.shape[-1])[:meta.out_features]

    def quad_state(self, state, add, multiply, deltas):
        """delta^T (G_d (x) A_d) delta = sum(delta * (G_d delta A_d)) per
        layer, batched over a stacked layer's depth, a grouped conv's groups
        or a blocked G's blocks (zero-padded rows add exactly zero; JAX
        kfac.py:698-744)."""
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, (name, meta) in enumerate(self.metas.items()):
            fac, d = state[name], self._blocks(meta, deltas[name])
            s, n = torch.sqrt(multiply[i]), torch.sqrt(add[i])
            a_d = sym(diag_add(s * fac["a"], n))
            g_d = sym(diag_add(s * fac["g"], n))
            tot = tot + (d * (g_d @ d @ a_d)).sum()
        return tot

    def solve_state(self, inv_state, deltas):
        """``G_d^-1 d A_d^-1`` from the inverse Choleskys: chol(X^-1)
        chol(X^-1)^T = X^-1, per depth, group or G block (JAX
        kfac.py:746-784)."""
        out = {}
        for name, meta in self.metas.items():
            a_chol = inv_state[name]["a_chol"]
            g_chol = inv_state[name]["g_chol"]
            d = self._blocks(meta, deltas[name])
            sol = (g_chol @ (g_chol.mT @ d)) @ a_chol @ a_chol.mT
            out[name] = self._unblocks(meta, sol)
        return out

    def noise_shapes(self) -> Dict[str, tuple]:
        """[(depth,) cols, out]; [nb, cols, bs] for a blocked G, JAX's [g,
        cols, og] for a grouped conv (kfac.py:793-802)."""
        out = {}
        for name, m in self.metas.items():
            if is_grouped(m):
                out[name] = (m.groups, m.mat_cols, m.out_features // m.groups)
            elif self._is_gblock(m):
                nb, bs, _ = self._gblock_dims(m)
                out[name] = (nb, m.mat_cols, bs)
            else:
                lead = (m.stacked,) if m.stacked else ()
                out[name] = lead + (m.mat_cols, m.out_features)
        return out

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        """Matrix-normal A_chol z G_chol^T per layer, depth, group or G
        block, as [(depth,) out, cols]: a grouped conv's group blocks
        re-stacked group-major, a blocked G's padded rows dropped."""
        out = {}
        for name, meta in self.metas.items():
            a_chol = inv_state[name]["a_chol"]
            g_chol = inv_state[name]["g_chol"]
            w = (a_chol @ noise[name] @ g_chol.mT).mT
            out[name] = self._unblocks(meta, w)
        return out
