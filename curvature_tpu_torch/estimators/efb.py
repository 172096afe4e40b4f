"""Eigenvalue-corrected Kronecker factorization (EFB / EKFAC).

Port of ``curvature_tpu/estimators/efb.py`` (the reference's ``EFB``,
curvatures.py:395-460), for plain, stacked and grouped layers: a stacked
layer's eigenvectors, moments and noise carry a leading depth axis (JAX
:77-135, :244-250), a grouped conv's a leading group axis, each group's
[out/g, cols] gradient block rotated into its own Kronecker eigenbasis
(JAX :123-127, :175-177, :216-218, :236-239); every product is batched
over that axis. The KFAC factors are
eigendecomposed once, at construction (``kfac_eigenvectors``: the
eigenvectors of A + A^T, utils.py:45-60); ``update`` then accumulates
the second moments of the gradient in the Kronecker eigenbasis

    state += sum_s (U_G^T g_s U_A)^2
    diags += B * sum_s g_s^2          (a free Diagonal, README.rst:246)

with g_s the [out, fan_in(+1)] gradient of the mean loss for MC sample s.
``invert`` is elementwise; ``sample`` scales [cols, out] noise in the
eigenbasis and rotates it out. The state and ``diags`` are updated in
place; the eigenvectors ride in ``inv_state`` (``_wrap_inv_aux``). Under
a mesh the carry (state, ``diags``, eigenvectors) takes the base depth
and expert rule: each rank keeps its block of a stacked layer's.
"""
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import (
    Estimator, group_rows, is_grouped, ungroup_rows)
from curvature_tpu_torch.estimators.capture import Captured
from curvature_tpu_torch.estimators.diagonal import damped
from curvature_tpu_torch.ops.linalg import eigh_sym, group_by_shape, ungroup


@torch.no_grad()
def kfac_eigenvectors(kfac_state: Dict, dtype=torch.float32) -> Dict:
    """Eigenvectors of each layer's KFAC factors, ``{name: {'a': U_A
    [(d,) cols, cols], 'g': U_G [(d,) out, out]}}`` (d: a stacked layer's
    depth, or a grouped conv's groups, whose G blocks are [g, out/g,
    out/g], [C, 1, 1] for a depthwise one): one batched ``eigh`` for each
    distinct factor shape (ResNet stages share them), as JAX (:30-54)."""
    flat = {f"{name}::{k}": fac[k].to(dtype)
            for name, fac in kfac_state.items() for k in "ag"}
    vecs = ungroup([(names, eigh_sym(stacked)[1])
                    for names, stacked in group_by_shape(flat)])
    return {name: {k: vecs[f"{name}::{k}"] for k in "ag"}
            for name in kfac_state}


def check_square_factors(kfac_state: Dict, metas):
    """Each layer's KFAC factors must be square [d, d] matrices ([depth,
    d, d] for a stacked layer, per-group [g, d, d] for a grouped conv):
    split attention and blocked-G factors are KFAC-only, a ValueError as
    in JAX (:69-83)."""
    for name, meta in metas.items():
        fac = kfac_state[name]
        want = 3 if (meta.stacked or is_grouped(meta)) else 2
        if "a_bias" in fac or fac["a"].ndim != want \
                or fac["g"].ndim != want:
            raise ValueError(
                f"{name}: split KFAC factors (attention_qkv_split / "
                "attention_head_split / blocked-G vocab heads) are "
                "KFAC-only; EFB/INF need square per-layer (or per-group) "
                "factors")


class EFB(Estimator):

    need_probe_grads = False

    def __init__(self, model, kfac_state: Dict, **kwargs):
        super().__init__(model, **kwargs)
        missing = set(self.metas) - set(kfac_state)
        if missing:
            raise ValueError(
                f"KFAC factors missing for layers: {sorted(missing)}")
        # only the tracked subset: with a layer_filter the (full-network)
        # kfac_state may carry extra layers
        check_square_factors(kfac_state, self.metas)
        self.eigvecs = kfac_eigenvectors(
            {n: {k: kfac_state[n][k].to(self.device) for k in "ag"}
             for n in self.metas}, self.dtype)
        # the free Diagonal in the [(depth,) out, cols] matrix view
        self.diags = {name: torch.zeros(((m.stacked,) if m.stacked else ())
                                        + (m.out_features, m.mat_cols),
                                        dtype=self.dtype, device=self.device)
                      for name, m in self.metas.items()}

    def _carry(self):
        return {"state": self.state, "diags": self.diags,
                "eigvecs": self.eigvecs}

    @staticmethod
    def _lead(m) -> tuple:
        """The leading axis of a layer's eigenbasis arrays: a stacked
        layer's depth, a grouped conv's groups."""
        return ((m.stacked,) if m.stacked else
                (m.groups,) if is_grouped(m) else ())

    def init_state(self):
        """Eigenbasis second moments, [(depth,) out, cols]; a grouped
        conv's per-group [g, out/g, cols] (JAX ``_lam_shape``)."""
        return {name: torch.zeros(self._lead(m) + (m.out_features
                                                   // m.groups, m.mat_cols),
                                  dtype=self.dtype, device=self.device)
                for name, m in self.metas.items()}

    def update_state(self, state, cap: Captured):
        """Both moments accumulate in place (curvatures.py:427-434)."""
        for name, meta in self.metas.items():
            g = cap.param_grads[name].to(self.dtype)  # [S, (L,) out, cols]
            ua, ug = self.eigvecs[name]["a"], self.eigvecs[name]["g"]
            lam = ug.mT @ group_rows(meta, g) @ ua    # [S, (L|g,) ., cols]
            state[name] += (lam * lam).sum(0)
            self.diags[name] += cap.batch_size * (g * g).sum(0)
        return state

    def invert_state(self, state, add, multiply):
        prec = damped(state, add, multiply, self.metas)
        return {name: torch.sqrt(1.0 / p) for name, p in prec.items()}

    def _inv_aux(self):
        return self.eigvecs

    def _wrap_inv_aux(self, inv, aux):
        return {"ilam": inv, "eigvecs": aux}

    def logdet_state(self, state, add, multiply):
        """Precision = U diag(s*lam + n) U^T with orthonormal Kronecker
        eigenvectors U, so logdet = sum log(s*lam + n)."""
        return sum(torch.log(p).sum()
                   for p in damped(state, add, multiply, self.metas).values())

    def quad_state(self, state, add, multiply, deltas):
        """sum((s*lam + n) * (U_G^T d U_A)^2) per layer (per group)."""
        tot = 0.0
        for name, p in damped(state, add, multiply, self.metas).items():
            ua, ug = self.eigvecs[name]["a"], self.eigvecs[name]["g"]
            d = group_rows(self.metas[name], deltas[name])
            tot = tot + (p * (ug.mT @ d @ ua) ** 2).sum()
        return tot

    def solve_state(self, inv_state, deltas):
        """P^{-1} d = U_G (ilam^2 * (U_G^T d U_A)) U_A^T."""
        out = {}
        for name, meta in self.metas.items():
            ua = inv_state["eigvecs"][name]["a"]
            ug = inv_state["eigvecs"][name]["g"]
            rot = ug.mT @ group_rows(meta, deltas[name]) @ ua
            out[name] = ungroup_rows(
                meta, ug @ (rot * inv_state["ilam"][name] ** 2) @ ua.mT)
        return out

    def noise_shapes(self) -> Dict[str, tuple]:
        """[(depth,) cols, out]; JAX's [g, cols, out/g] for a grouped conv
        (:236-239)."""
        return {name: self._lead(m) + (m.mat_cols, m.out_features
                                       // m.groups)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        """Eigenbasis noise scaled and rotated out, [(L,) out, cols]; a
        grouped conv's group blocks re-stacked group-major."""
        out = {}
        for name, meta in self.metas.items():
            ua = inv_state["eigvecs"][name]["a"]     # [(L|g,) cols, cols]
            ug = inv_state["eigvecs"][name]["g"]     # [(L|g,) out, out]
            z = noise[name] * inv_state["ilam"][name].mT   # [.., cols, out]
            out[name] = ungroup_rows(meta, (ua @ z @ ug.mT).mT)
        return out
