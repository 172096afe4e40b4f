"""Eigenvalue-corrected Kronecker factorization (EFB / EKFAC).

Port of ``curvature_tpu/estimators/efb.py`` (the reference's ``EFB``,
curvatures.py:395-460), for plain and stacked layers (a stacked layer's
eigenvectors, moments and noise carry a leading depth axis, every product
batched over it, JAX :77-135, :244-250). The KFAC factors are
eigendecomposed once, at construction (``kfac_eigenvectors``: the
eigenvectors of A + A^T, utils.py:45-60); ``update`` then accumulates the
second moments of the gradient in the Kronecker eigenbasis

    state += sum_s (U_G^T g_s U_A)^2
    diags += B * sum_s g_s^2          (a free Diagonal, README.rst:246)

with g_s the [out, fan_in(+1)] gradient of the mean loss for MC sample s.
``invert`` is elementwise; ``sample`` scales [cols, out] noise in the
eigenbasis and rotates it out. The state and ``diags`` are updated in
place; the eigenvectors ride in ``inv_state`` (``_wrap_inv_aux``).
"""
from typing import Dict

import torch

from curvature_tpu_torch.estimators.base import Estimator
from curvature_tpu_torch.estimators.capture import Captured
from curvature_tpu_torch.estimators.diagonal import damped
from curvature_tpu_torch.ops.linalg import eigh_sym, group_by_shape, ungroup

_NOT_PORTED = ("grouped-conv factors are not ported yet (ROADMAP Queue 1 "
               "item 3)")


@torch.no_grad()
def kfac_eigenvectors(kfac_state: Dict, dtype=torch.float32) -> Dict:
    """Eigenvectors of each layer's KFAC factors, ``{name: {'a': U_A
    [(depth,) cols, cols], 'g': U_G [(depth,) out, out]}}``: one batched
    ``eigh`` for each distinct factor shape (ResNet stages share them; a
    stacked layer's [depth, d, d] factors batch over depth too), as JAX
    (:30-54)."""
    flat = {f"{name}::{k}": fac[k].to(dtype)
            for name, fac in kfac_state.items() for k in "ag"}
    vecs = ungroup([(names, eigh_sym(stacked)[1])
                    for names, stacked in group_by_shape(flat)])
    return {name: {k: vecs[f"{name}::{k}"] for k in "ag"}
            for name in kfac_state}


def check_square_factors(kfac_state: Dict, metas):
    """Each layer's KFAC factors must be square [d, d] matrices ([depth,
    d, d] for a stacked layer): split attention and blocked-G factors are
    KFAC-only (a ValueError, as in JAX); other 3-d factors are grouped
    convs', not ported (NotImplementedError)."""
    for name, meta in metas.items():
        fac = kfac_state[name]
        want = 3 if meta.stacked else 2
        if "a_bias" in fac or fac["a"].ndim > 3 or fac["g"].ndim > 3 \
                or (meta.kind == "dense" and fac["g"].ndim > want):
            raise ValueError(
                f"{name}: split KFAC factors (attention_qkv_split / "
                "attention_head_split / blocked-G vocab heads) are "
                "KFAC-only; EFB/INF need square per-layer factors")
        if fac["a"].ndim != want or fac["g"].ndim != want:
            raise NotImplementedError(f"{name}: {_NOT_PORTED}")


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
        self.diags = {n: torch.zeros_like(s) for n, s in self.state.items()}

    def init_state(self):
        return {name: torch.zeros(((m.stacked,) if m.stacked else ())
                                  + (m.out_features, m.mat_cols),
                                  dtype=self.dtype, device=self.device)
                for name, m in self.metas.items()}

    def update_state(self, state, cap: Captured):
        """Both moments accumulate in place (curvatures.py:427-434)."""
        for name in self.metas:
            g = cap.param_grads[name].to(self.dtype)  # [S, (L,) out, cols]
            ua, ug = self.eigvecs[name]["a"], self.eigvecs[name]["g"]
            lam = ug.mT @ g @ ua                      # [S, (L,) out, cols]
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
        """sum((s*lam + n) * (U_G^T d U_A)^2) per layer."""
        tot = 0.0
        for name, p in damped(state, add, multiply, self.metas).items():
            ua, ug = self.eigvecs[name]["a"], self.eigvecs[name]["g"]
            tot = tot + (p * (ug.mT @ deltas[name] @ ua) ** 2).sum()
        return tot

    def solve_state(self, inv_state, deltas):
        """P^{-1} d = U_G (ilam^2 * (U_G^T d U_A)) U_A^T."""
        out = {}
        for name in self.metas:
            ua = inv_state["eigvecs"][name]["a"]
            ug = inv_state["eigvecs"][name]["g"]
            rot = ug.mT @ deltas[name] @ ua
            out[name] = ug @ (rot * inv_state["ilam"][name] ** 2) @ ua.mT
        return out

    def noise_shapes(self) -> Dict[str, tuple]:
        return {name: ((m.stacked,) if m.stacked else ())
                + (m.mat_cols, m.out_features)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.metas:
            ua = inv_state["eigvecs"][name]["a"]     # [(L,) cols, cols]
            ug = inv_state["eigvecs"][name]["g"]     # [(L,) out, out]
            z = noise[name] * inv_state["ilam"][name].mT   # [(L,) cols, out]
            out[name] = (ua @ z @ ug.mT).mT          # [(L,) out, cols]
        return out
