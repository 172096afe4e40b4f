"""Nyström low-rank (subspace) Laplace estimator.

Port of ``curvature_tpu/estimators/subspace.py``. Every other estimator
is layer-local and drops every cross-layer second moment; this one models
the GLOBAL curvature: a rank-``R`` approximation of the full GGN/Fisher
over all tracked parameters jointly, from a streamed sketch

    Y  =  F @ Omega,        Omega ~ N(0, 1)^{p x R} fixed,

accumulated batch by batch with the exact matrix-free GGN products of
``ops/matfree.py``: one forward ``torch.func.vjp`` per batch and the R
columns J^T H J omega_r through ``torch.func.vmap`` over the tangents of
one ``jvp`` each (JAX vmaps them over one ``jax.linearize``, :134), in
chunks of ``chunk`` columns to bound the transient tangent and cotangent
activations (about ``chunk`` times one forward's). At ``invert`` time the
sketch becomes the randomized Nyström approximation

    F  ~=  Y (Omega^T Y)^+ Y^T  =  U diag(lam) U^T            (rank R)

(Tropp et al. 2017, Alg. 3, shifted, with a clipped-eigh pseudoinverse),
exact whenever rank(F) <= R. The damped precision is low rank plus
diagonal, P = D + M^{1/2} U diag(lam) U^T M^{1/2}, with per-layer damping
D = diag(add_l) and curvature scale M = diag(mult_l), and sampling,
log-determinant, quadratic form and solve are closed form:

    sample   x = D^{-1/2} (I + W K W^T) eps,   W = D^{-1/2} M^{1/2} U lam^{1/2}
    logdet P   = sum_l n_l log(add_l) + sum_r log(1 + s_r^2)
    d^T P d    = sum_l add_l ||d_l||^2 + || lam^{1/2} U^T M^{1/2} d ||^2

with s^2 the eigenvalues of W^T W (an [R, R] problem) and K = V
diag(((1+s^2)^{-1/2} - 1)/s^2) V^T, so (I + W K W^T) = (I + W W^T)^{-1/2}.

``update`` draws nothing: the GGN takes the label expectation
analytically; explicit labels or ``num_samples`` only set the
sample-count weight, for scale parity with the MC estimators. State per
layer is ``{"omega": [R, *view], "sketch": [R, *view]}`` in the matrix
view (a stacked layer's depth axis inside ``view``): the probe rides the
saved factors, so a reloaded state (a JAX-written one through
``models.state_from_jax`` too) gives the same posterior. Omega is drawn
from ``torch.Generator(device).manual_seed(omega_seed)``, or injected.
Memory is 2 p R floats.

Under a mesh (``use_mesh``, JAX :146-165) the state stays whole on every
rank and so does the model: the Nyström eigenbasis couples every layer,
and the GGN products run through ``torch.func`` transforms, which carry no
collective. Each rank runs the whole batch and applies the loss Hessian
to its block of the observations only (its rows over ``data``, its
tokens of ``[B, T, V]`` logits over ``seq``); the ranks' sketch columns
are summed over those axes, which equals one process's sketch. Nothing is
drawn, so the ``sample`` ranks, like the ``model``, ``tensor`` and
``expert`` ranks, repeat the same columns; ``update`` is JAX's
``_step_rng_meshed`` too, which ignores its key. A batch that does not
divide ``data`` runs whole on every rank; a token count that does not
divide ``seq`` drops only seq.
"""
import math
from typing import Dict, Optional, Sequence, Union

import torch
from torch.func import jvp, vjp, vmap

from curvature_tpu_torch.estimators.base import Estimator
from curvature_tpu_torch.ops import matfree
from curvature_tpu_torch.parallel.mesh import all_reduce_tree
from curvature_tpu_torch.utils.casting import cast_floats, cast_input

__all__ = ["Subspace"]


class Subspace(Estimator):
    """Global low-rank GGN Laplace via a streamed Nyström sketch."""

    # no capture pass: the GGN products run their own forward
    need_param_grads = False
    need_probe_grads = False
    places_model = False

    def use_mesh(self, mesh, *args, **kwargs):
        """The base ``use_mesh`` with every state leaf whole and the model
        left whole (module docstring); a model another estimator already
        split over the mesh raises ``ValueError``."""
        from curvature_tpu_torch.nn.placement import is_split
        if is_split(self.model):
            raise ValueError(
                "the Subspace sketch runs the whole model on every rank; "
                "build it on a model no estimator has split")
        return super().use_mesh(mesh, *args, **kwargs)

    # -- mesh rules (JAX :156-165) --------------------------------------------
    def _tp_ok(self, name, meta):
        # the Nyström eigenbasis couples all layers: state stays whole
        return False

    def _state_leaf_spec(self, name, keys, shape, ax):
        # leaves are [R, *view]: the global invert contracts over them
        return [None] * len(shape)

    def _obs_block(self, x, lead):
        """(this rank's observations as a flat 0/1 mask, or None, and the
        group its sketch columns are summed over): its rows of the batch
        over ``data`` and, for ``[B, T, V]`` logits, its tokens over
        ``seq``."""
        mesh = self.mesh
        if mesh is None:
            return None, None
        mode = self._dispatch(x.shape[0], None, self._tokens(x))
        keep = torch.ones(lead, dtype=torch.bool, device=self.device)
        axes = []
        d_ax, q_ax = self._data_axis, self._seq_axis
        if mode != "single" and mesh.size(d_ax) > 1:
            rows = mesh.rows(lead[0], d_ax)
            mask = torch.zeros_like(keep)
            mask[rows] = True
            keep &= mask
            axes.append(d_ax)
        if mode == "sharded" and mesh.size(q_ax) > 1 and len(lead) == 2:
            tok = mesh.rows(lead[1], q_ax)
            mask = torch.zeros_like(keep)
            mask[:, tok] = True
            keep &= mask
            axes.append(q_ax)
        if not axes:
            return None, None
        return keep.reshape(-1), mesh.group_of(axes)
    def __init__(self, model, rank: int = 16, omega_seed: int = 0,
                 layer_types: Optional[Union[str, Sequence[str]]] = None,
                 dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 loss: str = "cross_entropy",
                 layer_filter: Optional[Union[str, Sequence[str]]] = None,
                 omega: Optional[Dict[str, torch.Tensor]] = None,
                 chunk: Optional[int] = None):
        """``omega`` ({layer: [R, *view]}) replaces the seeded draw (its R
        is the rank); ``chunk`` is the number of sketch columns one
        ``vmap`` computes (default: all R at once)."""
        self.rank = int(rank)
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        self.omega_seed = int(omega_seed)
        self.chunk = chunk
        self._omega = omega
        super().__init__(model, dtype=dtype, compute_dtype=compute_dtype,
                         layer_filter=layer_filter, layer_types=layer_types,
                         loss=loss)
        self._omega = None

    # -- state ----------------------------------------------------------------
    def init_state(self):
        shapes = matfree.delta_shapes(self.metas)
        if self._omega is not None:
            missing = sorted(set(shapes) - set(self._omega))
            if missing:
                raise ValueError(f"omega lacks the tracked layers {missing}")
            omega = {n: torch.as_tensor(self._omega[n], dtype=self.dtype,
                                        device=self.device)
                     for n in shapes}
            self.rank = next(iter(omega.values())).shape[0]
        else:
            # a sketch wider than the tracked parameter count makes
            # Omega^T Omega singular; R = p is already exact
            self.rank = min(self.rank, matfree.num_params(self.metas))
            gen = torch.Generator(device=self.device).manual_seed(
                self.omega_seed)
            omega = {n: torch.randn((self.rank,) + s, generator=gen,
                                    dtype=self.dtype, device=self.device)
                     for n, s in shapes.items()}
        return {n: {"omega": o, "sketch": torch.zeros_like(o)}
                for n, o in omega.items()}

    def noise_shapes(self):
        return matfree.delta_shapes(self.metas)

    # -- sketch update (no capture pass) --------------------------------------
    def update(self, x: torch.Tensor, labels=None,
               generator: Optional[torch.Generator] = None,
               num_samples: int = 1):
        """Fold one batch into the sketch. The label expectation is
        exact: ``labels`` ([S, B], or one [B] set; [S, B, T] / [B, T] for
        ``loss='lm'``, [S, B, D] / [B, D] for ``'gaussian'``) weigh as S
        samples, else ``num_samples`` weigh (JAX :142-150); ``generator``
        is not used."""
        del generator
        weight = num_samples
        if labels is not None:
            labels = torch.as_tensor(labels)
            lead = 2 if self.loss in ("gaussian", "lm") else 1
            weight = labels.shape[0] if labels.ndim > lead else 1
        self._accumulate(self.state, x, weight)
        return self.state

    @torch.no_grad()
    def _accumulate(self, state, x, weight):
        """R exact GGN columns F_batch @ omega_r, added in place into the
        sketch with weight ``weight / #observations`` (the batch size, or
        B*T: [B, T, V] logits flatten to token observations)."""
        params = None
        if self.compute_dtype is not None:
            params = cast_floats(dict(self.model.named_parameters()),
                                 self.compute_dtype)
            x = cast_input(x, self.compute_dtype)
        metas = self.metas
        primals, f = matfree._forward_fn(self.model, metas, x, params=params)
        with matfree._mode(self.model, True):
            logits, pullback = vjp(f, primals)
            obs = math.prod(logits.shape[:-1])
            logits2d = logits.reshape(obs, logits.shape[-1])
            keep, group = self._obs_block(x, tuple(logits.shape[:-1]))

            def column(col):
                _, u = jvp(f, (primals,),
                           (matfree._tangent(metas, primals, col),))
                hu = matfree._h_apply(self.loss, logits2d,
                                      u.reshape(logits2d.shape))
                if keep is not None:
                    hu = hu * keep[:, None].to(hu.dtype)
                (g,) = pullback(hu.reshape(logits.shape))
                return {n: m.to(self.dtype)
                        for n, m in matfree._matrices(metas, g,
                                                      metas).items()}

            scale = float(weight) / obs
            step = self.chunk or self.rank
            # a meshed rank's columns are summed over its group first
            delta = ({n: state[n]["sketch"] for n in metas} if group is None
                     else {n: torch.zeros_like(state[n]["sketch"])
                           for n in metas})
            for lo in range(0, self.rank, step):
                cols = vmap(column)({n: state[n]["omega"][lo:lo + step]
                                     for n in metas})
                for n in metas:
                    delta[n][lo:lo + step].add_(
                        cols[n], alpha=scale if group is None else 1.0)
            if group is not None:
                all_reduce_tree(list(delta.values()), group)
                for n in metas:
                    state[n]["sketch"].add_(delta[n], alpha=scale)
        return state

    # -- Nyström factorization (Tropp et al. 2017, Alg. 3, shifted) -----------
    def _nystrom(self, state):
        names = list(self.metas)
        finfo = torch.finfo(self.dtype)
        Y = {n: state[n]["sketch"].reshape(self.rank, -1) for n in names}
        Om = {n: state[n]["omega"].reshape(self.rank, -1) for n in names}
        ynorm = torch.sqrt(sum(torch.sum(Y[n] * Y[n]) for n in names))
        nu = finfo.eps * ynorm + finfo.tiny
        Ynu = {n: Y[n] + nu * Om[n] for n in names}
        C = sum(Om[n] @ Ynu[n].T for n in names)
        C = 0.5 * (C + C.T)
        # clipped-eigh pseudoinverse instead of Tropp's Cholesky solve: as
        # R approaches the tracked parameter count sigma_min(Om^T Om)
        # collapses and the shifted Cholesky fails in f32; the clipped
        # modes carry no curvature (lam ~ 0)
        c, E = torch.linalg.eigh(C)
        tol = self.rank * finfo.eps * torch.clamp(c[-1], min=0.0) \
            + finfo.tiny
        c_inv_sqrt = torch.where(
            c > tol, 1.0 / torch.sqrt(torch.maximum(c, tol)),
            torch.zeros_like(c))
        B = {n: c_inv_sqrt[:, None] * (E.T @ Ynu[n]) for n in names}
        del Ynu
        M = sum(B[n] @ B[n].T for n in names)
        s2, V = torch.linalg.eigh(M)
        s2 = torch.clamp(s2, min=0.0)
        lam = torch.clamp(s2 - nu, min=0.0)
        inv_s = torch.where(s2 > 0, 1.0 / torch.sqrt(s2 + finfo.tiny),
                            torch.zeros_like(s2))
        U = {n: inv_s[:, None] * (V.T @ B[n]) for n in names}  # rows: eigvecs
        return U, lam

    def _low_rank_spectrum(self, state, add, multiply):
        """Eigenvalues s2 of W^T W plus the pieces sampling needs."""
        U, lam = self._nystrom(state)
        W = {}
        for i, name in enumerate(self.metas):
            W[name] = torch.sqrt(multiply[i] / add[i]) * \
                torch.sqrt(lam)[:, None] * U[name]
        G = sum(W[n] @ W[n].T for n in W)
        s2w, Vw = torch.linalg.eigh(G)
        s2w = torch.clamp(s2w, min=0.0)
        return U, lam, W, s2w, Vw

    # -- posterior ------------------------------------------------------------
    def invert_state(self, state, add, multiply):
        _, _, W, s2w, Vw = self._low_rank_spectrum(state, add, multiply)
        # (I + W W^T)^{-1/2} = I + W K W^T; ((1+s)^{-1/2} - 1)/s -> -1/2 as
        # s -> 0, so zero modes need no normalized direction
        safe = torch.where(s2w > 0, s2w, torch.ones_like(s2w))
        ratio = torch.where(s2w > 0, (1.0 / torch.sqrt(1.0 + s2w) - 1.0)
                            / safe, torch.full_like(s2w, -0.5))
        inv = {"k": (Vw * ratio) @ Vw.T,
               "dinv_sqrt": 1.0 / torch.sqrt(add)}
        for name in self.metas:
            inv[f"w::{name}"] = W[name].reshape(state[name]["sketch"].shape)
        return inv

    def _correct(self, inv_state, v):
        """(I + W K W^T) v for a matrix-view dict ``v``."""
        t = sum(inv_state[f"w::{n}"].reshape(self.rank, -1)
                @ v[n].reshape(-1) for n in self.metas)
        y = inv_state["k"] @ t
        return {n: v[n] + (inv_state[f"w::{n}"].reshape(self.rank, -1).T
                           @ y).reshape(v[n].shape)
                for n in self.metas}

    def _apply_sqrt(self, inv_state, eps: Dict[str, torch.Tensor]):
        """The exact covariance square root, x = D^{-1/2}(I + W K W^T)
        eps, so cov(x) = P^{-1} for standard-normal eps; split out from
        :meth:`sample_state` so tests can drive it with basis vectors."""
        out = self._correct(inv_state, eps)
        dinv = inv_state["dinv_sqrt"]
        return {n: out[n] * dinv[i] for i, n in enumerate(self.metas)}

    def sample_state(self, inv_state, noise):
        return self._apply_sqrt(inv_state, noise)

    def solve_state(self, inv_state, deltas):
        """P^{-1} d = A (A^T d) with the sampling square root A =
        D^{-1/2}(I + W K W^T): the damping scale first, then the low-rank
        correction twice, then the damping scale again."""
        dinv = inv_state["dinv_sqrt"]
        u = self._correct(inv_state, {
            n: deltas[n].to(self.dtype) * dinv[i]
            for i, n in enumerate(self.metas)})
        out = self._correct(inv_state, u)
        return {n: out[n] * dinv[i] for i, n in enumerate(self.metas)}

    def logdet_state(self, state, add, multiply):
        _, _, _, s2w, _ = self._low_rank_spectrum(state, add, multiply)
        tot = torch.sum(torch.log1p(s2w))
        for i, name in enumerate(self.metas):
            n_l = state[name]["sketch"][0].numel()
            tot = tot + n_l * torch.log(add[i])
        return tot

    def quad_state(self, state, add, multiply, deltas):
        U, lam = self._nystrom(state)
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        proj = torch.zeros(self.rank, dtype=self.dtype, device=self.device)
        for i, name in enumerate(self.metas):
            d = deltas[name].to(self.dtype)
            tot = tot + add[i] * torch.sum(d * d)
            proj = proj + torch.sqrt(multiply[i]) * (U[name] @ d.reshape(-1))
        return tot + torch.sum(lam * proj * proj)

    # -- diagnostics ----------------------------------------------------------
    def eigenvalues(self) -> torch.Tensor:
        """Nyström eigenvalues of the RAW accumulated curvature (divide by
        updates*samples for the batch-mean Fisher spectrum)."""
        return self._nystrom(self.state)[1]
