"""Sparse information form (INF): a low-rank plus diagonal-correction
posterior.

Port of ``curvature_tpu/estimators/inf.py`` (the reference's ``INF``,
curvatures.py:463-672), for plain, stacked and grouped layers: a stacked
layer selects its index sets per depth and pads them to one shared
bucketed (L, M), so its state stacks ``[depth, ...]`` and every later
step runs batched over depth (JAX :239-520); a grouped conv runs the same
body with its groups in place of depth (each group is an independent
Kronecker basis, its [g, out/g, cols] blocks re-stacked group-major into
the [out, cols] view; JAX :240-245, :313-324, :464-467, :508-519).
Inputs: the Diagonal state (EFB's free ``diags``), the KFAC factors and
the EFB lambdas. Per layer (or slab), with U_A [n, n] and U_G [m, m] the
factors' eigenvectors (n = cols, m = out) and the flat layout k = i*m + j
of the transposed [cols, out] matrix:

  update:  keep the top-|lambda| entries, complete their (A, G) index
           sets to a product grid (``dim_reduction``), V = U_A[:, left]
           (x) U_G[:, right]; corr = diag - diag(V diag(lam) V^T);
  invert:  D = multiply * max(corr, 0) + add; S^2 = multiply * lam; the
           Woodbury cache ``pre_sampler`` of D + V S^2 V^T;
  sample:  M z with M M^T = (D + V S^2 V^T)^-1 (``inf_sample``).

The index selection runs in numpy on the host, as in JAX (:288-393). The
R x R Gram (R = |left| * |right|) is built from two Khatri-Rao products
(``_vtv_gram``), never from the [L, L, m, M] intermediate a pairwise
einsum would make. The eigendecompositions and Grams are large dense
products that JAX leaves to XLA: here they are torch ops (cuSOLVER,
cuBLAS), no hand kernel.

Under a mesh the carry (the inputs, their eigenvectors and the state)
takes the base depth and expert rule: each rank builds its slabs of a
stacked layer, their padded (L, M) the largest over the stack's ranks,
so the blocks are those of one process's state.
"""
from typing import Dict, Optional

import numpy as np
import torch

from curvature_tpu_torch.estimators.base import (
    Estimator, group_rows, is_grouped, ungroup_rows)
from curvature_tpu_torch.estimators.efb import (
    check_square_factors, kfac_eigenvectors)
from curvature_tpu_torch.nn.core import param_key
from curvature_tpu_torch.ops.linalg import sym
from curvature_tpu_torch.parallel.mesh import group_size


def dim_reduction(lam_vec: np.ndarray, n: int, m: int, rank: int,
                  max_product: int = 0):
    """Top-|lambda| index selection with index-set product completion.

    ``lam_vec``: [n*m] eigenbasis second moments, layout k = i*m + j (i:
    A-side eigenvector, j: G-side). ``max_product`` > 0 caps
    len(left)*len(right), trimming each set to its highest-|lambda|-mass
    members; 0 keeps the reference behavior. Returns (left [L], right [M],
    grid [L*M]) as numpy arrays."""
    p = lam_vec.shape[0]
    if rank >= p and (max_product <= 0 or p <= max_product):
        left = np.arange(n)
        right = np.arange(m)
    else:
        order = np.argsort(-np.abs(lam_vec), kind="stable")[:min(rank, p)]
        left = np.unique(order // m)
        right = np.unique(order % m)
        if max_product > 0 and len(left) * len(right) > max_product:
            lam_mat = np.abs(lam_vec.reshape(n, m))
            left_mass = lam_mat[:, right].sum(axis=1)
            right_mass = lam_mat[left].sum(axis=0)
            # shrink the larger set first until the product fits
            left = left[np.argsort(-left_mass[left], kind="stable")]
            right = right[np.argsort(-right_mass[right], kind="stable")]
            while len(left) * len(right) > max_product:
                if len(left) >= len(right):
                    left = left[:-1]
                else:
                    right = right[:-1]
            left = np.sort(left)
            right = np.sort(right)
    grid = (left[:, None] * m + right[None, :]).reshape(-1)
    return left, right, grid


def sif_diagonal(ua: torch.Tensor, ug: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """diag((U_A (x) U_G) diag(lam) (U_A (x) U_G)^T), layout k = i*m + j:
    ``(U_A^2) Lam (U_G^2)^T`` flattened, batched over leading dims."""
    lam_mat = lam.reshape(lam.shape[:-1] + (ua.shape[-1], ug.shape[-1]))
    d = (ua * ua) @ lam_mat @ (ug * ug).mT
    return d.reshape(d.shape[:-2] + (-1,))


def _bucket(k: int, limit: int, step: int = 8) -> int:
    """``k`` rounded up to a multiple of ``step``, capped at ``limit``."""
    return min(-(-k // step) * step, limit)


def _pad_indices(idx: np.ndarray, size: int, limit: int) -> np.ndarray:
    """Pad a sorted unique index set to ``size`` with unused indices."""
    if len(idx) == size:
        return idx
    free = np.setdiff1d(np.arange(limit), idx, assume_unique=True)
    return np.concatenate([idx, free[:size - len(idx)]])


def _safe_reg_lambda(multiply, lam: torch.Tensor) -> torch.Tensor:
    """sqrt(multiply * lam), exactly zero where lam is (the bucket's padded
    slots), with no NaN from the square root's slope at 0."""
    pos = lam > 0
    return torch.where(pos, torch.sqrt(multiply * torch.where(
        pos, lam, torch.ones_like(lam))), torch.zeros_like(lam))


def _damped_corr(multiply, add, corr: torch.Tensor) -> torch.Tensor:
    """The damped diagonal D = multiply * max(corr, 0) + add (the clamp:
    the correction of a low-rank part that overshoots the diagonal)."""
    return multiply * corr.clamp_min(0.0) + add


def _khatri_rao(u: torch.Tensor) -> torch.Tensor:
    """Row-wise Khatri-Rao square: [..., n, l] -> [..., n, l*l] with
    entry (i, a*l + b) = u[i, a] * u[i, b]."""
    return (u[..., :, None] * u[..., None, :]).flatten(-2)


def _vtv_gram(ua: torch.Tensor, ug: torch.Tensor, reg_lambda: torch.Tensor,
              inv_corr: torch.Tensor) -> torch.Tensor:
    """vtv = S (V^T diag(c^2) V) S for V = U_A (x) U_G (the low-rank
    columns), c = ``inv_corr`` and S = diag(reg_lambda), batched over
    leading dims. Two Khatri-Rao products, w = (ua (.) ua)^T c^2 [L^2, m]
    and t = w (ug (.) ug) [L^2, M^2], then a permutation to [L*M, L*M]:
    no [L, L, m, M] intermediate."""
    n, l = ua.shape[-2:]
    m, r = ug.shape[-2:]
    lead = ua.shape[:-2]
    c2 = (inv_corr * inv_corr).reshape(lead + (n, m))
    w = _khatri_rao(ua).transpose(-1, -2) @ c2                 # [L*L, m]
    t = w @ _khatri_rao(ug)                                    # [L*L, M*M]
    t = t.reshape(lead + (l, l, r, r)).transpose(-3, -2) \
        .reshape(lead + (l * r, l * r))
    return sym(reg_lambda[..., :, None] * t * reg_lambda[..., None, :])


def _eigh(vtv: torch.Tensor):
    """eigh of the R x R Gram in float64, cast back (``inf_logdet`` takes
    its eigenvalues the same way): MKL's float32 solver
    fails to converge on some of these Grams (rows of the bucket's padded
    slots are exactly zero beside entries of ~1e-24; the fc layer of the
    CPU tests), where the float64 one, numpy and scipy do not."""
    evals, q = torch.linalg.eigh(vtv.double())
    return evals.to(vtv.dtype), q.to(vtv.dtype)


def inf_logdet(ua, ug, reg_lambda, inv_corr) -> torch.Tensor:
    """logdet of D + V S^2 V^T given D^(-1/2) = inv_corr, by the matrix
    determinant lemma: sum log D + logdet(I + vtv) (V's columns are
    orthonormal)."""
    vtv = _vtv_gram(ua, ug, reg_lambda, inv_corr)
    evals = torch.linalg.eigvalsh(vtv.double()).to(vtv.dtype)
    logdet_d = -2.0 * torch.log(inv_corr).sum(-1)
    return logdet_d + torch.log1p(evals.clamp_min(0.0)).sum(-1)


def pre_sampler(ua, ug, reg_lambda, inv_corr) -> torch.Tensor:
    """The Woodbury cache P_c (JAX inf.py:147-174): with
    Y = (I + vtv + (I + vtv)^{1/2})^{-1} from one eigh of the R x R Gram,
    P_c = S Y S, the sampler M = (I - D^-1 V P_c V^T) D^-1/2 has
    covariance inv(D + V S^2 V^T). Batched over leading dims."""
    evals, q = _eigh(_vtv_gram(ua, ug, reg_lambda, inv_corr))
    evals = evals.clamp_min(0.0)                               # PSD guard
    y_diag = 1.0 / (1.0 + evals + torch.sqrt(1.0 + evals))
    l_c = (q * y_diag[..., None, :]) @ q.transpose(-1, -2)
    return reg_lambda[..., :, None] * l_c * reg_lambda[..., None, :]


def _vpv(ua, ug, pre, x):
    """V P_c V^T applied to flat [..., n*m] vectors (batched)."""
    n, l = ua.shape[-2:]
    m, r = ug.shape[-2:]
    lead = x.shape[:-1]
    xq = ua.transpose(-1, -2) @ x.reshape(lead + (n, m)) @ ug    # [L, M]
    qx = (pre @ xq.reshape(lead + (l * r, 1))).reshape(lead + (l, r))
    return (ua @ qx @ ug.transpose(-1, -2)).reshape(lead + (n * m,))


def inf_solve(ua, ug, inv_corr, pre, mat) -> torch.Tensor:
    """``P^{-1} @ mat`` = M (M^T v) with the cached Woodbury pieces;
    ``mat`` is the [out, cols] matrix view."""
    n, m = ua.shape[-2], ug.shape[-2]
    x = mat.transpose(-1, -2).reshape(mat.shape[:-2] + (n * m,))
    u = inv_corr * (x - _vpv(ua, ug, pre, inv_corr * inv_corr * x))
    y0 = inv_corr * u
    y = y0 - inv_corr * inv_corr * _vpv(ua, ug, pre, y0)
    return y.reshape(mat.shape[:-2] + (n, m)).transpose(-1, -2)


def inf_sample(ua, ug, inv_corr, pre, z) -> torch.Tensor:
    """One posterior offset M z from standard-normal ``z`` [..., n*m]
    (JAX inf.py:200-211, the draw taken as an input); [..., out, cols]."""
    n, m = ua.shape[-2], ug.shape[-2]
    y_l = inv_corr * z
    y = y_l - inv_corr * inv_corr * _vpv(ua, ug, pre, y_l)
    return y.reshape(z.shape[:-1] + (n, m)).transpose(-1, -2)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class INF(Estimator):
    """Built from Diagonal + KFAC + EFB outputs (tensors, or arrays of the
    JAX package through ``models.state_from_jax``); ``update(rank)``
    builds the low-rank state, then invert/sample as usual. It runs no
    capture."""

    need_param_grads = need_probe_grads = False

    def __init__(self, model, diags: Dict, kfac_state: Dict, lambdas: Dict,
                 eigvecs: Optional[Dict] = None, **kwargs):
        if not (set(diags) == set(kfac_state) == set(lambdas)):
            raise ValueError("diags/factors/lambdas must cover the same "
                             "layers")
        super().__init__(model, **kwargs)
        self.metas = {n: m for n, m in self.metas.items() if n in diags}
        if not self.metas:
            raise ValueError("diags/factors/lambdas cover no tracked layer")
        keep = {param_key(n, leaf) for n in self.metas
                for leaf in ("weight", "bias")}
        self.mean_params = {k: v for k, v in self.mean_params.items()
                            if k in keep}

        def place(t):
            return torch.as_tensor(t).to(self.device, self.dtype)
        self.diags = {n: place(diags[n]) for n in self.metas}
        self.lambdas = {n: place(lambdas[n]) for n in self.metas}
        check_square_factors(kfac_state, self.metas)
        self._kfac_state = {n: {k: place(kfac_state[n][k]) for k in "ag"}
                            for n in self.metas}
        # eigvecs may be shared from an EFB estimator: the largest layers'
        # eigendecompositions dominate the INF build
        self._eigvecs = None
        if eigvecs is not None:
            missing = set(self.metas) - set(eigvecs)
            if missing:
                raise ValueError(
                    f"shared eigvecs missing layers: {sorted(missing)}")
            for name, fac in self._kfac_state.items():
                for key in ("a", "g"):
                    want = tuple(fac[key].shape)
                    got = tuple(eigvecs[name][key].shape)
                    if got != want:
                        raise ValueError(
                            f"{name}: eigvecs[{key!r}] shape {got} does not "
                            f"match the KFAC factor {want}; were they "
                            "computed from a different state?")
            self._eigvecs = {n: {k: place(eigvecs[n][k]) for k in "ag"}
                             for n in self.metas}

    @property
    def eigvecs(self) -> Dict:
        """The factors' eigenvectors, computed on first use (JAX :274-278)
        unless shared at construction."""
        if self._eigvecs is None:
            self._eigvecs = kfac_eigenvectors(self._kfac_state, self.dtype)
        return self._eigvecs

    def init_state(self):
        return {}

    def _carry(self):
        carry = {"state": self.state, "diags": self.diags,
                 "lambdas": self.lambdas, "_kfac_state": self._kfac_state}
        if self._eigvecs is not None:
            carry["_eigvecs"] = self._eigvecs
        return carry

    def _stack_group(self, meta):
        """The ranks splitting a stacked layer's slabs (None: whole)."""
        if self._plan is None or not meta.stacked or self._whole_view:
            return None
        ax = self._mesh_axes
        axis = ax["expert"] if meta.moe else ax["model"]
        spec = self._plan["diags"][meta.name]
        return self.mesh.group(axis) if spec[0] is not None else None

    @torch.no_grad()
    def update(self, rank: int = 100, max_product: int = 0,
               bucket: int = 8):
        """The low-rank reduction and diagonal correction per layer
        (reference curvatures.py:487-507). ``max_product`` bounds the
        completed index-product size (0: the reference behavior);
        ``bucket`` rounds the index-set sizes up to a multiple, the padded
        slots carrying exactly-zero lambda (``bucket=1``: the reference's
        exact sizes)."""
        state = {}
        for name, meta in self.metas.items():
            # slabs: a stacked layer's depth, a grouped conv's groups; a
            # plain layer is one slab
            depth = (self.diags[name].shape[0] if meta.stacked
                     else meta.groups)
            og = meta.out_features // meta.groups
            ua_full = self.eigvecs[name]["a"].reshape(
                depth, meta.mat_cols, meta.mat_cols)
            ug_full = self.eigvecs[name]["g"].reshape(depth, og, og)
            n, m = ua_full.shape[-1], ug_full.shape[-1]
            lam_vec = self.lambdas[name].reshape(depth, m, n).mT \
                .reshape(depth, -1)
            diag_vec = self.diags[name].reshape(depth, m, n).mT \
                .reshape(depth, -1)
            lam_np = _host(lam_vec)
            sel = [self._select(lam_np[i], n, m, rank, max_product)
                   for i in range(depth)]
            lb = _bucket(max(len(s[0]) for s in sel), n, bucket)
            rb = _bucket(max(len(s[1]) for s in sel), m, bucket)
            group = self._stack_group(meta)
            if group_size(group) > 1:
                # one padded (L, M) over the whole stack's slabs
                sizes = torch.tensor([lb, rb], device=ua_full.device)
                torch.distributed.all_reduce(
                    sizes, torch.distributed.ReduceOp.MAX, group=group)
                lb, rb = (int(v) for v in sizes.tolist())
            # every slab's padded index sets gathered at once (a depthwise
            # conv has a slab per channel)
            left_p = np.stack([_pad_indices(s[0], lb, n) for s in sel])
            right_p = np.stack([_pad_indices(s[1], rb, m) for s in sel])
            mask = np.zeros((depth, lb, rb), np.float32)
            for i, (left, right) in enumerate(sel):
                mask[i, :len(left), :len(right)] = 1.0
            grid = (left_p[:, :, None] * m + right_p[:, None, :]) \
                .reshape(depth, -1)

            def dev(a):
                return torch.from_numpy(a).to(ua_full.device)
            ua = torch.gather(ua_full, 2, dev(left_p)[:, None, :]
                              .expand(depth, n, lb))
            ug = torch.gather(ug_full, 2, dev(right_p)[:, None, :]
                              .expand(depth, m, rb))
            lam = torch.gather(lam_vec, 1, dev(grid)) \
                * dev(mask.reshape(depth, -1)).to(self.dtype)
            corr = diag_vec - sif_diagonal(ua, ug, lam)
            st = {"ua": ua, "ug": ug, "lam": lam, "corr": corr}
            state[name] = st if meta.stacked or is_grouped(meta) \
                else {k: v[0] for k, v in st.items()}
        self.state = state
        if self._plan is not None:
            # the state is built from blocks: a split stack's slabs lead
            self._plan["state"] = {
                name: {k: [self._plan["diags"][name][0]
                           if self.metas[name].stacked else None]
                       + [None] * (v.ndim - 1) for k, v in st.items()}
                for name, st in state.items()}
        return state

    @staticmethod
    def _select(lam_np: np.ndarray, n: int, m: int, rank: int,
                max_product: int):
        """Host-side top-|lambda| index-set selection (JAX :379-393)."""
        p = n * m
        if rank >= p and (max_product <= 0 or p <= max_product):
            return np.arange(n), np.arange(m)
        k = min(rank, p)
        top = np.argpartition(-np.abs(lam_np), k - 1)[:k]
        left = np.unique(top // m)
        right = np.unique(top % m)
        if max_product > 0 and len(left) * len(right) > max_product:
            left, right, _ = dim_reduction(lam_np, n, m, rank, max_product)
        return left, right

    def _shape_groups(self, state):
        """Layers grouped by their (ua, ug) shapes, in meta order: each
        group runs as one batched body (JAX :395-432)."""
        shared = {}
        for i, name in enumerate(self.metas):
            s = state[name]
            shared.setdefault((tuple(s["ua"].shape), tuple(s["ug"].shape)),
                              []).append((i, name))
        return list(shared.values())

    def invert_state(self, state, add, multiply):
        inv = {}
        for members in self._shape_groups(state):
            idx = [i for i, _ in members]
            stack = {k: torch.stack([state[n][k] for _, n in members])
                     for k in ("ua", "ug", "lam", "corr")}
            # per-layer damping against [G, (depth,) ...] stacks
            col = (-1,) + (1,) * (stack["lam"].ndim - 1)
            muls = multiply[idx].reshape(col)
            reg_lambda = _safe_reg_lambda(muls, stack["lam"])
            inv_corr = torch.sqrt(1.0 / _damped_corr(
                muls, add[idx].reshape(col), stack["corr"]))
            pre = pre_sampler(stack["ua"], stack["ug"], reg_lambda, inv_corr)
            for j, (_, name) in enumerate(members):
                inv[name] = {"ua": stack["ua"][j], "ug": stack["ug"][j],
                             "inv_corr": inv_corr[j], "pre": pre[j]}
        return {name: inv[name] for name in self.metas}

    def logdet_state(self, state, add, multiply):
        """logdet of the INF precision D_damped + V S^2 V^T, the matrix the
        Woodbury sampler inverts."""
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, name in enumerate(self.metas):
            s = state[name]
            reg_lambda = _safe_reg_lambda(multiply[i], s["lam"])
            inv_corr = torch.sqrt(1.0 / _damped_corr(multiply[i], add[i],
                                                     s["corr"]))
            tot = tot + inf_logdet(s["ua"], s["ug"], reg_lambda,
                                   inv_corr).sum()
        return tot

    def quad_state(self, state, add, multiply, deltas):
        """delta^T (D + V S^2 V^T) delta: the diagonal part on the flat
        layout plus the squared low-rank projection."""
        tot = torch.zeros((), dtype=self.dtype, device=self.device)
        for i, name in enumerate(self.metas):
            s = state[name]
            # [(depth|g,) cols, out]
            yy = group_rows(self.metas[name], deltas[name]).mT
            y = yy.reshape(s["corr"].shape)
            dcorr = _damped_corr(multiply[i], add[i], s["corr"])
            proj = (s["ua"].mT @ yy @ s["ug"]).reshape(s["lam"].shape)
            tot = tot + (dcorr * y * y).sum() \
                + (multiply[i] * s["lam"] * proj * proj).sum()
        return tot

    def solve_state(self, inv_state, deltas):
        out = {}
        for name, meta in self.metas.items():
            s = inv_state[name]
            out[name] = ungroup_rows(meta, inf_solve(
                s["ua"], s["ug"], s["inv_corr"], s["pre"],
                group_rows(meta, deltas[name])))
        return out

    def noise_shapes(self) -> Dict[str, tuple]:
        """[(depth,) cols*out]; [g, cols*out/g] for a grouped conv, one
        draw per group (JAX splits the layer's key per group, :508-519)."""
        return {name: ((m.stacked,) if m.stacked else
                       (m.groups,) if is_grouped(m) else ())
                + (m.mat_cols * m.out_features // m.groups,)
                for name, m in self.metas.items()}

    def sample_state(self, inv_state, noise) -> Dict[str, torch.Tensor]:
        """Same-shape layers sample through one batched body; each layer
        keeps its own draw ``noise[name]`` (JAX splits the per-layer keys
        in meta order first, :500-504)."""
        out = {}
        for members in self._shape_groups(inv_state):
            names = [n for _, n in members]
            s = {k: torch.stack([inv_state[n][k] for n in names])
                 for k in ("ua", "ug", "inv_corr", "pre")}
            z = torch.stack([noise[n] for n in names])
            res = inf_sample(s["ua"], s["ug"], s["inv_corr"], s["pre"], z)
            for j, name in enumerate(names):
                out[name] = ungroup_rows(self.metas[name], res[j])
        return {name: out[name] for name in self.metas}
