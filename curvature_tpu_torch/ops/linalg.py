"""Damped inversion and eigendecomposition of Kronecker factors.

Port of ``curvature_tpu/ops/linalg.py`` (``kron``, ``sym``, ``diag_add``,
``eigh_sym``, ``chol_inv``, ``chol_logdet``, ``damped_inverse_cholesky``,
``group_by_shape``, ``ungroup``, ``grouped_gram_packed``); all batched
over leading dims.
"""
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of two matrices (the reference's einsum ``kron``,
    utils.py:288-310)."""
    m, n = a.shape
    p, q = b.shape
    return (a[:, None, :, None] * b[None, :, None, :]).reshape(m * p, n * q)


def sym(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T) / 2."""
    return (a + a.transpose(-1, -2)) / 2.0


def diag_add(a: torch.Tensor, value) -> torch.Tensor:
    """A + value * I for the trailing square dims."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return a + torch.as_tensor(value, dtype=a.dtype, device=a.device) * eye


def eigh_sym(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of ``A + A^T`` (a *sum*, as the reference's
    ``get_eigenvectors``, utils.py:56-58: twice the eigenvalues, the same
    eigenvectors). Returns (eigenvalues ascending, eigenvectors as
    columns)."""
    return torch.linalg.eigh(a + a.transpose(-1, -2))


def chol_inv(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``inv(A)`` for SPD ``A``: with A = L L^T,
    inv(A) = L^-T L^-1, formed by one triangular solve, then one final
    Cholesky (the reference's ``A.inverse().cholesky()`` chain)."""
    l = torch.linalg.cholesky(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    linv = torch.linalg.solve_triangular(l, eye.expand_as(a), upper=False)
    a_inv = linv.transpose(-1, -2) @ linv
    return torch.linalg.cholesky(sym(a_inv))


def chol_logdet(a: torch.Tensor) -> torch.Tensor:
    """``log det`` of SPD ``a`` via Cholesky, one per leading-dim block."""
    l = torch.linalg.cholesky(sym(a))
    return 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)


def damped_inverse_cholesky(factor: torch.Tensor, add, multiply
                            ) -> torch.Tensor:
    """chol(inv(sym(sqrt(multiply) * F + sqrt(add) * I))), KFAC's split
    damping (reference curvatures.py:368-379)."""
    s = torch.sqrt(torch.as_tensor(multiply, dtype=factor.dtype,
                                   device=factor.device))
    n = torch.sqrt(torch.as_tensor(add, dtype=factor.dtype,
                                   device=factor.device))
    s = s.reshape(s.shape + (1,) * (factor.ndim - s.ndim))
    n = n.reshape(n.shape + (1,) * (factor.ndim - n.ndim))
    eye = torch.eye(factor.shape[-1], dtype=factor.dtype,
                    device=factor.device)
    return chol_inv(sym(s * factor + n * eye))


def group_by_shape(arrays: Dict[str, torch.Tensor]
                   ) -> List[Tuple[List[str], torch.Tensor]]:
    """Group a dict of tensors by (shape, dtype) for batched linalg:
    ``(names, stacked)`` pairs, ``stacked`` with a new leading axis over
    ``names``, in first-seen order."""
    groups: Dict[tuple, List[str]] = defaultdict(list)
    for name, arr in arrays.items():
        groups[(tuple(arr.shape), arr.dtype)].append(name)
    return [(names, torch.stack([arrays[n] for n in names]))
            for names in groups.values()]


def ungroup(groups: Sequence[Tuple[List[str], torch.Tensor]]
            ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`group_by_shape` after a batched op."""
    return {n: stacked[i] for names, stacked in groups
            for i, n in enumerate(names)}


def grouped_gram_packed(t: torch.Tensor, dtype=torch.float32,
                        lane: int = 128) -> torch.Tensor:
    """Per-group token Grams ``[g, c, c]`` of tokens ``[N, g, c]``, with
    P = lane // c adjacent groups packed into one lane-wide operand (JAX
    linalg.py:130): one ``[P*c, P*c]`` Gram per pack, its P diagonal
    blocks kept. The group axis is zero-padded to a multiple of P (zero
    tokens give exactly-zero Grams, dropped). The same token products as
    the plain batched ``ngi,ngj->gij``, accumulated in ``dtype``; as in
    JAX it is the measured alternative, on no estimator's path
    (``KFAC._a_factor`` takes the plain batched product)."""
    n, g, c = t.shape
    t = t.to(dtype)
    p = min(g, max(1, lane // c))
    if p <= 1:
        return torch.einsum("ngi,ngj->gij", t, t)
    g_pad = -(-g // p) * p
    if g_pad != g:
        t = torch.nn.functional.pad(t, (0, 0, 0, g_pad - g))
    tp = t.reshape(n, g_pad // p, p * c).transpose(0, 1)     # [k, n, p*c]
    packed = tp.mT @ tp
    blocks = packed.reshape(g_pad // p, p, c, p, c)
    idx = torch.arange(p, device=t.device)
    out = blocks[:, idx, :, idx, :]                 # [p, g_pad/p, c, c]
    return out.transpose(0, 1).reshape(g_pad, c, c)[:g]
