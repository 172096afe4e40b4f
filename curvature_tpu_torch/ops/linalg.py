"""Damped inversion of Kronecker factors.

Port of ``curvature_tpu/ops/linalg.py`` (``sym``, ``chol_inv``,
``chol_logdet``, ``damped_inverse_cholesky``); all batched over leading
dims.
"""
import torch


def sym(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T) / 2."""
    return (a + a.transpose(-1, -2)) / 2.0


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
