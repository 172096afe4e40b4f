"""KFAC's token Grams behind one entry, :func:`factor_gram`.

The port's own module: JAX's Grams are einsums inside its kfac.py, products
it leaves to XLA (no Pallas kernel). Every token Gram of the port's KFAC
comes here: the ``stacked``, ``patches`` (every dense layer too),
``plain``, ``grouped``, ``gblock``, split and ``stack_grams`` Grams, and
both of a ``routed`` layer's. The patch and correlation kernels' Grams and
a column-parallel layer's ``rows`` product ``g[..., rows]^T g`` (not
symmetric) stay with their routes in kfac.py.

On a CUDA float32 input whose Gram is f32, with ``use_kernels`` on and
above the measured gate (``ops/cuda/sym_gram.batched_gate``), a Gram takes
the port's 3xTF32 symmetric kernel (``sym_gram_batched``): one pre-pass
and one Gram launch for a whole depth stack, group or block set, or for
all of an MoE layer's held experts over their row ranges, within ~2^-21 of
the f32 products, as the patch and correlation kernels. Anything else (a
CPU tensor, bf16 operands, ``use_kernels=False``, a Gram below the gate)
is a strict-f32 ``a^T a`` matmul of the operands upcast to the Gram's
dtype: bf16 x bf16 is exact in f32, where a bf16-output matmul would round
the result. :func:`takes_kernel` makes that decision, once a Gram.

A bias's ones column is appended here, never by the caller: the kernel's
pre-pass writes it (1.0 as hi = 1, lo = 0, exactly the split of a 1.0 read
from memory), the matmul concatenates it. JAX zero-pads the column count
of its ``stack_grams`` buckets to a multiple of 128 for the MXU; neither
path here needs such help, and nothing pads.

Each ``factor`` span open around a Gram gets ``gram``: ``sym`` (with the
Gram's ``gram_shape``, its segments, rows and F) or ``matmul``
(:func:`gram_label`); KFAC writes the other kernel routes' ``corr``,
``patch`` and ``tap``, and a ``stack_grams`` span lists the
``gram_shapes`` of its buckets that took the kernel.
"""
import math

import torch

from curvature_tpu_torch.ops.cuda.sym_gram import (
    batched_gate, sym_gram_batched)
from curvature_tpu_torch.utils import monitor

#: tokens per chunk of a batched matmul Gram, and the most partial-product
#: entries its chunks may hold at once (:func:`_matmul_gram`)
GRAM_CHUNK, GRAM_CHUNK_ENTRIES = 1024, 1 << 26


def takes_kernel(t: torch.Tensor, dtype, kernels: bool, shape) -> bool:
    """Whether a Gram of ``t`` in ``dtype`` takes the 3xTF32 symmetric
    kernel: ``kernels`` (``KFAC.use_kernels``) on, ``t`` a CUDA float32
    tensor, an f32 Gram, and its ``shape`` (segments, rows, F) past
    :func:`batched_gate`."""
    return (kernels and t.is_cuda and t.dtype == torch.float32
            and dtype == torch.float32 and batched_gate(*shape))


def gram_label(t: torch.Tensor, dtype, kernels: bool, *, ones: bool = False,
               offsets=None) -> dict:
    """The ``factor`` span attributes of :func:`factor_gram` on these
    arguments: ``gram`` ``sym`` and the Gram's ``gram_shape`` (segments,
    rows, F) where :func:`takes_kernel` holds, else ``gram`` ``matmul``."""
    segments = (len(offsets) - 1 if offsets is not None
                else math.prod(t.shape[:-2]))
    shape = (segments, math.prod(t.shape[:-1]), t.shape[-1] + ones)
    if takes_kernel(t, dtype, kernels, shape):
        return {"gram": "sym", "gram_shape": shape}
    return {"gram": "matmul"}


def factor_gram(t: torch.Tensor, dtype, kernels: bool, *, ones: bool = False,
                offsets=None) -> torch.Tensor:
    """``t^T t`` in ``dtype`` over the last two dims of ``t[..., n, F]``,
    one Gram a leading index (a transposed view read as it is); with
    ``offsets`` (host ints), one Gram of each row segment
    ``offsets[e]:offsets[e + 1]`` of the second-to-last dim over every
    leading index (``[segments, F, F]``). ``ones`` appends a ones column
    to every row first. The kernel where :func:`takes_kernel` holds, else
    the matmul; the ``factor`` span open around it gets
    :func:`gram_label`."""
    label = gram_label(t, dtype, kernels, ones=ones, offsets=offsets)
    monitor.annotate("factor", **label)
    f = t.shape[-1]
    if label["gram"] == "sym":
        if offsets is None:
            return sym_gram_batched(t, ones=ones)
        # a segment's rows of the S samples made adjacent (a copy for S > 1)
        s = math.prod(t.shape[:-2])
        return sym_gram_batched(
            t.reshape(s, -1, f).transpose(0, 1).reshape(-1, f),
            [s * o for o in offsets], ones)
    if ones:
        t = torch.cat([t, t.new_ones(t.shape[:-1] + (1,))], dim=-1)
    if offsets is not None:
        return torch.stack([
            _matmul_gram(t[..., o0:o1, :].reshape(-1, f + ones), dtype)
            for o0, o1 in zip(offsets, offsets[1:])])
    return _matmul_gram(t, dtype)


def _matmul_gram(t: torch.Tensor, dtype) -> torch.Tensor:
    """The strict-f32 matmul Gram. A batched input's token axis is cut
    into chunks of about GRAM_CHUNK (as many as GRAM_CHUNK_ENTRIES allow)
    whose Grams are summed: a batched f32 GEMM sums its whole token axis
    in one pass, which left ResNet-50's 12,544-50,176-token G Grams
    4.7e-5 of max off one GEMM per layer on an H100 (5.3e-6 in chunks).
    Zero rows pad the last chunk and add nothing."""
    *lead, n, f = t.shape
    c = max(1, min(-(-n // GRAM_CHUNK),
                   GRAM_CHUNK_ENTRIES // (math.prod(lead) * f * f))) \
        if lead else 1
    if c > 1:
        size = -(-n // c)
        t = torch.nn.functional.pad(t, (0, 0, 0, c * size - n)).reshape(
            *lead, c, size, f)
    t = t.to(dtype)
    gram = t.mT @ t
    return gram.sum(-3) if c > 1 else gram
