"""GPT-2 causal language models (Hugging Face ``GPT2LMHeadModel`` layout).

Port of ``curvature_tpu/models/gpt.py``. Every projection (the packed
``c_attn`` qkv, ``c_proj``, both MLP linears, the bias-free ``lm_head``)
is a tracked ``Dense``; the Fisher is the per-token categorical one
(``loss='lm'``, estimators/capture.py). With ``scan_blocks=True`` the
block stack is a :class:`~curvature_tpu_torch.nn.ScanBlocks` with stacked
``[depth, ...]`` parameters named ``h.attn.c_attn`` etc., the JAX stack's
names; unrolled, the blocks are ``h.{i}``. Attention is the explicit
masked softmax the JAX model computes (``finfo.min`` off the causal
triangle), GELU the tanh approximation (HF's ``gelu_new``): plain torch
ops, as JAX has no attention kernel.

Under a capture context whose token dim is split over ranks (``ctx.
seq_group``, a mesh's seq axis) each rank runs its block of positions:
the position ids start at ``ctx.seq_offset``, and the attention gathers
every rank's keys and values (:func:`~curvature_tpu_torch.parallel.mesh.
gather_partial`, whose backward sums their cotangents over the ranks) and
masks at global positions, so each rank's outputs are those of its tokens
in the whole sequence.

:func:`convert_gpt2_state_dict` maps a Hugging Face state dict (``Conv1D``
weights ``[in, out]``) to this port's state dict (``Linear`` weights
``[out, in]``), untying the head from ``wte`` as JAX does.

:class:`GPT2MoEBlock` (``gpt2_moe_custom``, ``gpt2_moe_tiny``) replaces
the MLP by a Switch-style ``nn.MoE`` (top-1-routed bias-free two-layer
experts, ``h.{i}.moe.fc1``/``fc2`` stacked ``[E, ...]`` layers and the
untracked ``h.{i}.moe.router``; JAX gpt.py:97-170). Its experts are
already stacked, so the MoE model runs unrolled: ``scan_blocks=True``
raises, as in JAX.
"""
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.nn import (
    Context, Dense, LayerNorm, MoE, ScanBlocks, is_tracked)
from curvature_tpu_torch.parallel.mesh import gather_partial
from curvature_tpu_torch.utils.device import resolve_device


def _gelu_new(x):
    """HF's ``gelu_new`` == the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class CausalSelfAttention(nn.Module):
    """Masked multi-head self-attention with HF-packed ``c_attn``/
    ``c_proj``, both tracked and stamped with the head count."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        if dim % heads:
            raise ValueError("dim must be divisible by heads")
        self.heads = heads
        self.c_attn = Dense(dim, 3 * dim)
        self.c_proj = Dense(dim, dim)
        self.c_attn.heads = self.c_proj.heads = heads

    def forward(self, x, ctx: Optional[Context] = None):
        b, t, e = x.shape
        h = self.heads
        d = e // h
        qkv = self.c_attn(x, ctx)                        # [B, T, 3E]
        q, k, v = qkv.split(e, dim=-1)
        q = q.reshape(b, t, h, d).transpose(1, 2)        # [B, H, T, d]
        k = k.reshape(b, t, h, d).transpose(1, 2)
        v = v.reshape(b, t, h, d).transpose(1, 2)
        group = ctx.seq_group if ctx is not None else None
        if group is not None:
            # every rank's keys and values; queries at global positions
            k = gather_partial(k, group, 2)
            v = gather_partial(v, group, 2)
        start = ctx.seq_offset if ctx is not None else 0
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        pos = torch.arange(k.shape[2], device=x.device)
        causal = pos[None, :] <= (start + pos[:t])[:, None]  # query >= key
        attn = attn.masked_fill(~causal, torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn, dim=-1)
        o = (attn @ v).transpose(1, 2).reshape(b, t, e)
        return self.c_proj(o, ctx)


class MLP(nn.Module):
    """``c_fc`` -> gelu -> ``c_proj`` (the ``mlp`` of the HF names)."""

    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = Dense(dim, 4 * dim)
        self.c_proj = Dense(4 * dim, dim)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.c_proj(_gelu_new(self.c_fc(x, ctx)), ctx)


class GPT2Block(nn.Module):
    """Pre-LN decoder block: x += attn(ln_1(x)); x += mlp(ln_2(x))."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = CausalSelfAttention(dim, heads)
        self.ln_2 = LayerNorm(dim)
        self.mlp = MLP(dim)

    def forward(self, x, ctx: Optional[Context] = None):
        x = x + self.attn(self.ln_1(x), ctx)
        return x + self.mlp(self.ln_2(x), ctx)


class GPT2MoEBlock(nn.Module):
    """Pre-LN decoder block with a Switch-style MoE FFN: x += attn(ln_1(x));
    x += moe(ln_2(x)), the experts two-layer (hidden 4 * dim, gelu_new)."""

    def __init__(self, dim: int, heads: int, experts: int):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.attn = CausalSelfAttention(dim, heads)
        self.ln_2 = LayerNorm(dim)
        self.moe = MoE(dim, dim, experts, hidden=4 * dim,
                       activation=_gelu_new)

    def forward(self, x, ctx: Optional[Context] = None):
        x = x + self.attn(self.ln_1(x), ctx)
        return x + self.moe(self.ln_2(x), ctx)


class GPT2(nn.Module):
    """Token ids [B, T] -> logits [B, T, vocab]; ``experts`` > 0 makes
    every block a :class:`GPT2MoEBlock`. ``splits_tokens``: the forward
    runs a block of positions under a context's ``seq_group`` (module
    docstring)."""

    splits_tokens = True

    def __init__(self, vocab: int, dim: int, depth: int, heads: int,
                 max_len: int, scan_blocks: bool = False, experts: int = 0):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        self.max_len = max_len
        # routed experts take data-dependent row counts, which vmap cannot
        # batch over members: the ensemble forwards run as a loop
        self.vmap_ensemble = not experts
        self.wte = nn.Embedding(vocab, dim)
        self.wpe = nn.Embedding(max_len, dim)
        nn.init.normal_(self.wte.weight, std=0.02)
        nn.init.normal_(self.wpe.weight, std=0.01)

        def block(name=None):
            return (GPT2MoEBlock(dim, heads, experts) if experts
                    else GPT2Block(dim, heads))
        if scan_blocks:
            self.h = ScanBlocks(block, depth, "h",
                                [f"h.{i}" for i in range(depth)])
        else:
            self.h = nn.ModuleList(block() for _ in range(depth))
        self.ln_f = LayerNorm(dim)
        self.lm_head = Dense(dim, vocab, bias=False)
        for name, m in self.named_modules():
            if isinstance(m, Dense):
                m.name = name
            elif isinstance(m, MoE):
                m.set_name(name)

    @property
    def metas(self):
        """Tracked layers in forward order; a stack's are stacked."""
        return {m.name: m.meta for m in self.modules() if is_tracked(m)}

    @property
    def scan_groups(self) -> Dict:
        return ({"h": self.h.scan_group} if isinstance(self.h, ScanBlocks)
                else {})

    def forward(self, tokens, ctx: Optional[Context] = None):
        t = tokens.shape[1]
        t0 = ctx.seq_offset if ctx is not None else 0
        x = self.wte(tokens) + self.wpe.weight[None, t0:t0 + t, :]
        if isinstance(self.h, ScanBlocks):
            x = self.h(x, ctx)
        else:
            for blk in self.h:
                x = blk(x, ctx)
        return self.lm_head(self.ln_f(x), ctx)


def gpt2_custom(vocab: int, dim: int, depth: int, heads: int,
                max_len: int = 1024, scan_blocks: bool = False,
                device=None) -> GPT2:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed)."""
    device = resolve_device(device)
    return GPT2(vocab, dim, depth, heads, max_len, scan_blocks).to(device)


def gpt2_moe_custom(vocab: int, dim: int, depth: int, heads: int,
                    experts: int = 8, max_len: int = 1024,
                    scan_blocks: bool = False, device=None) -> GPT2:
    """GPT-2 trunk whose every block takes the Switch-style MoE FFN, on
    ``device`` (CUDA unless ``"cpu"`` is passed); ``scan_blocks=True``
    raises (the experts are stacked already)."""
    device = resolve_device(device)
    return GPT2(vocab, dim, depth, heads, max_len, scan_blocks,
                experts=experts).to(device)


def gpt2_moe_tiny(num_classes: int = 256, experts: int = 4,
                  max_len: int = 128, scan_blocks: bool = False,
                  device=None) -> GPT2:
    """2-layer Switch-style MoE test model (per-expert curvature
    factors)."""
    return gpt2_moe_custom(num_classes, 64, 2, 2, experts, max_len,
                           scan_blocks, device)


def gpt2_tiny(num_classes: int = 256, scan_blocks: bool = False,
              max_len: int = 128, device=None) -> GPT2:
    """2-layer test/smoke model (byte-level vocab by default)."""
    return gpt2_custom(num_classes, 64, 2, 2, max_len, scan_blocks, device)


def gpt2(num_classes: int = 50257, scan_blocks: bool = False,
         max_len: int = 1024, device=None) -> GPT2:
    """GPT-2 124M: 12 layers, 12 heads, dim 768 (``num_classes`` =
    vocab)."""
    return gpt2_custom(num_classes, 768, 12, 12, max_len, scan_blocks,
                       device)


def gpt2_medium(num_classes: int = 50257, scan_blocks: bool = False,
                max_len: int = 1024, device=None) -> GPT2:
    return gpt2_custom(num_classes, 1024, 24, 16, max_len, scan_blocks,
                       device)


def gpt2_large(num_classes: int = 50257, scan_blocks: bool = False,
               max_len: int = 1024, device=None) -> GPT2:
    return gpt2_custom(num_classes, 1280, 36, 20, max_len, scan_blocks,
                       device)


def gpt2_xl(num_classes: int = 50257, scan_blocks: bool = False,
            max_len: int = 1024, device=None) -> GPT2:
    """GPT-2 1.5B: 48 layers."""
    return gpt2_custom(num_classes, 1600, 48, 25, max_len, scan_blocks,
                       device)


def convert_gpt2_state_dict(state_dict: Dict, model: Optional[GPT2] = None
                            ) -> Dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel``/``GPT2Model`` state dict -> this port's state
    dict (f32 CPU tensors), for the unrolled model; pass a scanned
    ``model`` to get its stacked ``h.*`` entries (per-depth tensors
    stacked along a new leading axis).

    * the ``transformer.`` prefix is stripped;
    * ``Conv1D`` weights ``[in, out]`` transpose to ``Linear`` ``[out,
      in]``; LayerNorm ``weight``/``bias`` carry straight across;
    * the causal-mask buffers (``h.{i}.attn.bias`` / ``.masked_bias``) are
      dropped (the mask is structural here);
    * ``lm_head.weight`` (``Linear`` ``[V, E]``) copies; when absent (HF
      stores only the tied ``wte``) the head is untied from ``wte``.
    """
    def _t(v):
        v = v.detach().cpu() if torch.is_tensor(v) \
            else torch.from_numpy(np.asarray(v))
        return v.float().contiguous()

    sd: Dict[str, torch.Tensor] = {}
    for name, tensor in state_dict.items():
        if name.startswith("transformer."):
            name = name[len("transformer."):]
        parts = name.split(".")
        if parts[-2:] in (["attn", "bias"], ["attn", "masked_bias"]):
            continue                      # causal-mask buffers
        arr = _t(tensor)
        if name in ("wte.weight", "wpe.weight", "lm_head.weight") \
                or parts[-2] in ("ln_1", "ln_2", "ln_f") \
                or parts[-1] == "bias":
            sd[name] = arr
        elif parts[-1] == "weight":       # Conv1D [in, out]
            sd[name] = arr.T.contiguous()
        else:
            raise ValueError(f"unrecognized GPT-2 tensor {name!r}")
    sd.setdefault("lm_head.weight", sd["wte.weight"].clone())   # untie
    if model is not None and isinstance(model.h, ScanBlocks):
        depth = model.h.depth
        for pname in model.h.param_names:
            per = [sd.pop(f"h.{i}.{pname}") for i in range(depth)]
            sd[f"h.{pname}"] = torch.stack(per)
    return sd


def seeded_gpt2(model: GPT2, seed: int) -> Dict:
    """Random JAX-layout numpy variables for a GPT-2 from a numpy seed:
    N(0, 0.02) kernels (``[depth, in, out]`` in a stack, ``[E, in, out]``
    for the experts, ``[in, E]`` for a router) and ``wte``,
    N(0, 0.01) ``wpe`` (the JAX model's init scales), N(0, 0.01) biases,
    LayerNorm scales U(0.8, 1.2) and biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def normal(std, shape):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    params = {"wte": {"weight": normal(0.02, (model.vocab, model.dim))},
              "wpe": {"weight": normal(0.01, (model.max_len, model.dim))}}
    for name, m in model.named_modules():
        if isinstance(m, Dense):
            w = m.weight
            lead = tuple(w.shape[:-2])
            params[name] = {"kernel": normal(0.02, lead + (w.shape[-1],
                                                           w.shape[-2]))}
            if m.bias is not None:
                params[name]["bias"] = normal(0.01, tuple(m.bias.shape))
        elif isinstance(m, nn.Linear):
            params[name] = {"kernel": normal(0.02,
                                             tuple(m.weight.shape[::-1]))}
        elif isinstance(m, LayerNorm):
            shape = tuple(m.weight.shape)
            params[name] = {
                "scale": rng.uniform(0.8, 1.2, shape).astype(np.float32),
                "bias": normal(0.05, shape)}
    return {"params": params, "batch_stats": {}}
