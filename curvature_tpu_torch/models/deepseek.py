"""DeepSeek-V3 decoders (Hugging Face ``DeepseekV3ForCausalLM`` layout):
multi-head latent attention and sigmoid-routed mixture-of-experts FFNs
with shared experts, as Moonlight-16B-A3B, Kimi-K2 and DeepSeek-V3 run
them. Port-only: the JAX package has no such model.

A layer is ``x += o_proj(MLA(input_layernorm(x)))`` then ``x +=
mlp(post_attention_layernorm(x))``:

- MLA without a query low-rank: ``q_proj`` gives each head ``[q_nope |
  q_pe]``; ``kv_a_proj_with_mqa`` gives ``[c_kv | k_pe]``, ``k_pe`` one head
  shared by all; ``kv_b_proj(kv_a_layernorm(c_kv))`` each head's ``[k_nope
  | v]``. RoPE (interleaved, nn/layers.py) on ``q_pe`` and ``k_pe``; causal
  ``softmax(Q K^T / sqrt(nope + rope)) V`` through
  ``F.scaled_dot_product_attention`` in the input's dtype, which never holds
  the ``[B, H, T, T]`` probabilities.
- The first ``first_k_dense_replace`` layers' FFN is the SwiGLU
  ``down_proj(silu(gate_proj h) * up_proj h)``; the others' is an
  ``nn.MoE`` (sigmoid scores, the correction bias for the selection, top-k
  weights normalized and scaled, gated experts) named ``mlp.experts``,
  plus the shared experts ``mlp.shared_experts``, one SwiGLU of width
  ``moe_intermediate_size * n_shared_experts`` that sees every token.

Every projection is a tracked ``Dense`` under its Hugging Face module path
(``model.layers.{i}.self_attn.q_proj``); the routed experts are three
stacked ``Experts`` (``model.layers.{i}.mlp.experts.gate_proj`` ``[held,
out, in]``); the router, the correction bias, the norms and the embedding
are untracked. ``held=(start, count)`` keeps that block of every MoE
layer's experts, a card of an expert-parallel host (nn/layers.py ``MoE``).
The layers are unrolled (the experts are already stacked), and routed
dispatch takes data-dependent row counts, so ensemble forwards run as a
loop (``vmap_ensemble``).
"""
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from curvature_tpu_torch.nn import (
    Context, Dense, MoE, RMSNorm, apply_rope_interleaved, is_tracked,
    rope_cos_sin)
from curvature_tpu_torch.utils.device import resolve_device


class SwiGLU(nn.Module):
    """``down_proj(silu(gate_proj x) * up_proj x)``, three tracked
    bias-free ``Dense``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.gate_proj = Dense(dim, hidden, bias=False)
        self.up_proj = Dense(dim, hidden, bias=False)
        self.down_proj = Dense(hidden, dim, bias=False)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.down_proj(F.silu(self.gate_proj(x, ctx))
                              * self.up_proj(x, ctx), ctx)


class MLAttention(nn.Module):
    """Multi-head latent attention without a query low-rank (module
    docstring)."""

    def __init__(self, dim: int, heads: int, qk_nope: int, qk_rope: int,
                 v_dim: int, kv_rank: int, eps: float):
        super().__init__()
        self.heads, self.qk_nope, self.qk_rope = heads, qk_nope, qk_rope
        self.v_dim, self.kv_rank = v_dim, kv_rank
        self.q_proj = Dense(dim, heads * (qk_nope + qk_rope), bias=False)
        self.kv_a_proj_with_mqa = Dense(dim, kv_rank + qk_rope, bias=False)
        self.kv_a_layernorm = RMSNorm(kv_rank, eps)
        self.kv_b_proj = Dense(kv_rank, heads * (qk_nope + v_dim),
                               bias=False)
        self.o_proj = Dense(heads * v_dim, dim, bias=False)

    def forward(self, h, cos, sin, ctx: Optional[Context] = None):
        b, t, _ = h.shape
        hd, nope, rope = self.heads, self.qk_nope, self.qk_rope
        q = self.q_proj(h, ctx).reshape(b, t, hd, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c = self.kv_a_proj_with_mqa(h, ctx)
        c_kv, k_pe = c.split([self.kv_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv), ctx).reshape(
            b, t, hd, nope + self.v_dim).transpose(1, 2)
        k_nope, v = kv.split([nope, self.v_dim], dim=-1)
        q_pe = apply_rope_interleaved(q_pe, cos, sin)
        k_pe = apply_rope_interleaved(k_pe[:, None], cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, hd, t, rope)], dim=-1)
        o = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0 / math.sqrt(nope + rope))
        return self.o_proj(o.transpose(1, 2).reshape(b, t, hd * self.v_dim),
                           ctx)


class DeepseekMoE(nn.Module):
    """The routed experts (an ``nn.MoE``) plus the shared experts."""

    def __init__(self, dim: int, hidden: int, experts: int, shared: int,
                 top_k: int, routed_scale: float, norm_topk_prob: bool,
                 held: Optional[Tuple[int, int]]):
        super().__init__()
        self.experts = MoE(dim, dim, experts, hidden=hidden, top_k=top_k,
                           scoring="sigmoid", gated=True,
                           norm_topk_prob=norm_topk_prob,
                           routed_scale=routed_scale, held=held)
        self.shared_experts = SwiGLU(dim, hidden * shared)

    def forward(self, x, ctx: Optional[Context] = None):
        return self.experts(x, ctx) + self.shared_experts(x, ctx)


class DecoderLayer(nn.Module):
    def __init__(self, attn: MLAttention, mlp: nn.Module, dim: int,
                 eps: float):
        super().__init__()
        self.input_layernorm = RMSNorm(dim, eps)
        self.self_attn = attn
        self.post_attention_layernorm = RMSNorm(dim, eps)
        self.mlp = mlp

    def forward(self, x, cos, sin, ctx: Optional[Context] = None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, ctx)
        return x + self.mlp(self.post_attention_layernorm(x), ctx)


class DeepseekV3(nn.Module):
    """Token ids [B, T] -> logits [B, T, vocab] (module docstring); the
    keyword sizes are the Hugging Face configuration's."""

    vmap_ensemble = False

    def __init__(self, vocab_size: int, hidden_size: int,
                 num_hidden_layers: int, num_attention_heads: int,
                 qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, kv_lora_rank: int, intermediate_size: int,
                 moe_intermediate_size: int, n_routed_experts: int,
                 n_shared_experts: int, num_experts_per_tok: int,
                 first_k_dense_replace: int = 1,
                 routed_scaling_factor: float = 1.0,
                 norm_topk_prob: bool = True, rms_norm_eps: float = 1e-6,
                 rope_theta: float = 10000.0,
                 held: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.qk_rope = qk_rope_head_dim
        self.rope_theta = rope_theta
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(vocab_size, hidden_size)
        nn.init.normal_(self.model.embed_tokens.weight, std=0.02)
        layers = []
        for i in range(num_hidden_layers):
            attn = MLAttention(hidden_size, num_attention_heads,
                               qk_nope_head_dim, qk_rope_head_dim,
                               v_head_dim, kv_lora_rank, rms_norm_eps)
            mlp = (SwiGLU(hidden_size, intermediate_size)
                   if i < first_k_dense_replace
                   else DeepseekMoE(hidden_size, moe_intermediate_size,
                                    n_routed_experts, n_shared_experts,
                                    num_experts_per_tok,
                                    routed_scaling_factor, norm_topk_prob,
                                    held))
            layers.append(DecoderLayer(attn, mlp, hidden_size, rms_norm_eps))
        self.model.layers = nn.ModuleList(layers)
        self.model.norm = RMSNorm(hidden_size, rms_norm_eps)
        self.lm_head = Dense(hidden_size, vocab_size, bias=False)
        for name, m in self.named_modules():
            if isinstance(m, MoE):
                m.set_name(name)
            elif isinstance(m, Dense) and m.name is None:
                m.name = name

    @property
    def metas(self):
        """Tracked layers in forward order."""
        return {m.name: m.meta for m in self.modules() if is_tracked(m)}

    def forward(self, tokens, ctx: Optional[Context] = None):
        t = tokens.shape[1]
        x = self.model.embed_tokens(tokens)
        cos, sin = rope_cos_sin(torch.arange(t, device=tokens.device),
                                self.qk_rope, self.rope_theta, x.dtype)
        for layer in self.model.layers:
            x = layer(x, cos, sin, ctx)
        return self.lm_head(self.model.norm(x), ctx)


def deepseek_v3(device=None, **config) -> DeepseekV3:
    """Build from Hugging Face configuration keys on ``device`` (CUDA
    unless ``"cpu"`` is passed)."""
    return DeepseekV3(**config).to(resolve_device(device))


#: Moonlight-16B-A3B's published sizes (Hugging Face
#: moonshotai/Moonlight-16B-A3B config.json)
MOONLIGHT_16B_A3B = dict(
    vocab_size=163840, hidden_size=2048, num_hidden_layers=27,
    num_attention_heads=16, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, kv_lora_rank=512, intermediate_size=11264,
    moe_intermediate_size=1408, n_routed_experts=64, n_shared_experts=2,
    num_experts_per_tok=6, first_k_dense_replace=1,
    routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5,
    rope_theta=50000.0)


def moonlight_16b_a3b(num_classes: int = 163840, num_hidden_layers: int = 27,
                      held: Optional[Tuple[int, int]] = None,
                      device=None) -> DeepseekV3:
    """Moonlight-16B-A3B at its published widths (``num_classes`` =
    vocab), ``num_hidden_layers`` deep, holding the experts ``held``."""
    return deepseek_v3(device, **dict(
        MOONLIGHT_16B_A3B, vocab_size=num_classes,
        num_hidden_layers=num_hidden_layers, held=held))


def deepseek_v3_tiny(num_classes: int = 128, device=None,
                     **kw) -> DeepseekV3:
    """A DeepSeek-V3 test model: hidden 64, 2 heads (nope 16, rope 8, v
    16), kv rank 32, 8 experts of width 32 with one shared, top-3, one
    dense and two MoE layers (``kw`` overrides any key)."""
    return deepseek_v3(device, **dict(dict(
        vocab_size=num_classes, hidden_size=64, num_hidden_layers=3,
        num_attention_heads=2, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
        moe_intermediate_size=32, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=3, first_k_dense_replace=1,
        routed_scaling_factor=2.446, norm_topk_prob=True, rms_norm_eps=1e-5,
        rope_theta=50000.0), **kw))
