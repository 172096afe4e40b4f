"""GPT-2 (Radford et al., 2019) as Hugging Face's ``GPT2LMHeadModel``
computes it, as a function of a parameter dict: learned positions, pre-LN
blocks, causal self-attention with an explicit masked softmax, the tanh
GELU, a final LayerNorm and a bias-free vocabulary head.

The blocks' parameters are stacked on a leading ``[n_layer]`` axis
(``h.attn.c_attn.weight`` is ``[n_layer, 3E, E]``, dense weights ``[out,
in]``), and the head ``lm_head.weight`` is a tensor of its own. A
configuration gives ``vocab_size``, ``n_embd``, ``n_layer``, ``n_head``,
``n_positions`` and ``layer_norm_epsilon``. Every block's four dense
layers are tracked, stacked over depth, and so is the head.
"""
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.layers import Layer, Recorder, dense

BLOCK_DENSE = (("attn.c_attn", 1, 3), ("attn.c_proj", 1, 1),
               ("mlp.c_fc", 1, 4), ("mlp.c_proj", 4, 1))


def layers(cfg) -> Dict[str, Layer]:
    """The blocks' dense layers (stacked) and the head, in forward order."""
    e, depth = cfg["n_embd"], cfg["n_layer"]
    out = {f"h.{n}": Layer(f"h.{n}", "dense", e * o, e * i, True,
                           depth=depth) for n, i, o in BLOCK_DENSE}
    out["lm_head"] = Layer("lm_head", "dense", cfg["vocab_size"], e, False)
    return out


def param_specs(cfg) -> List[Tuple[str, tuple, tuple]]:
    """(key, shape, init): N(0, 0.02^2) dense weights, token embedding and
    head; N(0, 0.01^2) positions and biases; LayerNorm scales 1 + 0.1 z and
    biases N(0, 0.05^2)."""
    e, depth = cfg["n_embd"], cfg["n_layer"]
    specs = [("wte.weight", (cfg["vocab_size"], e), ("normal", 0.0, 0.02)),
             ("wpe.weight", (cfg["n_positions"], e), ("normal", 0.0, 0.01))]

    def norm(prefix, lead=()):
        specs.extend([(f"{prefix}.weight", lead + (e,), ("normal", 1.0, 0.1)),
                      (f"{prefix}.bias", lead + (e,), ("normal", 0.0, 0.05))])

    norm("h.ln_1", (depth,))
    for n, i, o in BLOCK_DENSE[:2]:
        specs.append((f"h.{n}.weight", (depth, e * o, e * i),
                      ("normal", 0.0, 0.02)))
        specs.append((f"h.{n}.bias", (depth, e * o), ("normal", 0.0, 0.01)))
    norm("h.ln_2", (depth,))
    for n, i, o in BLOCK_DENSE[2:]:
        specs.append((f"h.{n}.weight", (depth, e * o, e * i),
                      ("normal", 0.0, 0.02)))
        specs.append((f"h.{n}.bias", (depth, e * o), ("normal", 0.0, 0.01)))
    norm("ln_f")
    specs.append(("lm_head.weight", (cfg["vocab_size"], e),
                  ("normal", 0.0, 0.02)))
    return specs


def _ln(p, key, x, eps, i=None):
    w, b = p[f"{key}.weight"], p[f"{key}.bias"]
    if i is not None:
        w, b = w[i], b[i]
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def forward(p: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
            train: bool, rec: Recorder = None) -> torch.Tensor:
    """Logits [B, T, V] of token ids [B, T] (no dropout, so ``train`` is
    the same as eval)."""
    b, t = tokens.shape
    e, heads = cfg["n_embd"], cfg["n_head"]
    d, eps = e // heads, cfg["layer_norm_epsilon"]
    x = p["wte.weight"][tokens] + p["wpe.weight"][None, :t]
    causal = torch.ones(t, t, dtype=torch.bool,
                        device=tokens.device).tril()
    for i in range(cfg["n_layer"]):
        def lin(name, v):
            return dense(rec, f"h.{name}", v, p[f"h.{name}.weight"][i],
                         p[f"h.{name}.bias"][i])
        qkv = lin("attn.c_attn", _ln(p, "h.ln_1", x, eps, i))
        q, k, v = (u.reshape(b, t, heads, d).transpose(1, 2)
                   for u in qkv.split(e, dim=-1))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        att = att.masked_fill(~causal, torch.finfo(att.dtype).min)
        o = (torch.softmax(att, dim=-1) @ v).transpose(1, 2).reshape(b, t, e)
        if rec is not None:
            rec.macs(2 * b * t * t * e)            # QK^T and AV
        x = x + lin("attn.c_proj", o)
        h = F.gelu(lin("mlp.c_fc", _ln(p, "h.ln_2", x, eps, i)),
                   approximate="tanh")
        x = x + lin("mlp.c_proj", h)
    return dense(rec, "lm_head", _ln(p, "ln_f", x, eps), p["lm_head.weight"])


def make_inputs(cfg, traffic, generator, device) -> tuple:
    """Uniform token ids [B, T] and next-token labels [B, T] (B
    ``traffic["batch"]``, T ``traffic["seq_len"]``), drawn with
    ``generator``."""
    v, shape = cfg["vocab_size"], (traffic["batch"], traffic["seq_len"])
    x = torch.randint(0, v, shape, generator=generator, device=device)
    y = torch.randint(0, v, shape, generator=generator, device=device)
    return x, y


def units(x: torch.Tensor) -> int:
    """Tokens in a batch."""
    return x.numel()


def loss_count(x: torch.Tensor) -> int:
    """The positions the mean loss averages over: every token."""
    return x.numel()
