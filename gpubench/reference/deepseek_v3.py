"""A DeepSeek-V3 decoder (DeepSeek-AI, 2024; Hugging Face's
``DeepseekV3ForCausalLM``, as Moonlight-16B-A3B configures it) as a
function of a parameter dict, in float32:

- ``x = embed[tokens]``; each layer ``x += MLA(RMSNorm(x))``, then ``x +=
  FFN(RMSNorm(x))``; a final RMSNorm and an untied vocabulary head.
- MLA without a query low-rank: ``q = h Wq^T`` per head ``[q_nope | q_pe]``;
  ``[c_kv | k_pe] = h Wkva^T`` (``k_pe`` one head for all);
  ``[k_nope | v] = RMSNorm(c_kv) Wkvb^T`` per head; RoPE on ``q_pe`` and
  ``k_pe`` after DeepSeek's de-interleave (``view(..., d/2, 2).transpose(-1,
  -2)``, then ``rotate_half``); an explicit causal softmax of ``Q K^T /
  sqrt(nope + rope)`` in blocks of queries, each over the keys up to its
  last query.
- The first ``first_k_dense_replace`` layers' FFN is ``Wd(silu(Wg h) * Wu
  h)``. The others': ``s = sigmoid(h Wr^T)`` over all the router's
  experts; the chosen set is the top-k of ``s + b`` (``b`` the correction
  bias, which decides the selection only); ``w = scale * s_chosen /
  (sum s_chosen + 1e-20)``; ``x += sum_j w_j E_j(h) + S(h)``, each routed
  expert ``E_j`` a SwiGLU computed on its routed rows only, and the shared
  experts ``S`` one SwiGLU over every token.

The cut to one card of an expert-parallel host: the router scores
``router_experts`` experts, and the layer holds ``n_routed_experts`` of
them, from ``held_first``: their part of the routed sum is computed, the
others' is not (it would come from the other cards).

What the benchmark's KFAC reference (``reference/kfac.py``) reads: every
projection is a recorded dense layer; each held expert's three projections
are recorded per expert (a stacked layer of depth ``n_routed_experts``).
``kfac.factors`` divides a recorded stream's Gram by its own rows, while an
expert's factors divide by all N tokens of the layer (``A_e = sum_{n routed
to e} a_n a_n^T / N``, the Fisher block of the masked stream). So an
expert's recorded input is its rows times ``c = sqrt(rows / N)``, and its
recorded output a zero probe ``z`` added to the projection's output as
``c z``, whose gradient is ``c`` times the output's: both Grams then come
out divided by N. An expert that no token chose records one zero row.

Routing ties: the chosen set is a top-k of f32 scores, and where two
scores lie within rounding of each other the program's choice and this
one's may differ, which moves an expert's factors by one token's Gram
(about 1e-2 of them) against limits near 1e-5. :func:`give_routes` hands
over the program's chosen sets of a batch; where they differ from this
module's at a token and this module's ``s + b`` of every expert in the
difference lie within :data:`TIE` of each other, the program's set is
taken (a tie); anywhere else this module's own set stays (a miss, which
the factor checks then fail). :data:`STATS` counts both.

On the ``meta`` device (the benchmark's counts of work, ``work.py``) the
routing is data-dependent and cannot run: each held expert is recorded at
the mean load ``N k / E`` rows. The router's multiply-adds and MLA's
``Q K^T`` and ``P V`` (``B H T^2 (nope + rope + v)``) are counted as the
multiply-adds of no layer.
"""
import json
import math
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.layers import Layer, Recorder, dense

#: the widest gap of ``s + b`` between swapped experts that counts as a
#: tie. A router logit is a 2048-term f32 dot product of an RMS-normalized
#: input (|h| ~ 45) and a router row (|w| ~ 0.9): inputs that differ by a
#: relative 2^-20 (a few f32 ulps, which nine layers of the program's and
#: this module's different summation orders give) move it by up to ~4e-5,
#: and the sigmoid's slope is at most 1/4; 1e-4 leaves more than twice
#: that, and lies 100 times below the correction bias's spread (0.01), so a
#: routing that used the bias wrongly would not pass as ties
TIE = 1e-4
#: query rows a block of the explicit attention
ATTN_BLOCK = 1024
#: per batch of routes given: ties taken, misses, the widest tie gap and
#: the routed rows of the held experts
STATS: List[Dict] = []
_ROUTES: Dict[int, List[torch.Tensor]] = {}


def give_routes(tokens: torch.Tensor, chosen: List[torch.Tensor]):
    """The program's chosen experts ``[B*T, k]`` of each MoE layer, in
    order, for the batch ``tokens`` (the same tensor later passed to
    :func:`forward`)."""
    _ROUTES[id(tokens)] = [c.detach() for c in chosen]


def _moe_layers(cfg) -> List[int]:
    return list(range(cfg["first_k_dense_replace"],
                      cfg["num_hidden_layers"]))


def layers(cfg) -> Dict[str, Layer]:
    """Every projection of every layer, in forward order, and the head;
    a held expert's projection is stacked over the held experts."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    out = {}

    def add(name, o, i, depth=0):
        out[name] = Layer(name, "dense", o, i, False, depth=depth)

    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        add(f"{p}.self_attn.q_proj", h * (nope + rope), d)
        add(f"{p}.self_attn.kv_a_proj_with_mqa", r + rope, d)
        add(f"{p}.self_attn.kv_b_proj", h * (nope + vd), r)
        add(f"{p}.self_attn.o_proj", d, h * vd)
        if i < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            for n, o, i_ in (("gate_proj", f, d), ("up_proj", f, d),
                             ("down_proj", d, f)):
                add(f"{p}.mlp.{n}", o, i_)
            continue
        f, e = cfg["moe_intermediate_size"], cfg["n_routed_experts"]
        for n, o, i_ in (("gate_proj", f, d), ("up_proj", f, d),
                         ("down_proj", d, f)):
            add(f"{p}.mlp.experts.{n}", o, i_, depth=e)
        fs = f * cfg["n_shared_experts"]
        for n, o, i_ in (("gate_proj", fs, d), ("up_proj", fs, d),
                         ("down_proj", d, fs)):
            add(f"{p}.mlp.shared_experts.{n}", o, i_)
    add("lm_head", cfg["vocab_size"], d)
    return out


def param_specs(cfg) -> List[Tuple[str, tuple, tuple]]:
    """(key, shape, init): N(0, 0.02^2) embedding, projections, experts,
    router and head; RMSNorm scales 1 + 0.1 z; the correction bias N(0,
    0.01^2)."""
    d, w = cfg["hidden_size"], ("normal", 0.0, 0.02)
    norm = ("normal", 1.0, 0.1)
    specs = [("model.embed_tokens.weight", (cfg["vocab_size"], d), w)]
    lay = layers(cfg)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        specs.append((f"{p}.input_layernorm.weight", (d,), norm))
        for n in ("q_proj", "kv_a_proj_with_mqa"):
            l_ = lay[f"{p}.self_attn.{n}"]
            specs.append((f"{p}.self_attn.{n}.weight", (l_.out, l_.fan_in),
                          w))
        specs.append((f"{p}.self_attn.kv_a_layernorm.weight",
                      (cfg["kv_lora_rank"],), norm))
        for n in ("kv_b_proj", "o_proj"):
            l_ = lay[f"{p}.self_attn.{n}"]
            specs.append((f"{p}.self_attn.{n}.weight", (l_.out, l_.fan_in),
                          w))
        specs.append((f"{p}.post_attention_layernorm.weight", (d,), norm))
        if i >= cfg["first_k_dense_replace"]:
            e = cfg["router_experts"]
            specs.append((f"{p}.mlp.experts.router.weight", (e, d), w))
            specs.append((f"{p}.mlp.experts.e_score_correction_bias", (e,),
                          ("normal", 0.0, 0.01)))
        for name, l_ in lay.items():
            if name.startswith(f"{p}.mlp."):
                lead = (l_.depth,) if l_.depth else ()
                specs.append((f"{name}.weight", lead + (l_.out, l_.fan_in),
                              w))
    specs.append(("model.norm.weight", (d,), norm))
    specs.append(("lm_head.weight", (cfg["vocab_size"], d), w))
    return specs


def _rms(x, weight, eps):
    v = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return weight * v


def _rope(t: int, dim: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] \
        * inv[None]
    emb = torch.cat([ang, ang], dim=-1)
    return emb.cos(), emb.sin()


def _apply_rope(x, cos, sin):
    d = x.shape[-1]
    x = x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2).reshape(
        x.shape)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _attention(q, k, v):
    """Causal softmax attention ``[B, H, T, dv]`` in blocks of
    :data:`ATTN_BLOCK` queries, block ``j`` over keys ``0 ..`` its last."""
    t = q.shape[-2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for lo in range(0, t, ATTN_BLOCK):
        hi = min(t, lo + ATTN_BLOCK)
        s = (q[..., lo:hi, :] @ k[..., :hi, :].transpose(-1, -2)) * scale
        mask = torch.ones(hi - lo, hi, dtype=torch.bool,
                          device=q.device).tril(lo)
        s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        outs.append(torch.softmax(s, dim=-1) @ v[..., :hi, :])
    return torch.cat(outs, dim=-2)


def _mla(p, pre, h, cos, sin, cfg, rec):
    b, t, _ = h.shape
    hd = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]

    def lin(name, x):
        return dense(rec, f"{pre}.{name}", x, p[f"{pre}.{name}.weight"])

    q = lin("q_proj", h).reshape(b, t, hd, nope + rope).transpose(1, 2)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    c = lin("kv_a_proj_with_mqa", h)
    c_kv, k_pe = c[..., :r], c[..., r:]
    kv = lin("kv_b_proj", _rms(c_kv, p[f"{pre}.kv_a_layernorm.weight"],
                               cfg["rms_norm_eps"]))
    kv = kv.reshape(b, t, hd, nope + vd).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = _apply_rope(q_pe, cos, sin)
    k_pe = _apply_rope(k_pe[:, None], cos, sin).expand(b, hd, t, rope)
    o = _attention(torch.cat([q_nope, q_pe], -1),
                   torch.cat([k_nope, k_pe], -1), v)
    if rec is not None:
        rec.macs(b * hd * t * t * (nope + rope + vd))   # Q K^T and P V
    return lin("o_proj", o.transpose(1, 2).reshape(b, t, hd * vd))


def _swiglu(p, pre, h, rec):
    def lin(name, x):
        return dense(rec, f"{pre}.{name}", x, p[f"{pre}.{name}.weight"])
    return lin("down_proj", F.silu(lin("gate_proj", h)) * lin("up_proj", h))


def _expert_dense(rec, name, x, weight, c):
    """``x weight^T`` over an expert's rows, recorded as the module
    docstring says (input times ``c``, a zero probe times ``c``)."""
    y = x @ weight.T
    if rec is None:
        return y
    n = x.shape[0]
    m = max(n, 1)
    a = x.new_zeros((1, m, x.shape[1]))
    a[0, :n] = x.detach() * c
    z = torch.zeros((1, m, y.shape[1]), dtype=y.dtype, device=y.device,
                    requires_grad=True)
    rec.layer(name, a, z)
    return y + z[0, :n] * c


def _choose(choice, k, given, stats):
    """This module's top-k of ``choice`` ``[N, E]``, with the program's
    sets ``given`` taken at the tokens where they differ only by a tie."""
    own = torch.topk(choice, k, dim=-1).indices
    if given is None:
        return own
    own_m = torch.zeros_like(choice, dtype=torch.bool).scatter_(1, own, True)
    giv_m = torch.zeros_like(own_m).scatter_(1, given.to(own.device), True)
    swapped = own_m != giv_m
    differ = swapped.any(-1)
    big = torch.finfo(choice.dtype).max
    top = torch.where(swapped, choice, -big).amax(-1)
    low = torch.where(swapped, choice, big).amin(-1)
    gap = torch.where(differ, top - low, torch.zeros_like(top))
    tie = differ & (gap <= TIE)
    stats["ties"] += int(tie.sum())
    stats["misses"] += int((differ & ~tie).sum())
    if bool(tie.any()):
        stats["tie_gap"] = max(stats["tie_gap"], float(gap[tie].max()))
    return torch.where(tie[:, None], given.to(own.device), own)


def _moe(p, pre, h, cfg, rec, given, stats):
    """The held experts' part of the routed sum, ``[B, T, D]``."""
    b, t, d = h.shape
    n = b * t
    k, e_all = cfg["num_experts_per_tok"], cfg["router_experts"]
    held, first = cfg["n_routed_experts"], cfg["held_first"]
    hf = h.reshape(n, d)
    logits = hf @ p[f"{pre}.experts.router.weight"].T
    if rec is not None:
        rec.macs(n * d * e_all)
    names = [f"{pre}.experts.{m}" for m in ("gate_proj", "up_proj",
                                            "down_proj")]
    ws = [p[f"{nm}.weight"] for nm in names]

    def expert(j, x, c):
        g = _expert_dense(rec, names[0], x, ws[0][j], c)
        u = _expert_dense(rec, names[1], x, ws[1][j], c)
        return _expert_dense(rec, names[2], F.silu(g) * u, ws[2][j], c)

    if h.device.type == "meta":
        load = n * k // e_all
        out = hf.new_zeros((n, d))
        for j in range(held):
            expert(j, hf[:load], 1.0)
        return out.reshape(b, t, d)
    s = torch.sigmoid(logits)
    with torch.no_grad():
        choice = s + p[f"{pre}.experts.e_score_correction_bias"]
        idx = _choose(choice, k, given, stats)
    w = s.gather(-1, idx)
    w = cfg["routed_scaling_factor"] * w / (w.sum(-1, keepdim=True) + 1e-20)
    out = hf.new_zeros((n, d))
    for j in range(held):
        sel = idx == first + j                                  # [N, k]
        rows = sel.any(-1).nonzero()[:, 0]
        gate = (w * sel).sum(-1)[rows]
        stats["rows"].append(int(rows.numel()))
        y = expert(j, hf[rows], math.sqrt(rows.numel() / n))
        out = out.index_add(0, rows, gate[:, None] * y)
    return out.reshape(b, t, d)


def forward(p: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
            train: bool, rec: Recorder = None) -> torch.Tensor:
    """Logits [B, T, V] of token ids [B, T] (no dropout, so ``train`` is
    the same as eval)."""
    b, t = tokens.shape
    eps = cfg["rms_norm_eps"]
    given = _ROUTES.get(id(tokens))
    stats = {"ties": 0, "misses": 0, "tie_gap": 0.0, "rows": []}
    x = p["model.embed_tokens.weight"][tokens]
    cos, sin = _rope(t, cfg["qk_rope_head_dim"], cfg["rope_theta"],
                     tokens.device)
    moe = _moe_layers(cfg)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}"
        h = _rms(x, p[f"{pre}.input_layernorm.weight"], eps)
        x = x + _mla(p, f"{pre}.self_attn", h, cos, sin, cfg, rec)
        h = _rms(x, p[f"{pre}.post_attention_layernorm.weight"], eps)
        if i in moe:
            chosen = None if given is None else given[moe.index(i)]
            x = x + _moe(p, f"{pre}.mlp", h, cfg, rec, chosen, stats) \
                + _swiglu(p, f"{pre}.mlp.shared_experts", h, rec)
        else:
            x = x + _swiglu(p, f"{pre}.mlp", h, rec)
    if given is not None:
        STATS.append(stats)
        rows = stats.pop("rows")
        print("gpubench routes: " + json.dumps(dict(
            stats, rows_min=min(rows), rows_mean=sum(rows) / len(rows),
            rows_max=max(rows))), file=sys.stderr, flush=True)
    return dense(rec, "lm_head", _rms(x, p["model.norm.weight"], eps),
                 p["lm_head.weight"])


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
