"""The port's DeepSeek-V3 decoder (models/deepseek.py) against the
benchmark's plain reference (gpubench/reference/deepseek_v3.py) at a tiny
size on the CPU: hidden 64, 2 heads (nope 16, rope 8, v 16), kv rank 32,
8 experts of width 32 (one shared), top-3, one dense and two MoE layers,
vocabulary 128, T 32. Also the held share of an expert-parallel card, the
interleaved RoPE and the selection-versus-weight split by hand, and the
MoE spans and counters."""
import math

import pytest
import torch

from curvature_tpu_torch import estimators, models
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.models.deepseek import DeepseekMoE, DeepseekV3
from curvature_tpu_torch.utils import monitor
from gpubench import weights as seeded
from gpubench.reference import deepseek_v3 as ref
from gpubench.reference import kfac as ref_kfac

torch.set_num_threads(1)

#: the tiny configuration, as the benchmark's file gives one (the
#: reference reads the router's width from ``router_experts``)
CFG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=3,
           num_attention_heads=2, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16, kv_lora_rank=32, intermediate_size=128,
           moe_intermediate_size=32, n_routed_experts=8, router_experts=8,
           held_first=0, n_shared_experts=1, num_experts_per_tok=3,
           first_k_dense_replace=1, routed_scaling_factor=2.446,
           norm_topk_prob=True, rms_norm_eps=1e-5, rope_theta=50000.0)
PORT_KEYS = [k for k in CFG if k not in ("router_experts", "held_first",
                                         "n_routed_experts")]
#: f32 through three layers: SDPA against the explicit softmax, the routed
#: combine against the reference's index_add, other summation orders; a
#: few ulps of the largest logit
LOGITS_REL = 1e-5
#: f32 Grams of the same rows in other orders (the reference's recorded
#: rows carry sqrt(rows / N), one more rounding each)
FACTOR_REL = 1e-5


def _port(cfg, weights, held=None):
    held = held or (cfg["held_first"], cfg["n_routed_experts"])
    model = DeepseekV3(n_routed_experts=cfg["router_experts"], held=held,
                       **{k: cfg[k] for k in PORT_KEYS})
    model.load_state_dict(weights)
    return model


def _setup(seed=0, cfg=CFG):
    g = torch.Generator().manual_seed(seed)
    w = seeded.make(ref.param_specs(cfg), g, "cpu")
    x, y = ref.make_inputs(cfg, {"batch": 2, "seq_len": 32}, g, "cpu")
    return w, x, y


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_reference(seed):
    w, x, _ = _setup(seed)
    model = _port(CFG, w)
    with torch.no_grad():
        assert _rel(model(x), ref.forward(w, x, CFG, False)) < LOGITS_REL


@pytest.mark.parametrize("seed", [0, 1])
def test_routed_kfac_factors_match_reference(seed):
    """Every tracked layer's A and G, the experts' through the ``routed``
    route (each expert's Grams over its own rows, divided by all N
    tokens), against the reference's; one expert's A by hand."""
    w, x, y = _setup(seed)
    model = _port(CFG, w)
    est = estimators.KFAC(model, loss="lm", layer_filter="model.layers.*")
    cap = est.capture(x, labels=y)
    name = "model.layers.1.mlp.experts.gate_proj"
    assert set(cap.routes) == {n for n, m in est.metas.items() if m.moe}
    assert cap.acts[name].ndim == 2             # no [held, N, F] stream
    est.update_state(est.state, cap)
    want = ref_kfac.factors(ref, CFG, w, x, y, "model.layers.*")
    assert set(want) == set(est.state)
    for layer, f in want.items():
        for side in ("a", "g"):
            got = est.state[layer][side]
            rel = float((got - f[side]).norm() / f[side].norm())
            assert rel < FACTOR_REL, (layer, side, rel)
    r, rows = cap.routes[name], cap.acts[name]
    n = x.numel()
    e = max(range(r.experts), key=lambda j: r.offsets[j + 1] - r.offsets[j])
    mine = rows[r.offsets[e]:r.offsets[e + 1]]
    torch.testing.assert_close(est.state[name]["a"][e], mine.T @ mine / n,
                               rtol=1e-5, atol=1e-7)
    assert r.offsets[e + 1] - r.offsets[e] < n


def test_held_shares_sum_to_whole_layer():
    """Four cards of two experts each: their routed parts summed, plus the
    shared experts counted once, equal the reference's uncut layer."""
    w, x, _ = _setup(2)
    h = torch.randn(2, 32, 64)
    pre, d = "model.layers.1.mlp", CFG["hidden_size"]
    total = 0
    for card in range(4):
        block = DeepseekMoE(d, 32, 8, 1, 3, 2.446, True, (2 * card, 2))
        sd = {"experts.router.weight": w[f"{pre}.experts.router.weight"],
              "experts.e_score_correction_bias":
                  w[f"{pre}.experts.e_score_correction_bias"]}
        for p in ("gate_proj", "up_proj", "down_proj"):
            sd[f"experts.{p}.weight"] = \
                w[f"{pre}.experts.{p}.weight"][2 * card:2 * card + 2]
            sd[f"shared_experts.{p}.weight"] = \
                w[f"{pre}.shared_experts.{p}.weight"]
        block.load_state_dict(sd)
        with torch.no_grad():
            total = total + block.experts(h)
            shared = block.shared_experts(h)
    stats = {"ties": 0, "misses": 0, "tie_gap": 0.0, "rows": []}
    with torch.no_grad():
        want = ref._moe(w, pre, h, CFG, None, None, stats) \
            + ref._swiglu(w, f"{pre}.shared_experts", h, None)
    assert _rel(total + shared, want) < LOGITS_REL


def test_rope_deinterleave_by_hand():
    """d = 4 at position 3: the pairs (x0, x1), (x2, x3) become halves
    (x0, x2 | x1, x3), rotated by angles 3 * theta^0 and 3 * theta^-1/2."""
    theta = 100.0
    cos, sin = tnn.rope_cos_sin(torch.arange(4), 4, theta)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0]).expand(4, 4)
    got = tnn.apply_rope_interleaved(x, cos, sin)[3]
    a0, a1 = 3.0, 3.0 / math.sqrt(theta)
    u = [1.0, 3.0, 2.0, 4.0]                  # de-interleaved
    want = torch.tensor([
        u[0] * math.cos(a0) - u[2] * math.sin(a0),
        u[1] * math.cos(a1) - u[3] * math.sin(a1),
        u[2] * math.cos(a0) + u[0] * math.sin(a0),
        u[3] * math.cos(a1) + u[1] * math.sin(a1)])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(
        ref._apply_rope(x, *ref._rope(4, 4, theta, "cpu"))[3], want)


def test_selection_bias_versus_weights_by_hand():
    """Scores s = sigmoid(logit) of 4 experts, top-2 of s + b: the bias
    moves expert 3 into the set over expert 1, while the weights stay the
    chosen s, normalized and scaled."""
    moe = tnn.MoE(4, 4, 4, hidden=2, top_k=2, scoring="sigmoid", gated=True,
                  norm_topk_prob=True, routed_scale=2.0, name="m")
    with torch.no_grad():
        moe.router.weight.copy_(torch.eye(4))
        moe.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 0.0,
                                                        0.3]))
    logits = torch.tensor([[2.0, 1.0, 1.5, 0.5]])
    idx, w = moe.select(logits)
    assert sorted(idx[0].tolist()) == [0, 3]
    s = torch.sigmoid(logits[0])
    want = {0: s[0], 3: s[3]}
    total = s[0] + s[3]
    for j, e in enumerate(idx[0].tolist()):
        torch.testing.assert_close(w[0, j], 2.0 * want[e] / (total + 1e-20))


def test_moe_spans_and_counters():
    """Each MoE forward records ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` with the layer, the held experts
    and the routed rows; the routed factors record their ``factor`` spans;
    ``routed_rows`` counts every (token, choice) pair of held experts and
    no token is dropped."""
    w, x, y = _setup(3)
    model = _port(CFG, w)
    est = estimators.KFAC(model, loss="lm", layer_filter="model.layers.*")
    rows0, dropped0 = tnn.MoE.routed_rows, tnn.MoE.dropped_tokens
    monitor.clear_spans()
    with monitor.tracing():
        est.update(x, labels=y)
    spans = monitor.spans()
    monitor.clear_spans()
    k, n = CFG["num_experts_per_tok"], x.numel()
    assert tnn.MoE.routed_rows - rows0 == 2 * n * k     # all 8 held
    assert tnn.MoE.dropped_tokens == dropped0 == 0
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        got = [s for s in spans if s.name == name]
        assert [s.attrs["layer"] for s in got] == [
            "model.layers.1.mlp.experts", "model.layers.2.mlp.experts"]
        assert all(s.attrs["held"] == 8 for s in got)
        if name != "moe.route":
            assert all(s.attrs["rows"] == n * k for s in got)
    routed = [s for s in spans if s.name == "factor"
              and s.attrs.get("route") == "routed"]
    assert len(routed) == 2 * 3 * 2                  # layers, projections, sides
    assert all(s.attrs["rows"] == n * k and s.attrs["experts"] == 8
               for s in routed)


def test_moonlight_builds_at_published_widths():
    """The registry's Moonlight-16B-A3B on the meta device, two layers
    deep, holding 16 of 64 experts: the tracked layers' shapes."""
    with torch.device("meta"):
        model = models.moonlight_16b_a3b(num_hidden_layers=2, held=(0, 16),
                                         device="meta")
    metas = model.metas
    e = metas["model.layers.1.mlp.experts.gate_proj"]
    assert (e.stacked, e.out_features, e.fan_in, e.moe) == (16, 1408, 2048,
                                                           True)
    assert metas["model.layers.1.mlp.shared_experts.up_proj"].out_features \
        == 2816
    assert metas["model.layers.0.mlp.gate_proj"].out_features == 11264
    assert metas["model.layers.0.self_attn.q_proj"].out_features == 16 * 192
    assert metas["model.layers.0.self_attn.kv_b_proj"].fan_in == 512
    moe = model.model.layers[1].mlp.experts
    assert moe.router.weight.shape == (64, 2048) and moe.top_k == 6
