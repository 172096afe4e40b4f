"""Routed dispatch against dense dispatch: ``nn.MoE`` runs each expert over
its routed rows only; a dense-dispatch copy of the layer (every expert
over every token's masked row, the gates summed over all experts, the
layer as the port had it) must give the same outputs and the same KFAC,
Diagonal and EFB state within f32 summation order, on a bare MoE
(softmax and sigmoid routing, two-layer and gated experts) and on the
Switch GPT-2."""
import copy

import pytest
import torch
import torch.nn.functional as F

from curvature_tpu_torch import estimators as est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.estimators.capture import collect

torch.set_num_threads(1)

#: routed and dense sum each token's expert outputs in another order, and
#: their Grams over other row orders: a few f32 ulps of the largest entry
REL = 1e-5


def _dense_experts(layer, xm, ctx):
    """An expert stack over a per-expert stream ``[E, ..., in]``, every
    expert over every row, with the tracked layer's capture."""
    if ctx is not None:
        ctx.record_act(layer.name, xm)
    y = torch.einsum("e...i,eoi->e...o", xm, layer.weight)
    return ctx.probe(layer.name, y) if ctx is not None else y


def _dense_forward(self, x, ctx=None):
    """The dense masked dispatch of ``MoE``: ``xm[e] = mask_e * x`` through
    every held expert, the mask again after the hidden activation, the
    gated outputs summed over the experts."""
    start, count = self.held
    p, mask = self.route(x)
    if self.scoring == "softmax":
        gates = p * mask
    else:
        w = p * mask
        if self.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        gates = w * self.routed_scale
    gates = gates[..., start:start + count]
    mask_e = mask[..., start:start + count].movedim(-1, 0)[..., None]
    xm = mask_e * x
    if self.hidden is None:
        ye = _dense_experts(self, xm, ctx)
    elif self.gated:
        h = self.activation(_dense_experts(self.gate_proj, xm, ctx)) \
            * _dense_experts(self.up_proj, xm, ctx) * mask_e
        ye = _dense_experts(self.down_proj, h, ctx)
    else:
        h = self.activation(_dense_experts(self.fc1, xm, ctx)) * mask_e
        ye = _dense_experts(self.fc2, h, ctx)
    return (ye * gates.movedim(-1, 0)[..., None]).sum(0)


def _dense_copy(model):
    """A copy of ``model`` whose MoE layers dispatch densely."""
    dense = copy.deepcopy(model)
    for m in dense.modules():
        if isinstance(m, tnn.MoE):
            m.forward = _dense_forward.__get__(m)
    return dense


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = REL * max(float(want.abs().max()), 1e-30)
    torch.testing.assert_close(got, want, rtol=0, atol=atol, msg=what)


def _bare(top_k, scoring, gated):
    torch.manual_seed(top_k + 2 * gated)
    moe = tnn.MoE(16, 16, 4, hidden=24, top_k=top_k, name="moe",
                  scoring=scoring, gated=gated, norm_topk_prob=True,
                  routed_scale=1.7)
    if scoring == "sigmoid":
        moe.e_score_correction_bias.normal_(0.0, 0.05)
    model = tnn.Sequential([tnn.Dense(8, 16, name="inp"), tnn.ReLU(), moe,
                            tnn.Dense(16, 5, name="head")])
    x = torch.randn(32, 8)
    labels = torch.randint(0, 5, (2, 32))
    return model, x, labels, {}


def _switch(top_k):
    torch.manual_seed(3)
    model = tmodels.gpt2_moe_tiny(num_classes=32, experts=4, max_len=8,
                                  device="cpu")
    for m in model.modules():
        if isinstance(m, tnn.MoE):
            m.top_k = top_k
    x = torch.randint(0, 32, (4, 8))
    labels = torch.randint(0, 32, (2, 4, 8))
    return model, x, labels, {"loss": "lm"}


CASES = [pytest.param(("bare", k, s, g), id=f"bare-top{k}-{s}"
                      + ("-gated" if g else ""))
         for k in (1, 2) for s in ("softmax", "sigmoid")
         for g in ((False, True) if s == "sigmoid" else (False,))]
CASES += [pytest.param(("switch", k, "softmax", False), id=f"switch-top{k}")
          for k in (1, 2)]


@pytest.fixture(params=CASES)
def pair(request):
    kind, top_k, scoring, gated = request.param
    model, x, labels, kw = (_bare(top_k, scoring, gated) if kind == "bare"
                            else _switch(top_k))
    return model, _dense_copy(model), x, labels, kw


def test_outputs_equal(pair):
    routed, dense, x, _, _ = pair
    with torch.no_grad():
        _close(routed(x), dense(x), "outputs")


def test_kfac_diagonal_efb_equal(pair):
    routed, dense, x, labels, kw = pair
    kr, kd = est.KFAC(routed, **kw), est.KFAC(dense, **kw)
    kr.update(x, labels=labels)
    kd.update(x, labels=labels)
    for name in kd.state:
        for f in ("a", "g"):
            _close(kr.state[name][f], kd.state[name][f], f"KFAC {name} {f}")
    dr, dd = est.Diagonal(routed, **kw), est.Diagonal(dense, **kw)
    dr.update(x, labels=labels)
    dd.update(x, labels=labels)
    for name in dd.state:
        _close(dr.state[name], dd.state[name], f"Diagonal {name}")
    er = est.EFB(routed, kr.state, **kw)
    ed = est.EFB(dense, kr.state, **kw)
    er.update(x, labels=labels)
    ed.update(x, labels=labels)
    for name in ed.state:
        _close(er.state[name], ed.state[name], f"EFB {name}")
        _close(er.diags[name], ed.diags[name], f"EFB diag {name}")


def test_routed_capture_rebuilds_the_masked_stream(pair):
    """The masked stream an estimator other than KFAC reads is the dense
    dispatch's own, value for value (its zeros included)."""
    routed, dense, x, labels, kw = pair
    loss = kw.get("loss", "cross_entropy")
    metas = {n: m for n, m in routed.metas.items() if m.moe}
    got = collect(routed, metas, x, labels=labels, loss=loss)
    want = collect(dense, metas, x, labels=labels, loss=loss)
    kept = collect(routed, metas, x, labels=labels, loss=loss, routed=True)
    assert not got.routes and set(kept.routes) == set(metas)
    for name, m in metas.items():
        _close(got.acts[name], want.acts[name], f"{name} acts")
        _close(got.probe_grads[name], want.probe_grads[name],
               f"{name} probe grads")
        r = kept.routes[name]
        assert kept.acts[name].shape == (r.rows, m.fan_in)
        assert r.rows == x.shape[0] * (x.shape[1] if x.ndim == 2
                                       and loss == "lm" else 1) \
            * next(mm for mm in routed.modules()
                   if isinstance(mm, tnn.MoE)).top_k


def test_dense_dispatch_helper_is_the_masked_layer():
    """The dense helper itself, by hand on a bare top-2 softmax MoE: each
    token's output is the sum over its two experts of p_e * expert_e."""
    model, x, _, _ = _bare(2, "softmax", False)
    moe = model.moe
    h = torch.relu(model.inp(x))
    with torch.no_grad():
        got = _dense_forward(moe, h)
        p = torch.softmax(h @ moe.router.weight.T, -1)
        top = torch.topk(p, 2, -1).indices
        want = torch.zeros_like(got)
        for n in range(h.shape[0]):
            for e in top[n]:
                y = F.gelu(h[n] @ moe.fc1.weight[e].T, approximate="tanh") \
                    @ moe.fc2.weight[e].T
                want[n] += p[n, e] * y
    _close(got, want, "dense helper")
