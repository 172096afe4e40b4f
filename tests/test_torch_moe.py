"""The mixture-of-experts layer (``nn.MoE``) and the Switch GPT-2 in the
port against the JAX package (tests/test_moe.py, case by case).

Each case builds the same network in both packages and gives both the
same numpy-seeded weights (``models.seeded_variables``, JAX's layout,
carried into the port by ``models.load_jax_variables``: an expert kernel
is ``[E, in, out]`` in JAX and ``[E, out, in]`` here, the router ``[in,
E]`` and ``[E, in]``), the same numpy-seeded inputs and the same labels.
Bars are relative to the largest magnitude of the JAX value: logits and
captured inputs 1e-5, f32 factors and states 1e-5, samples from the same
draws 5e-4 (tests/test_torch_estimators.py's bar for draws); routing
masks are equal exactly. JAX's expert-sharded case runs on a 4-rank
gloo job on the CPU (tests/torch_dist_worker.py ``job_expert``, mesh
``expert:2,data:2``), held to one port process at JAX's bar (rtol 1e-5,
atol 1e-6; draws rtol 1e-4, atol 1e-5) and that process to JAX.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import curvature_tpu.nn as jnn
from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu import optim as joptim
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch import optim as toptim
from tests import torch_dist_worker as W

torch.set_num_threads(1)

ADD, MULTIPLY = 1.0, 10.0


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _states_close(got, want, rel, what):
    for name in want:
        for key in want[name]:
            _close(got[name][key], want[name][key], rel,
                   f"{what} {name}.{key}")


class _JaxMoENet(jnn.Module):
    """tests/test_moe.py's ``_MoENet``: inp -> relu -> MoE -> head."""

    def __init__(self, experts, hidden=None, activation=None, top_k=1):
        self.name = None
        self.inp = jnn.Dense(16, name="inp")
        self.moe = jnn.MoE(16, experts, hidden=hidden, activation=activation,
                           top_k=top_k, name="moe")
        self.head = jnn.Dense(5, name="head")

    def __call__(self, ctx, x):
        h = jax.nn.relu(self.inp(ctx, x))
        return self.head(ctx, self.moe(ctx, h))


def _port_net(experts, hidden=None, activation=None, top_k=1):
    return tnn.Sequential([
        tnn.Dense(8, 16, name="inp"), tnn.ReLU(),
        tnn.MoE(16, 16, experts, hidden=hidden, activation=activation,
                top_k=top_k, name="moe"),
        tnn.Dense(16, 5, name="head")])


def _build(experts, hidden=None, activation=(None, None), top_k=1, seed=0,
           batch=16):
    """(JAX model, JAX variables, port model, x [B, 8], labels [2, B])."""
    tm = _port_net(experts, hidden, activation[1], top_k)
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jm = jnn.Model(_JaxMoENet(experts, hidden, activation[0], top_k))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((batch, 8)).astype(np.float32)
    labels = rng.integers(0, 5, (2, batch)).astype(np.int32)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    return jm, jv, tm, x, labels


def _routing(variables, x, top_k=1):
    """The hidden input of the MoE, the router probabilities and the
    routing mask, recomputed outside both models in numpy."""
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    h = np.maximum(x @ p["inp"]["kernel"] + p["inp"]["bias"], 0.0)
    logits = h @ p["moe.router"]["kernel"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    mask = np.zeros_like(probs)
    np.put_along_axis(mask, top, 1.0, axis=-1)
    return h, probs, mask


def _jax_noise(j, t, seed):
    """JAX's draws (one key per layer split off in meta order) at the
    port's noise shape, which is JAX's."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, shape in t.noise_shapes().items():
        rng, key = jax.random.split(rng)
        noise[name] = np.array(jax.random.normal(key, shape, jnp.float32))
    assert list(noise) == list(j.metas)
    return noise


def _manual_logits(variables, x, top_k=1):
    h, probs, mask = _routing(variables, x, top_k)
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    k = p["moe"]["kernel"]                                  # [E, F, O]
    y = np.stack([sum(probs[n, e] * (h[n] @ k[e])
                      for e in np.flatnonzero(mask[n]))
                  for n in range(x.shape[0])])
    return y @ p["head"]["kernel"] + p["head"]["bias"]


@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
def test_moe_forward_matches_manual_routing(top_k):
    """Logits against JAX's and against routing by hand (1e-5); the
    port's router picks exactly the experts JAX's mask does."""
    jm, jv, tm, x, _ = _build(experts=4, top_k=top_k)
    want, _ = jm.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        h = torch.relu(tm.inp(torch.from_numpy(x)))
        _, mask = tm.moe.route(h)
    _close(got, want, 1e-5, "logits")
    _close(got, _manual_logits(jv, x, top_k), 1e-5, "manual logits")
    _, _, want_mask = _routing(jv, x, top_k)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    assert (mask.sum(-1) == top_k).all()


def test_single_expert_equals_dense():
    """E=1: the softmax over one logit routes every token with gate 1, so
    the MoE is a bias-free Dense: forward, KFAC and Diagonal equal the
    Dense net's, and both equal JAX's."""
    jm, jv, tm, x, labels = _build(experts=1)
    sd = tm.state_dict()
    dense = tnn.Sequential([tnn.Dense(8, 16, name="inp"), tnn.ReLU(),
                            tnn.Dense(16, 16, bias=False, name="moe"),
                            tnn.Dense(16, 5, name="head")])
    dense.load_state_dict({
        "inp.weight": sd["inp.weight"], "inp.bias": sd["inp.bias"],
        "moe.weight": sd["moe.weight"][0],
        "head.weight": sd["head.weight"], "head.bias": sd["head.bias"]})
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels)
    with torch.no_grad():
        _close(tm(tx), dense(tx), 1e-5, "logits vs dense")
    for cls in ("KFAC", "Diagonal"):
        ta = getattr(port_est, cls)(tm)
        ta.update(tx, labels=tl)
        tb = getattr(port_est, cls)(dense)
        tb.update(tx, labels=tl)
        ja = getattr(jest, cls)(jm, jv)
        ja.update(jnp.asarray(x), labels=jnp.asarray(labels))
        assert ta.metas["moe"].stacked == 1 and ta.metas["moe"].moe
        if cls == "KFAC":
            for key in ("a", "g"):
                _close(ta.state["moe"][key][0], tb.state["moe"][key], 1e-5,
                       f"{cls} {key} vs dense")
            _states_close(ta.state, ja.state, 1e-5, cls)
        else:
            _close(ta.state["moe"][0], tb.state["moe"], 1e-5, "diag vs dense")
            for name in ja.state:
                _close(ta.state[name], ja.state[name], 1e-5, f"diag {name}")


def test_expert_a_factors_sum_to_dense_gram():
    """Top-1 masks partition the tokens: sum_e A_e is the unmasked Gram,
    and each A_e the Gram of its routed tokens over all N (numpy, and
    JAX's state, 1e-5)."""
    jm, jv, tm, x, labels = _build(experts=4)
    est = port_est.KFAC(tm)
    est.update(torch.from_numpy(x), labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    _states_close(est.state, je.state, 1e-5, "kfac")
    a = _np(est.state["moe"]["a"])                          # [E, F, F]
    h, _, mask = _routing(jv, x)
    num_mc = 2
    dense = num_mc * h.T @ h / h.shape[0]
    _close(a.sum(0), dense, 1e-5, "sum of expert A")
    for e in range(4):
        sel = h[mask[:, e] == 1]
        _close(a[e], num_mc * sel.T @ sel / h.shape[0], 1e-5, f"A_{e}")


def test_moe_two_layer_experts_and_lifecycle():
    """``hidden``: two tracked expert layers; update (1e-5), invert,
    samples from JAX's draws (5e-4), the posterior forward finite, the
    expert weights ``[E, out, in]``."""
    jm, jv, tm, x, labels = _build(experts=4, hidden=32)
    est = port_est.KFAC(tm)
    assert est.metas["moe.fc1"].stacked == 4 and est.metas["moe.fc1"].moe
    assert est.metas["moe.fc2"].fan_in == 32
    est.update(torch.from_numpy(x), labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    _states_close(est.state, je.state, 1e-5, "kfac")
    est.invert(add=ADD, multiply=MULTIPLY)
    je.invert(add=ADD, multiply=MULTIPLY)
    want = je.sample(jax.random.PRNGKey(3))
    got = est.sample(noise=_jax_noise(je, est, 3))
    for name in je.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")
    params = est.posterior_params(noise=_jax_noise(je, est, 3))
    assert params["moe.fc1.weight"].shape == (4, 32, 16)
    with torch.no_grad():
        out = torch.func.functional_call(tm, params, (torch.from_numpy(x),))
    assert torch.isfinite(out).all()


def test_moe_nonzero_activation_stays_masked():
    """A sigmoid expert (act(0) != 0): fc2's A factor sums over the routed
    tokens only (numpy and JAX, 1e-5)."""
    jm, jv, tm, x, labels = _build(
        experts=2, hidden=8, activation=(jax.nn.sigmoid, torch.sigmoid))
    est = port_est.KFAC(tm)
    est.update(torch.from_numpy(x), labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    _states_close(est.state, je.state, 1e-5, "kfac")
    h, _, mask = _routing(jv, x)
    k1 = np.asarray(jv["params"]["moe.fc1"]["kernel"])       # [2, 16, 8]
    a = _np(est.state["moe.fc2"]["a"])
    for e in range(2):
        m = mask[:, e:e + 1]
        he = 1.0 / (1.0 + np.exp(-(h * m) @ k1[e])) * m
        _close(a[e], 2 * he.T @ he / h.shape[0], 1e-5, f"fc2 A_{e}")


def test_efb_on_moe():
    """EFB from the KFAC factors: per-expert eigenbases (JAX's, as eigh
    picks a basis freely in degenerate eigenspaces), lambdas and diags
    against JAX's (1e-5); invert and samples from JAX's draws (5e-4)."""
    jm, jv, tm, x, labels = _build(experts=2)
    jx, jl = jnp.asarray(x), jnp.asarray(labels)
    jk = jest.KFAC(jm, jv)
    jk.update(jx, labels=jl)
    je = jest.EFB(jm, jv, jk.state)
    je.update(jx, labels=jl)
    te = port_est.EFB(tm, tmodels.state_from_jax(jk.state, "cpu"))
    te.eigvecs = tmodels.state_from_jax(je.eigvecs, "cpu")
    te.update(torch.from_numpy(x), labels=torch.from_numpy(labels))
    assert te.state["moe"].shape[0] == 2
    for name in je.metas:
        _close(te.state[name], je.state[name], 1e-5, f"{name} lambdas")
        _close(te.diags[name], je.diags[name], 1e-5, f"{name} diags")
    je.invert(add=ADD, multiply=MULTIPLY)
    te.invert(add=ADD, multiply=MULTIPLY)
    want = je.sample(jax.random.PRNGKey(4))
    got = te.sample(noise=_jax_noise(je, te, 4))
    for name in je.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")


def _lm_pair(experts=4, vocab=32, t=8, seed=1):
    """gpt2_moe_tiny in both packages with the same seeded weights."""
    tm = tmodels.gpt2_moe_tiny(num_classes=vocab, experts=experts,
                               max_len=t, device="cpu")
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_moe_tiny(num_classes=vocab, experts=experts,
                               max_len=t)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, t), jnp.int32)))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, vocab, (4, t)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, 4, t)).astype(np.int32)
    return tm, jm, jax.tree_util.tree_map(jnp.asarray, variables), \
        toks, labels


def test_gpt2_moe_lm_chain():
    """The per-token Fisher over attention Dense layers and MoE experts:
    update (1e-5), invert, samples from JAX's draws (5e-4), the posterior
    logits against JAX's from the same sample (1e-4) and finite."""
    tm, jm, jv, toks, labels = _lm_pair()
    est = port_est.KFAC(tm, loss="lm")
    est.update(torch.from_numpy(toks), labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv, loss="lm")
    je.update(jnp.asarray(toks), labels=jnp.asarray(labels))
    assert est.state["h.0.moe.fc1"]["a"].shape == (4, 64, 64)
    _states_close(est.state, je.state, 1e-5, "kfac")
    est.invert(add=ADD, multiply=MULTIPLY)
    je.invert(add=ADD, multiply=MULTIPLY)
    noise = _jax_noise(je, est, 3)
    want = je.sample(jax.random.PRNGKey(3))
    got = est.sample(noise=noise)
    for name in je.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")
    jp = je.posterior_params(jax.random.PRNGKey(3))
    jl, _ = jm.apply({"params": jp, "batch_stats": {}}, jnp.asarray(toks))
    with torch.no_grad():
        tl = torch.func.functional_call(
            tm, est.posterior_params(noise=noise), (torch.from_numpy(toks),))
    assert torch.isfinite(tl).all()
    _close(tl, jl, 1e-4, "posterior logits")


def test_top2_routing_factors():
    """GShard-style top-2: each expert's A factor is the Gram of exactly
    the tokens that reached it (numpy and JAX, 1e-5)."""
    jm, jv, tm, x, labels = _build(experts=4, top_k=2)
    est = port_est.KFAC(tm)
    est.update(torch.from_numpy(x), labels=torch.from_numpy(labels))
    je = jest.KFAC(jm, jv)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    _states_close(est.state, je.state, 1e-5, "kfac")
    h, _, mask = _routing(jv, x, top_k=2)
    a = _np(est.state["moe"]["a"])
    for e in range(4):
        sel = h[mask[:, e] == 1]
        _close(a[e], 2 * sel.T @ sel / 16, 1e-5, f"A_{e}")


def test_kfac_natural_gradient_training_on_moe():
    """One natural-gradient step (``optim.make_kfac_train_step``, the
    empirical Fisher) preconditions the per-expert blocks as JAX's does:
    the loss and the new parameters within 1e-4 of max."""
    import optax
    jm, jv, tm, x, _ = _build(experts=2)
    y = np.random.default_rng(0).integers(0, 5, 16)
    tx = optax.sgd(0.05)
    kstep, kinit = joptim.make_kfac_train_step(
        jm, jest.KFAC(jm, jv), tx, damping=0.1, mc_fisher=False)
    factors, inv = kinit(jv, jnp.asarray(x), jnp.asarray(y),
                         jax.random.PRNGKey(1))
    p0 = jv["params"]
    out = kstep(p0, tx.init(p0), factors, inv, {},
                jnp.zeros((), jnp.int32), jnp.asarray(x), jnp.asarray(y),
                jax.random.PRNGKey(2))
    opt = torch.optim.SGD(tm.parameters(), lr=0.05)
    tstep, tinit = toptim.make_kfac_train_step(
        tm, port_est.KFAC(tm), opt, damping=0.1, mc_fisher=False)
    tx_, ty = torch.from_numpy(x), torch.from_numpy(y).long()
    tfactors, tinv = tinit(tx_, ty)
    _, _, count, loss = tstep(tfactors, tinv, 0, tx_, ty)
    assert count == 1
    np.testing.assert_allclose(float(loss), float(out[-1]), rtol=1e-4)
    got = tmodels.variables_to_jax(tm)["params"]
    assert got["moe"]["kernel"].shape == (2, 16, 16)
    for name, group in out[0].items():
        for key, want in group.items():
            _close(got[name][key], want, 1e-4, f"{name}.{key}")


def test_moe_bf16_compute_dtype():
    """bf16 compute through the MoE dispatch: the token ids stay integer,
    the factors accumulate finite in f32 (JAX's own test: bf16 routes may
    differ from f32 ones in both packages alike)."""
    tm, _, _, toks, _ = _lm_pair(experts=2)
    est = port_est.KFAC(tm, loss="lm", compute_dtype=torch.bfloat16)
    est.update(torch.from_numpy(toks),
               generator=torch.Generator().manual_seed(2))
    assert all(torch.isfinite(v).all() for fac in est.state.values()
               for v in fac.values())
    assert est.state["h.0.moe.fc1"]["a"].dtype == torch.float32


def test_moe_inside_scanblocks_raises():
    """Both packages refuse an already-stacked layer in a ScanBlocks
    template with the same message; so does the MoE GPT-2 stacked."""
    class _JBody(jnn.Module):
        def __init__(self, prefix):
            self.name = prefix
            self.moe = jnn.MoE(8, 2, name=f"{prefix}.moe")

        def __call__(self, ctx, x):
            return self.moe(ctx, x)

    class _TBody(torch.nn.Module):
        def __init__(self, prefix):
            super().__init__()
            self.moe = tnn.MoE(8, 8, 2, name=f"{prefix}.moe")

        def forward(self, x, ctx=None):
            return self.moe(x, ctx)

    jm = jnn.Model(jnn.ScanBlocks(lambda p: _JBody(p), depth=2, name="blk"))
    with pytest.raises(ValueError, match="already-stacked") as want:
        jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 8)))
    with pytest.raises(ValueError, match="already-stacked") as got:
        tnn.ScanBlocks(lambda p: _TBody(p), 2, "blk")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="h.moe.fc1: already-stacked"):
        tmodels.gpt2_moe_tiny(scan_blocks=True, device="cpu")


def test_inf_on_gpt2_moe_tiny():
    """INF over the per-expert factors from JAX's Diagonal, KFAC and EFB
    states (and eigenbases): its state (1e-5), its Woodbury cache (1e-4,
    tests/test_torch_estimators.py's bar) and samples from JAX's draws
    (5e-4)."""
    tm, jm, jv, toks, labels = _lm_pair(experts=2, vocab=16)
    jt, jl = jnp.asarray(toks), jnp.asarray(labels)
    layers = ["h.0.moe.fc1", "h.0.moe.fc2", "h.1.attn.c_proj"]
    jk = jest.KFAC(jm, jv, loss="lm", layer_filter=layers)
    jk.update(jt, labels=jl)
    je = jest.EFB(jm, jv, jk.state, loss="lm", layer_filter=layers)
    je.update(jt, labels=jl)
    ji = jest.INF(jm, jv, je.diags, jk.state, je.state, eigvecs=je.eigvecs,
                  loss="lm", layer_filter=layers)
    ji.update(rank=6)

    def port(s):
        return tmodels.state_from_jax(s, "cpu")
    ti = port_est.INF(tm, port(je.diags), port(jk.state), port(je.state),
                      eigvecs=port(je.eigvecs), loss="lm",
                      layer_filter=layers)
    ti.update(rank=6)
    assert list(ti.metas) == list(ji.metas)
    assert ti.metas["h.0.moe.fc1"].moe
    _states_close(ti.state, ji.state, 1e-5, "inf")
    ji.invert(ADD, MULTIPLY)
    ti.invert(ADD, MULTIPLY)
    for name in ji.metas:
        _close(ti.inv_state[name]["pre"], ji.inv_state[name]["pre"], 1e-4,
               f"{name} pre")
    # JAX's INF draws: the layer keys split off in meta order, a stacked
    # layer's key split once more per expert (inf.py:500-519)
    rng, noise = jax.random.PRNGKey(7), {}
    for name, shape in ti.noise_shapes().items():
        rng, key = jax.random.split(rng)
        keys = jax.random.split(key, shape[0]) if len(shape) == 2 else [key]
        noise[name] = np.stack([np.array(jax.random.normal(
            k, shape[-1:], jnp.float32)) for k in keys]).reshape(shape)
    want = ji.sample(jax.random.PRNGKey(7))
    got = ti.sample(noise=noise)
    for name in ji.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")


def test_subspace_sketch_on_gpt2_moe_tiny():
    """The Subspace (Nystrom) sketch over the expert layers equals JAX's
    on JAX's omega (1e-4 of max: GGN products, the probe gradients' bar),
    and its logdet is JAX's."""
    tm, jm, jv, toks, labels = _lm_pair(experts=2, vocab=16)
    layers = ["h.0.moe.fc1", "h.1.moe.fc2", "lm_head"]
    je = jest.Subspace(jm, jv, rank=5, loss="lm", layer_filter=layers)
    je.update(jnp.asarray(toks), labels=jnp.asarray(labels[0]))
    omega = {n: np.array(v["omega"]) for n, v in je.state.items()}
    te = port_est.Subspace(tm, loss="lm", omega=omega, layer_filter=layers)
    assert te.rank == 5
    te.update(torch.from_numpy(toks), labels=torch.from_numpy(labels[0]))
    for name in je.state:
        _close(te.state[name]["sketch"], je.state[name]["sketch"], 1e-4,
               f"{name} sketch")
    np.testing.assert_allclose(te.logdet_precision(ADD, MULTIPLY),
                               float(je.logdet_precision(ADD, MULTIPLY)),
                               rtol=1e-4)


def test_converter_round_trip_and_meta_names():
    """JAX-layout variables -> the port's state dict -> back are the same
    numbers; the port's metas are JAX's, by name, order and fields
    (experts ``stacked=E, moe=True``, bias-free); the parameter groups
    and shapes are JAX's ``init``'s."""
    tm, jm, jv, _, _ = _lm_pair(experts=4)
    variables = jax.tree_util.tree_map(np.asarray, jv)
    back = tmodels.variables_to_jax(tm)
    assert set(back["params"]) == set(variables["params"])
    for layer, group in variables["params"].items():
        for key, arr in group.items():
            np.testing.assert_array_equal(back["params"][layer][key], arr,
                                          err_msg=f"{layer}.{key}")
    assert tm.state_dict()["h.0.moe.fc1.weight"].shape == (4, 256, 64)
    assert tm.state_dict()["h.0.moe.router.weight"].shape == (4, 64)
    assert list(tm.metas) == list(jm.metas)
    for name, m in jm.metas.items():
        t = tm.metas[name]
        assert (t.kind, t.out_features, t.fan_in, t.has_bias, t.stacked,
                t.moe, t.heads) == (m.kind, m.out_features, m.fan_in,
                                    m.has_bias, m.stacked, m.moe,
                                    m.heads), name
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    for layer, group in abstract["params"].items():
        for key, leaf in group.items():
            assert variables["params"][layer][key].shape == leaf.shape, layer


def test_build_needs_cuda_unless_cpu_is_passed():
    """``models.build('gpt2_moe_tiny')`` takes the CUDA device by default
    and raises without one; on the CPU it builds JAX's layers."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.build("gpt2_moe_tiny", 32)
    m = tmodels.build("gpt2_moe_tiny", 32, device="cpu", max_len=8)
    jm = jmodels.gpt2_moe_tiny(32, max_len=8)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8), jnp.int32)))
    assert list(m.metas) == list(jm.metas)


@pytest.fixture(scope="module")
def expert_runs(tmp_path_factory):
    """(each rank's results on expert:2,data:2, one process's)."""
    out = str(tmp_path_factory.mktemp("expert"))
    procs = W.start("expert", 4, out)
    try:
        single = W.run_expert()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return W.finish(procs, "expert", out), single


def test_expert_parallel_sharding_matches_single_device(expert_runs):
    """ep (JAX tests/test_moe.py:188-205): each rank holds its experts'
    weights and factors, [E/2, ...]; the gathered factors equal one
    process's and JAX's, the non-MoE layers stay whole, and the draws of
    invert + sample on the blocks equal one process's."""
    ranks, single = expert_runs
    for r in ranks:
        for k, v in single.items():
            rtol, atol = ((1e-4, 1e-5) if k.startswith("moe_kfac_sample")
                          else (1e-5, 1e-6))
            np.testing.assert_allclose(r[k], v, rtol=rtol, atol=atol,
                                       err_msg=k)
        assert tuple(r["shape/moe_kfac/moe/g"]) == (2, 16, 16)
        assert tuple(r["shape/moe_kfac/moe/a"]) == (2, 16, 16)
        assert tuple(r["shape/moe_kfac/head/g"]) == (5, 5)
    assert single["moe_kfac/moe/g"].shape == (4, 16, 16)
    jm, jv, _, x, labels = _build(experts=4)
    je = jest.KFAC(jm, jv)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    for name in je.metas:
        for key in ("a", "g"):
            _close(single[f"moe_kfac/{name}/{key}"], je.state[name][key],
                   1e-5, f"{name}.{key} vs JAX")
