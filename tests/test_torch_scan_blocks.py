"""Depth-stacked (ScanBlocks) layers through the estimator ladder against
the JAX package, on a small scanned GPT-2 (vocab 61, dim 32, 2 blocks of
2 heads) with the per-token Fisher (``loss='lm'``).

Both packages get the same seeded weights, tokens [3, 8] and injected
labels. KFAC, Diagonal and BlockDiagonal (on the stacked
``h.attn.c_proj``) are updated in each; EFB and INF are built from JAX's
KFAC factors, with JAX's eigenvectors (eigh picks its basis freely inside
degenerate eigenspaces) and, for INF, EFB's diags and lambdas. The inverse
states, samples (JAX's draws rebuilt), logdet, quadratic form and solve
are compared with JAX's state fed to the port. Bars, relative to max|JAX
value|: A 1e-5, G and every other state 1e-4, inverse states 1e-4,
samples 5e-4. A stacked slice equals the unrolled model's layer.

The stacked probes' gradients are bit for bit those of the former
design (one ``[depth, ...]`` leaf indexed per depth), and their backward
runs no ``[depth, ...]``-sized zero fill, slice copy or add.
"""
import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.estimators.capture import ce_cotangent, collect
from curvature_tpu_torch.nn.core import Context
from curvature_tpu_torch.utils import monitor

torch.set_num_threads(1)

VOCAB, DIM, DEPTH, HEADS, CTX = 61, 32, 2, 2, 16
ADD, MULTIPLY = 1.0, 50.0
RANK = 8
BLOCK = "h.attn.c_proj"
KINDS = ("kfac", "diag", "block", "efb", "inf")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _to_port(state):
    return tmodels.state_from_jax(state, "cpu")


def _data():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, VOCAB, (3, 8)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (1, 3, 8)).astype(np.int32)
    return tok, labels


@pytest.fixture(scope="module")
def ladder():
    tm = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=True,
                             device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=True)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, CTX), jnp.int32)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tok, labels = _data()
    jx, jl = jnp.asarray(tok), jnp.asarray(labels)
    tx, tl = torch.from_numpy(tok), torch.from_numpy(labels)

    j, t = {}, {}
    for kind, cls, kw in (("kfac", "KFAC", {}), ("diag", "Diagonal", {}),
                          ("block", "BlockDiagonal",
                           {"layer_filter": BLOCK})):
        j[kind] = getattr(jest, cls)(jm, jv, loss="lm", **kw)
        t[kind] = getattr(port_est, cls)(tm, loss="lm", **kw)
        j[kind].update(jx, labels=jl)
        t[kind].update(tx, labels=tl)
    kfac_state = _to_port(j["kfac"].state)
    j["efb"] = jest.EFB(jm, jv, j["kfac"].state, loss="lm")
    j["efb"].update(jx, labels=jl)
    t["efb"] = port_est.EFB(tm, kfac_state, loss="lm")
    t["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    t["efb"].update(tx, labels=tl)
    j["inf"] = jest.INF(jm, jv, j["efb"].diags, j["kfac"].state,
                        j["efb"].state, eigvecs=j["efb"].eigvecs)
    j["inf"].update(rank=RANK)
    t["inf"] = port_est.INF(tm, _to_port(j["efb"].diags), kfac_state,
                            _to_port(j["efb"].state),
                            eigvecs=_to_port(j["efb"].eigvecs))
    t["inf"].update(rank=RANK)
    fed = {"inf": t["inf"]}
    for kind in ("kfac", "diag", "block"):
        fed[kind] = type(t[kind])(tm, loss="lm",
                                  layer_filter=list(j[kind].metas))
        fed[kind].state = _to_port(j[kind].state)
    fed["efb"] = port_est.EFB(tm, kfac_state, loss="lm")
    fed["efb"].eigvecs = _to_port(j["efb"].eigvecs)
    fed["efb"].state = _to_port(j["efb"].state)
    for kind in KINDS:
        assert list(fed[kind].metas) == list(j[kind].metas), kind
        j[kind].invert(ADD, MULTIPLY)
        fed[kind].invert(ADD, MULTIPLY)
    return dict(tm=tm, jm=jm, jv=jv, variables=variables, tok=tok,
                labels=labels, j=j, t=t, fed=fed)


def test_stacked_layers_are_registered(ladder):
    t = ladder["t"]["kfac"]
    stacked = {n: m.stacked for n, m in t.metas.items()}
    assert stacked == {"h.attn.c_attn": DEPTH, "h.attn.c_proj": DEPTH,
                       "h.mlp.c_fc": DEPTH, "h.mlp.c_proj": DEPTH,
                       "lm_head": 0}
    assert t.state["h.mlp.c_proj"]["a"].shape == (DEPTH, 4 * DIM + 1,
                                                  4 * DIM + 1)
    assert t.state["h.attn.c_attn"]["g"].shape == (DEPTH, 3 * DIM, 3 * DIM)
    assert ladder["tm"].state_dict()["h.attn.c_attn.weight"].shape == (
        DEPTH, 3 * DIM, DIM)


def test_kfac_factors_match_jax(ladder):
    """Per-depth A Grams of the [depth, N, cols] tokens and G Grams of the
    [S, depth, ...] probe gradients, scaled by the B*T observation count."""
    j, t = ladder["j"]["kfac"], ladder["t"]["kfac"]
    for name in j.metas:
        _close(t.state[name]["a"], j.state[name]["a"], 1e-5, f"{name} A")
        _close(t.state[name]["g"], j.state[name]["g"], 1e-4, f"{name} G")


@pytest.mark.parametrize("kind", ["diag", "block", "efb", "inf"])
def test_stacked_states_match_jax(ladder, kind):
    j, t = ladder["j"][kind], ladder["t"][kind]
    assert list(t.metas) == list(j.metas)
    want = dict(_leaves(j.state))
    got = dict(_leaves(t.state))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        _close(got[key], w, 1e-4, f"{kind} {key}")
    if kind == "efb":
        for name in j.metas:
            _close(t.diags[name], j.diags[name], 1e-4, f"efb diags {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_inverse_states_match_jax(ladder, kind):
    j, t = ladder["j"][kind], ladder["fed"][kind]
    want = dict(_leaves(j.inv_state))
    got = dict(_leaves(t.inv_state))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        _close(got[key], w, 1e-4, f"{kind} {key}")


def _jax_noise(j, t, seed):
    """JAX's draws at the port's noise shapes: one key per layer in meta
    order; INF draws a stacked layer's depths from ``split(key, depth)``
    (JAX inf.py:506-512)."""
    rng = jax.random.PRNGKey(seed)
    noise = {}
    for name, shape in t.noise_shapes().items():
        rng, key = jax.random.split(rng)
        depth = t.metas[name].stacked
        if isinstance(t, port_est.INF) and depth:
            noise[name] = np.stack([np.array(jax.random.normal(
                k, shape[1:], jnp.float32))
                for k in jax.random.split(key, depth)])
        else:
            noise[name] = np.array(jax.random.normal(key, shape,
                                                     jnp.float32))
    assert list(noise) == list(j.metas)
    return noise


@pytest.mark.parametrize("kind", KINDS)
def test_samples_match_jax_with_the_same_draws(ladder, kind):
    j, t = ladder["j"][kind], ladder["fed"][kind]
    want = j.sample(jax.random.PRNGKey(5))
    got = t.sample(noise=_jax_noise(j, t, 5))
    for name in j.metas:
        _close(got[name], want[name], 5e-4, f"{name} sample")


def _deltas(j, seed):
    rng = np.random.default_rng(seed)
    return {name: (0.01 * rng.standard_normal(
        ((m.stacked,) if m.stacked else ()) + (m.out_features, m.mat_cols))
    ).astype(np.float32) for name, m in j.metas.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_gaussian_api_matches_jax(ladder, kind):
    """logdet 1e-5 relative; quadratic form 1e-4 relative; solve 1e-4 of
    max, with JAX's state."""
    j, t = ladder["j"][kind], ladder["fed"][kind]
    want = j.logdet_precision(ADD, MULTIPLY)
    got = t.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    d = _deltas(j, 6)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    want = j.quadratic_form(jd, ADD, MULTIPLY)
    got = t.quadratic_form(d, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    want = j.precision_solve(jd, ADD, MULTIPLY)
    got = t.precision_solve(d, ADD, MULTIPLY)
    for name in j.metas:
        _close(got[name], want[name], 1e-4, f"{name} solve")


def test_log_density_of_a_posterior_draw_matches_jax(ladder):
    """KFAC: the log-density at MAP + one draw (the same draw in both),
    whose stacked offsets land on the [depth, ...] weights."""
    j, t = ladder["j"]["kfac"], ladder["fed"]["kfac"]
    jp = j.posterior_params(jax.random.PRNGKey(7))
    tp = t.posterior_params(noise=_jax_noise(j, t, 7))
    assert tp["h.mlp.c_fc.weight"].shape == (DEPTH, 4 * DIM, DIM)
    for name in j.metas:
        _close(tp[f"{name}.weight"],
               np.swapaxes(np.asarray(jp[name]["kernel"]), -1, -2), 5e-4,
               name)
    want = j.log_density(jp, ADD, MULTIPLY)
    got = t.log_density(tp, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_stacked_slice_equals_unrolled_layer(ladder):
    """Depth slice i of the stacked KFAC and Diagonal states equals the
    unrolled model's ``h.{i}.*`` layer with the same weights and labels."""
    tm, variables = ladder["tm"], ladder["variables"]
    flat = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, device="cpu")
    tmodels.load_jax_variables(flat,
                               tmodels.unstack_scan_groups(variables, tm))
    tok, labels = (torch.from_numpy(a) for a in _data())
    for cls, bars in ((port_est.KFAC, {"a": 1e-5, "g": 1e-4}),
                      (port_est.Diagonal, {None: 1e-4})):
        stacked = ladder["t"]["kfac" if cls is port_est.KFAC else "diag"]
        unrolled = cls(flat, loss="lm")
        unrolled.update(tok, labels=labels)
        for name, meta in stacked.metas.items():
            for i in range(meta.stacked):
                flat_name = name.replace("h.", f"h.{i}.", 1)
                for key, bar in bars.items():
                    got = stacked.state[name]
                    want = unrolled.state[flat_name]
                    if key is not None:
                        got, want = got[key], want[key]
                    _close(got[i], want, bar, f"{flat_name} {key}")


def _stacked_gpt2(depth):
    torch.manual_seed(depth)
    m = tmodels.gpt2_custom(VOCAB, DIM, depth, HEADS, CTX, scan_blocks=True,
                            device="cpu")
    return m, port_est.KFAC(m, loss="lm", layer_filter="h.*").metas


def _indexed_leaf_probe_grads(model, metas, x, labels):
    """The former stacked probe: one zero ``[depth, ...]`` leaf per layer,
    made at depth 0 and indexed per depth; ``[S, depth, ...]`` gradients."""
    ctx, leaves = Context(track=metas), {}

    def probe(name, y):
        if name not in metas:
            return y
        i, depth = ctx.scan
        if i == 0:
            leaves[name] = y.new_zeros((depth,) + y.shape, requires_grad=True)
        return y + leaves[name][i]
    ctx.probe = probe
    logits = model(x, ctx)
    grads = [torch.autograd.grad(logits, list(leaves.values()),
                                 ce_cotangent(logits, labels[s:s + 1])[0],
                                 retain_graph=True)
             for s in range(labels.shape[0])]
    return {n: torch.stack([g[k] for g in grads])
            for k, n in enumerate(leaves)}


@pytest.mark.parametrize("depth", [3, 12])
@pytest.mark.parametrize("samples", [1, 2])
def test_stacked_probe_grads_equal_the_indexed_leaf(depth, samples):
    """Per-depth probe leaves give the former design's gradients exactly,
    in one contiguous ``[S, depth, B, T, out]`` tensor per layer."""
    m, metas = _stacked_gpt2(depth)
    x = torch.randint(0, VOCAB, (3, 8))
    labels = torch.randint(0, VOCAB, (samples, 3, 8))
    cap = collect(m, metas, x, labels=labels, need_param_grads=False,
                  loss="lm")
    want = _indexed_leaf_probe_grads(m, metas, x, labels)
    assert list(cap.probe_grads) == list(metas)
    for name, meta in metas.items():
        got = cap.probe_grads[name]
        assert got.shape == (samples, depth, 3, 8, meta.out_features), name
        assert got.is_contiguous(), name
        assert torch.equal(got, want[name]), name


def _probe_slots(model, metas, x, **kw):
    with monitor.tracing():
        monitor.clear_spans()
        collect(model, metas, x, need_param_grads=False,
                generator=torch.Generator().manual_seed(0), **kw)
        spans = [s for s in monitor.spans() if s.name == "capture.backward"]
        monitor.clear_spans()
    assert len(spans) == 1
    return spans[0].attrs["probe_slots"]


def test_stacked_probe_backward_is_linear_in_depth():
    """A depth-12 stacked capture's backward runs no ``select_backward``
    and no in-place add on a ``[depth, ...]`` tensor (the former design
    ran 4 * 12 of the first and 4 * 11 of the second), and its
    ``capture.backward`` span counts 4 * 12 probe leaves."""
    depth = 12
    m, metas = _stacked_gpt2(depth)
    x = torch.randint(0, VOCAB, (3, 8))
    labels = torch.randint(0, VOCAB, (1, 3, 8))
    with torch.profiler.profile(record_shapes=True) as prof:
        collect(m, metas, x, labels=labels, need_param_grads=False,
                loss="lm")
    ops = collections.Counter(e.name for e in prof.events())
    assert ops["aten::select_backward"] == 0
    stacked = [e.input_shapes for e in prof.events()
               if e.name in ("aten::add_", "aten::add", "aten::zeros",
                             "aten::copy_")
               and any(len(s) == 4 and s[:3] == [depth, 3, 8]
                       for s in e.input_shapes)]
    assert not stacked, stacked
    assert _probe_slots(m, metas, x, loss="lm") == 4 * depth


def test_unstacked_capture_has_no_probe_slots():
    """An unrolled model's probes are one leaf per layer: no slots."""
    torch.manual_seed(0)
    m = tmodels.resnet18(num_classes=10, device="cpu")
    metas = port_est.KFAC(m).metas
    assert _probe_slots(m, metas, torch.randn(2, 3, 32, 32)) == 0
