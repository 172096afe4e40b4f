"""GPT-2 in the port against the JAX package: logits (depth-stacked and
unrolled), the causal mask, the per-token capture (``loss='lm'``), the
weight converters (JAX variables, Hugging Face names), bf16 with integer
tokens, and the per-token sufficient-statistics eval.

A small GPT-2 (vocab 97, dim 32, 2 blocks, 2 heads, context 16) gets the
same seeded numpy weights in both packages (``models.seeded_variables``),
the same tokens and the same injected labels. Bars are relative to the
largest magnitude of the JAX value: logits and probabilities 1e-5, probe
and parameter gradients 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.estimators import capture as jcapture
from curvature_tpu.eval import evaluate as jeval
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.estimators import capture as tcapture
from curvature_tpu_torch.eval import evaluate as teval

torch.set_num_threads(1)

VOCAB, DIM, DEPTH, HEADS, CTX = 97, 32, 2, 2, 16


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _tokens(batch=3, t=11, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, VOCAB, size=(batch, t)).astype(np.int32)


def _pair(scan):
    """(port model, JAX model, JAX-layout numpy variables)."""
    tm = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=scan,
                             device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX,
                             scan_blocks=scan)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, CTX), jnp.int32)))
    return tm, jm, variables


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scan"])
def pair(request):
    return _pair(request.param)


def _jv(variables):
    return jax.tree_util.tree_map(jnp.asarray, variables)


def test_layers_and_names_match_jax(pair):
    tm, jm, variables = pair
    assert list(tm.metas) == list(jm.metas)
    for name, m in jm.metas.items():
        t = tm.metas[name]
        assert (t.out_features, t.fan_in, t.has_bias, t.stacked, t.heads) \
            == (m.out_features, m.fan_in, m.has_bias, m.stacked, m.heads), \
            name
    assert tm.scan_groups == jm.scan_groups
    jv = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CTX), jnp.int32))
    for layer, group in jv["params"].items():
        for k, arr in group.items():
            assert variables["params"][layer][k].shape == arr.shape, layer


def test_logits_match_jax(pair):
    tm, jm, variables = pair
    tok = _tokens()
    want, _ = jm.apply(_jv(variables), jnp.asarray(tok), train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(tok))
    _close(got, want, 1e-5, "logits")


def test_scan_blocks_match_unrolled():
    """The stacked model and the unrolled one with the same weights
    (``unstack_scan_groups``) give the same logits."""
    scan, _, variables = _pair(True)
    flat = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, device="cpu")
    tmodels.load_jax_variables(
        flat, tmodels.unstack_scan_groups(variables, scan))
    again = tmodels.stack_scan_groups(
        tmodels.unstack_scan_groups(variables, scan), scan)
    assert set(again["params"]) == set(variables["params"])
    tok = torch.from_numpy(_tokens())
    with torch.no_grad():
        _close(scan(tok), flat(tok), 1e-5, "scan vs unrolled")


def test_causal_mask_blocks_future():
    """Perturbing a future token must not change earlier logits."""
    tm, _, _ = _pair(True)
    tok = torch.from_numpy(_tokens(batch=1, t=6))
    tok2 = tok.clone()
    tok2[0, 5] = (tok[0, 5] + 1) % VOCAB
    with torch.no_grad():
        out1, out2 = tm(tok), tm(tok2)
    torch.testing.assert_close(out1[0, :5], out2[0, :5], rtol=0, atol=1e-6)
    assert not torch.allclose(out1[0, 5], out2[0, 5])


def test_lm_sample_labels_per_token():
    logits = torch.randn(3, 7, VOCAB, generator=torch.Generator()
                         .manual_seed(0))
    lab = tcapture.sample_labels(logits, 4, torch.Generator().manual_seed(1))
    assert lab.shape == (4, 3, 7)
    assert int(lab.min()) >= 0 and int(lab.max()) < VOCAB


@pytest.mark.parametrize("labels_rank", [2, 3], ids=["BT", "SBT"])
def test_lm_capture_matches_jax(pair, labels_rank):
    """Explicit [B, T] labels are one sample, [S, B, T] are S; the
    observation count is B*T; probe and parameter gradients of the mean
    token loss within 1e-4 of max (stacked layers [S, depth, ...])."""
    tm, jm, variables = pair
    tok = _tokens(batch=3, t=8)
    labels = _tokens(batch=3, t=8, seed=2)
    if labels_rank == 3:
        labels = np.stack([labels, _tokens(batch=3, t=8, seed=3)])
    want = jcapture.collect(jm, jm.metas, _jv(variables), jnp.asarray(tok),
                            labels=jnp.asarray(labels), loss="lm")
    got = tcapture.collect(tm, tm.metas, torch.from_numpy(tok),
                           labels=torch.from_numpy(labels), loss="lm")
    assert got.batch_size == want.batch_size == 3 * 8
    _close(got.logits, want.logits, 1e-5, "logits")
    for name in jm.metas:
        _close(got.acts[name], want.acts[name], 1e-5, f"{name} act")
        _close(got.probe_grads[name], want.probe_grads[name], 1e-4,
               f"{name} probe grad")
        _close(got.param_grads[name], want.param_grads[name], 1e-4,
               f"{name} param grad")


def _hf_state_dict(seed=0):
    """Seeded arrays under Hugging Face ``GPT2LMHeadModel`` names: Conv1D
    weights [in, out], the causal-mask buffers, no ``lm_head`` (tied)."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)
    sd = {"transformer.wte.weight": n(VOCAB, DIM),
          "transformer.wpe.weight": n(CTX, DIM, std=0.01)}
    for i in range(DEPTH):
        p = f"transformer.h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = 1.0 + n(DIM, std=0.1)
            sd[f"{p}.{ln}.bias"] = n(DIM)
        for layer, (i_f, o_f) in (("attn.c_attn", (DIM, 3 * DIM)),
                                  ("attn.c_proj", (DIM, DIM)),
                                  ("mlp.c_fc", (DIM, 4 * DIM)),
                                  ("mlp.c_proj", (4 * DIM, DIM))):
            sd[f"{p}.{layer}.weight"] = n(i_f, o_f)
            sd[f"{p}.{layer}.bias"] = n(o_f)
        sd[f"{p}.attn.bias"] = np.tril(np.ones((1, 1, CTX, CTX), np.float32))
        sd[f"{p}.attn.masked_bias"] = np.asarray(-1e4, np.float32)
    sd["transformer.ln_f.weight"] = 1.0 + n(DIM, std=0.1)
    sd["transformer.ln_f.bias"] = n(DIM)
    return sd


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_hf_converter_matches_jax(scan):
    """The same HF-named dict through JAX's ``convert_gpt2_state_dict``
    (its variables applied by the JAX model) and the port's (loaded
    strictly): the same logits; the head is ``wte`` untied."""
    sd = _hf_state_dict()
    jv = jmodels.convert_gpt2_state_dict(sd)
    jm = jmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, CTX), jnp.int32)))
    tok = _tokens()
    want, _ = jm.apply(_jv(jv), jnp.asarray(tok), train=False)
    tm = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=scan,
                             device="cpu")
    port_sd = tmodels.convert_gpt2_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tm)
    tm.load_state_dict(port_sd, strict=True)
    np.testing.assert_array_equal(port_sd["lm_head.weight"].numpy(),
                                  sd["transformer.wte.weight"])
    with torch.no_grad():
        _close(tm(torch.from_numpy(tok)), want, 1e-5, "logits")


def test_bfloat16_with_integer_tokens():
    """Under ``compute_dtype=bfloat16`` the token ids pass the casts
    unchanged: the update, the eval forward and the ensemble run finite
    (JAX tests/test_gpt.py:171)."""
    tm, _, _ = _pair(True)
    tok = torch.from_numpy(_tokens(batch=4, t=8))
    est = port_est.Diagonal(tm, loss="lm", compute_dtype=torch.bfloat16)
    est.update(tok, generator=torch.Generator().manual_seed(1))
    assert all(torch.isfinite(v).all() for v in est.state.values())
    p, y = teval.eval_nn(tm, [(tok, tok)], compute_dtype=torch.bfloat16)
    assert p.shape == (4 * 8, VOCAB) and np.isfinite(p).all()
    assert y.shape == (4 * 8,)
    est.invert(1.0, 1.0)
    ens = est.ensemble_params(2, generator=torch.Generator().manual_seed(2))
    pb, _, _ = teval.eval_bnn(tm, est, [(tok, tok)], 2, ensemble_params=ens,
                              compute_dtype=torch.bfloat16)
    assert pb.shape == (4 * 8, VOCAB) and np.isfinite(pb).all()


def test_eval_stats_match_jax():
    """``eval_nn_stats`` and ``eval_bnn_stats`` (JAX's 3-sample Diagonal
    ensemble, fed to the port member by member) against JAX's, per token
    (1e-5 of max per column), and the stats equal the full probabilities'
    reduction."""
    tm, jm, variables = _pair(True)
    jv = _jv(variables)
    data = [(_tokens(batch=2, t=8, seed=s), _tokens(batch=2, t=8, seed=s + 9))
            for s in (4, 5)]
    tdata = [(torch.from_numpy(x), y) for x, y in data]
    want, wl = jeval.eval_nn_stats(jm, jv, data)
    got, gl = teval.eval_nn_stats(tm, tdata)
    np.testing.assert_array_equal(gl, wl)
    assert got.shape == (2 * 2 * 8, 4)
    for c, col in enumerate(teval.STATS_COLUMNS):
        _close(got[:, c], want[:, c], 1e-5, f"nn {col}")
    probs, _ = teval.eval_nn(tm, tdata)
    _close(got[:, 0], probs[np.arange(len(gl)), gl], 1e-6, "p_label")

    je = jest.Diagonal(jm, jv, loss="lm")
    je.update(jnp.asarray(data[0][0]), labels=jnp.asarray(data[0][1]))
    je.invert(1.0, 100.0)
    key = jax.random.PRNGKey(3)
    want, _ = jeval.eval_bnn_stats(jm, jv, je, data, 3, key)
    ens = je.ensemble_params(key, 3)
    members = [tmodels.state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda a, i=i: np.asarray(a[i]), ens)}) for i in range(3)]
    te = port_est.Diagonal(tm, loss="lm")
    got, _ = teval.eval_bnn_stats(tm, te, tdata, 3, ensemble_params=members)
    for c, col in enumerate(teval.STATS_COLUMNS):
        _close(got[:, c], want[:, c], 1e-5, f"bnn {col}")


def test_build_runs_on_cuda_unless_cpu_is_passed():
    """``models.build('gpt2', ...)`` and the GPT-2 constructors take the
    CUDA device by default and raise without one; ``device='cpu'`` builds
    on the CPU with the stacked parameters under JAX's names."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.build("gpt2", 50257, scan_blocks=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.gpt2_tiny()
    tiny = tmodels.build("gpt2_tiny", 256, device="cpu", scan_blocks=True,
                         max_len=32)
    assert tiny.wpe.weight.shape == (32, 64)
    assert tiny.state_dict()["h.mlp.c_fc.weight"].shape == (2, 256, 64)
