"""Blocked-G KFAC for vocabulary-sized heads against the JAX package.

A dense layer whose out_features exceed ``max_factor_dim`` gets a
block-diagonal G of ``ceil(out / g_block_size)`` blocks over zero-padded
output features, sharing its A (JAX estimators/kfac.py ``_is_gblock``).
At reduced vocabulary (a scanned GPT-2 of vocab 43, dim 12; last-layer
Laplace on its ``lm_head`` with ``max_factor_dim=16``, ``g_block_size=16``:
3 blocks, 48 padded rows) the port's blocked state is held against JAX's
(A 1e-5, G 1e-4 of max) and against its own dense G's diagonal blocks; the
invert, the samples (JAX's draws), logdet, quadratic form and solve against
JAX with JAX's state fed to the port (1e-4; samples 5e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels

torch.set_num_threads(1)

VOCAB, DIM, DEPTH, HEADS, CTX = 43, 12, 2, 2, 16
MFD, BS = 16, 16                 # 3 blocks, padded to 48
ADD, MULTIPLY = 0.7, 3.0


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, rel, what):
    """Within ``rel`` of max|want|."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.fixture(scope="module")
def problem():
    tm = tmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=True,
                             device="cpu")
    variables = tmodels.seeded_variables(tm, 0)
    tmodels.load_jax_variables(tm, variables)
    jm = jmodels.gpt2_custom(VOCAB, DIM, DEPTH, HEADS, CTX, scan_blocks=True)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, CTX), jnp.int32)))
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    rng = np.random.default_rng(2)
    tok = rng.integers(0, VOCAB, (4, 8)).astype(np.int32)
    labels = rng.integers(0, VOCAB, (2, 4, 8)).astype(np.int32)
    kw = dict(loss="lm", layer_filter="last")
    blocked = port_est.KFAC(tm, max_factor_dim=MFD, g_block_size=BS, **kw)
    blocked.update(torch.from_numpy(tok), labels=torch.from_numpy(labels))
    dense = port_est.KFAC(tm, **kw)
    dense.update(torch.from_numpy(tok), labels=torch.from_numpy(labels))
    j = jest.KFAC(jm, jv, max_factor_dim=MFD, g_block_size=BS, **kw)
    j.update(jnp.asarray(tok), labels=jnp.asarray(labels))
    j.invert(ADD, MULTIPLY)
    fed = port_est.KFAC(tm, max_factor_dim=MFD, g_block_size=BS, **kw)
    fed.state = tmodels.state_from_jax(j.state, "cpu")
    fed.invert(ADD, MULTIPLY)
    return dict(tm=tm, blocked=blocked, dense=dense, j=j, fed=fed)


def test_head_is_blocked(problem):
    b = problem["blocked"]
    assert b._is_gblock(b.metas["lm_head"])
    assert b._gblock_dims(b.metas["lm_head"]) == (3, BS, 48)
    assert b.state["lm_head"]["g"].shape == (3, BS, BS)
    assert b.state["lm_head"]["a"].shape == (DIM, DIM)       # no bias
    assert b.noise_shapes() == {"lm_head": (3, DIM, BS)}


def test_blocked_factors_match_jax(problem):
    b, j = problem["blocked"], problem["j"]
    _close(b.state["lm_head"]["a"], j.state["lm_head"]["a"], 1e-5, "A")
    _close(b.state["lm_head"]["g"], j.state["lm_head"]["g"], 1e-4, "G")


def test_blocks_are_the_dense_g_diagonal_blocks(problem):
    """The blocks equal the dense G's diagonal blocks (padded with zeros):
    the padded tail's rows and columns are exactly zero; A is shared."""
    g_dense = problem["dense"].state["lm_head"]["g"]
    g_blk = problem["blocked"].state["lm_head"]["g"]
    padded = torch.zeros(48, 48)
    padded[:VOCAB, :VOCAB] = g_dense
    for k in range(3):
        _close(g_blk[k], padded[k * BS:(k + 1) * BS, k * BS:(k + 1) * BS],
               1e-6, f"block {k}")
    tail = VOCAB - 2 * BS
    assert torch.count_nonzero(g_blk[2, tail:, :]) == 0
    assert torch.count_nonzero(g_blk[2, :, tail:]) == 0
    _close(problem["blocked"].state["lm_head"]["a"],
           problem["dense"].state["lm_head"]["a"], 1e-6, "shared A")
    # the block traces sum to the dense G's trace
    assert torch.isclose(torch.diagonal(g_blk, dim1=-2, dim2=-1).sum(),
                         torch.trace(g_dense), rtol=1e-5)


def test_g_block_size_zero_restores_the_hard_error(problem):
    with pytest.raises(ValueError, match="max_factor_dim=16"):
        port_est.KFAC(problem["tm"], loss="lm", layer_filter="last",
                      max_factor_dim=MFD, g_block_size=0)
    # the A side is never blocked
    with pytest.raises(ValueError, match="A-factor dimension"):
        port_est.KFAC(problem["tm"], loss="lm", layer_filter="last",
                      max_factor_dim=DIM, g_block_size=BS)


def test_inverse_and_samples_match_jax(problem):
    j, t = problem["j"], problem["fed"]
    for key in ("a_chol", "g_chol"):
        _close(t.inv_state["lm_head"][key], j.inv_state["lm_head"][key],
               1e-4, key)
    want = j.sample(jax.random.PRNGKey(5))
    _, key = jax.random.split(jax.random.PRNGKey(5))
    z = np.array(jax.random.normal(key, (3, DIM, BS), jnp.float32))
    got = t.sample(noise={"lm_head": z})
    assert got["lm_head"].shape == (VOCAB, DIM)
    _close(got["lm_head"], want["lm_head"], 5e-4, "sample")


def test_gaussian_api_matches_jax(problem):
    """logdet over the real out_features only (the padded dims' damping
    subtracted), quadratic form and solve with zero-padded rows."""
    j, t = problem["j"], problem["fed"]
    want = j.logdet_precision(ADD, MULTIPLY)
    got = t.logdet_precision(ADD, MULTIPLY)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    d = (0.1 * np.random.default_rng(6).standard_normal((VOCAB, DIM))
         ).astype(np.float32)
    want = j.quadratic_form({"lm_head": jnp.asarray(d)}, ADD, MULTIPLY)
    got = t.quadratic_form({"lm_head": d}, ADD, MULTIPLY)
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    want = j.precision_solve({"lm_head": jnp.asarray(d)}, ADD, MULTIPLY)
    got = t.precision_solve({"lm_head": d}, ADD, MULTIPLY)
    _close(got["lm_head"], want["lm_head"], 1e-4, "solve")
