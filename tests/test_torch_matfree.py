"""The matrix-free exact-curvature operators (``ops/matfree.py``) and the
fidelity report (``eval/fidelity.py``) of the port against the JAX
package, and against the port's own dense GGN in float64.

The model pairs are ``tests/torch_exact.py``'s (MLP, a BatchNorm net, a
grouped/depthwise net, a depth-scanned ViT), both packages loaded with the
same numpy-seeded weights and fed the same numpy inputs. Every random draw
(probes, Lanczos's start vector, the labels the estimators are fitted on)
is made once, by JAX or numpy, and injected into both. Each test states
its tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from curvature_tpu import estimators as jest
from curvature_tpu.eval.fidelity import fidelity_report as j_fidelity
from curvature_tpu.ops import matfree as jmf
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.eval.fidelity import fidelity_report
from curvature_tpu_torch.ops import matfree as tmf

from tests.torch_exact import (
    ARCHS, close, jv, np_, pair, running_stats, to_jax, to_torch)

torch.set_num_threads(1)

LOSSES = ("cross_entropy", "gaussian")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    tm, jm, variables, x, tx = pair(request.param)
    jmetas = jest.Diagonal(jm, jv(variables)).metas
    tmetas = port_est.Diagonal(tm).metas
    assert list(jmetas) == list(tmetas)
    return dict(name=request.param, tm=tm, jm=jm, jv=jv(variables), x=x,
                tx=tx, jmetas=jmetas, tmetas=tmetas)


def _normal_probe(shapes, seed):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


def test_delta_shapes_match_jax(arch):
    """Stacked layers carry their [depth] axis, grouped convs their
    per-group columns: exactly JAX's shapes."""
    want = jmf.delta_shapes(arch["jmetas"])
    assert tmf.delta_shapes(arch["tmetas"]) == {
        n: tuple(s) for n, s in want.items()}


@pytest.mark.parametrize("loss", LOSSES)
def test_ggn_quad_matches_jax(arch, loss):
    """v^T F v of a normal probe: 1e-5 relative."""
    v = _normal_probe(tmf.delta_shapes(arch["tmetas"]), 3)
    want = float(jmf.ggn_quad(arch["jm"], arch["jmetas"], arch["jv"],
                              jnp.asarray(arch["x"]), to_jax(v), loss=loss))
    got = float(tmf.ggn_quad(arch["tm"], arch["tmetas"], arch["tx"],
                             to_torch(v), loss=loss))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("loss", LOSSES)
def test_ggn_matvec_matches_jax(arch, loss):
    """F v per layer within 1e-5 of max of JAX's (2e-5 on the ViT, whose
    softmax attention sums longer f32 chains)."""
    v = _normal_probe(tmf.delta_shapes(arch["tmetas"]), 4)
    want = jmf.ggn_matvec(arch["jm"], arch["jmetas"], arch["jv"],
                          jnp.asarray(arch["x"]), to_jax(v), loss=loss)
    got = tmf.ggn_matvec(arch["tm"], arch["tmetas"], arch["tx"],
                         to_torch(v), loss=loss)
    bar = 2e-5 if arch["name"] == "stacked" else 1e-5
    for n in want:
        close(got[n], want[n], bar, n)


def test_exact_products_leave_running_statistics(arch):
    """The train-mode forwards of ggn_quad, ggn_matvec and Lanczos move no
    BatchNorm running statistic (JAX discards its new batch_stats)."""
    tm, metas = arch["tm"], arch["tmetas"]
    before = running_stats(tm)
    v = to_torch(_normal_probe(tmf.delta_shapes(metas), 5))
    tmf.ggn_quad(tm, metas, arch["tx"], v)
    tmf.ggn_matvec(tm, metas, arch["tx"], v)
    tmf.lanczos_topk(lambda d: tmf.ggn_matvec(tm, metas, arch["tx"], d), v,
                     2, torch.Generator().manual_seed(0))
    after = running_stats(tm)
    assert set(before) == set(after)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert tm.training


# -- the port against its own dense GGN, in float64 -------------------------

@pytest.fixture(scope="module")
def dense64():
    """The MLP in float64 and its [p, p] GGN from an explicit Jacobian in
    the matrix-view coordinates, for both losses."""
    tm, _, _, _, tx = pair("mlp")
    tm = tm.double()
    tx = tx.double()
    metas = port_est.Diagonal(tm).metas
    shapes = tmf.delta_shapes(metas)
    zeros = {n: torch.zeros(s, dtype=torch.float64) for n, s in
             shapes.items()}
    flat0 = tmf._flatten(zeros)
    primals, f = tmf._forward_fn(tm, metas, tx)

    def out(flat):
        return f({k: primals[k] + t for k, t in tmf._tangent(
            metas, primals, tmf._unflatten(flat, zeros)).items()})

    jac = torch.func.jacrev(out)(flat0)                  # [B, K, p]
    logits = out(flat0)
    dense = {}
    for loss in LOSSES:
        if loss == "gaussian":
            h = torch.eye(logits.shape[-1], dtype=torch.float64).expand(
                logits.shape[0], -1, -1)
        else:
            p = torch.softmax(logits, -1)
            h = torch.diag_embed(p) - p[:, :, None] * p[:, None, :]
        dense[loss] = torch.einsum("bkp,bkl,blq->pq", jac, h,
                                   jac) / tx.shape[0]
    return dict(tm=tm, tx=tx, metas=metas, zeros=zeros, dense=dense)


@pytest.mark.parametrize("loss", LOSSES)
def test_ggn_matvec_dense_parity(dense64, loss):
    """Every basis vector's F e_i against the dense GGN's column, float64:
    1e-12 of max."""
    d = dense64
    p = tmf._flatten(d["zeros"]).numel()
    cols = []
    for i in range(p):
        e = torch.zeros(p, dtype=torch.float64)
        e[i] = 1.0
        out = tmf.ggn_matvec(d["tm"], d["metas"], d["tx"],
                             tmf._unflatten(e, d["zeros"]), loss=loss)
        cols.append(tmf._flatten(out))
    close(torch.stack(cols, 1), np_(d["dense"][loss]), 1e-12)


def test_ggn_quad_matches_matvec(dense64):
    """v^T F v (one jvp) equals <v, F v> (jvp + vjp), float64: 1e-12
    relative; it is non-negative."""
    d = dense64
    v = to_torch(_normal_probe(tmf.delta_shapes(d["metas"]), 3),
                 torch.float64)
    q = float(tmf.ggn_quad(d["tm"], d["metas"], d["tx"], v))
    fv = tmf.ggn_matvec(d["tm"], d["metas"], d["tx"], v)
    dot = float(sum((v[n] * fv[n]).sum() for n in d["metas"]))
    assert q >= 0.0
    assert abs(q - dot) <= 1e-12 * abs(dot)


def test_ggn_matvec_symmetric(dense64):
    """<w, F v> = <v, F w>, float64: 1e-12 relative."""
    d = dense64
    shapes = tmf.delta_shapes(d["metas"])
    v = to_torch(_normal_probe(shapes, 4), torch.float64)
    w = to_torch(_normal_probe(shapes, 5), torch.float64)
    fv = tmf.ggn_matvec(d["tm"], d["metas"], d["tx"], v)
    fw = tmf.ggn_matvec(d["tm"], d["metas"], d["tx"], w)
    lhs = float(sum((w[n] * fv[n]).sum() for n in d["metas"]))
    rhs = float(sum((v[n] * fw[n]).sum() for n in d["metas"]))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_lanczos_topk_dense_parity(dense64):
    """p Lanczos steps on the Gaussian GGN (full rank over the MLP's
    tracked block) give its top 5 eigenvalues, float64: 1e-8 relative;
    the weights sum to 1."""
    d = dense64

    def matvec(v):
        return tmf.ggn_matvec(d["tm"], d["metas"], d["tx"], v,
                              loss="gaussian")
    p = tmf._flatten(d["zeros"]).numel()
    ritz, weights = tmf.lanczos_topk(
        matvec, d["zeros"], p, torch.Generator().manual_seed(7))
    evals = torch.linalg.eigvalsh(d["dense"]["gaussian"]).flip(0)
    np.testing.assert_allclose(np_(ritz[:5]), np_(evals[:5]), rtol=1e-8)
    assert abs(float(weights.sum()) - 1.0) <= 1e-10


def test_lanczos_topk_matches_jax():
    """JAX's start vector injected: 12 steps on the MLP's CE GGN give
    JAX's Ritz values and weights, 1e-4 of max."""
    tm, jm, variables, x, tx = pair("mlp")
    jmetas = jest.Diagonal(jm, jv(variables)).metas
    tmetas = port_est.Diagonal(tm).metas
    example = {n: jnp.zeros(s, jnp.float32)
               for n, s in jmf.delta_shapes(jmetas).items()}
    key = jax.random.PRNGKey(7)
    want_ritz, want_w = jmf.lanczos_topk(
        lambda d: jmf.ggn_matvec(jm, jmetas, jv(variables), jnp.asarray(x),
                                 d), example, 12, key)
    p = ravel_pytree(example)[0].shape[0]
    q0 = np.array(jax.random.normal(key, (p,), jnp.float32))
    got_ritz, got_w = tmf.lanczos_topk(
        lambda d: tmf.ggn_matvec(tm, tmetas, tx, d), to_torch(example), 12,
        q0=q0)
    close(got_ritz, want_ritz, 1e-4, "ritz")
    close(got_w, want_w, 1e-4, "weights")
    # the start vector lies in the Krylov space: the top Ritz value is at
    # least its Rayleigh quotient
    q = torch.from_numpy(q0 / np.linalg.norm(q0))
    fq = tmf._flatten(tmf.ggn_matvec(
        tm, tmetas, tx, tmf._unflatten(q, to_torch(example))))
    assert float(got_ritz[0]) >= float(q @ fq) * (1 - 1e-5)


def test_hutchinson_trace_matches_jax():
    """JAX's 16 Rademacher probes injected: the same mean, 1e-5
    relative; the port's own 256 draws within 15% of the dense trace."""
    tm, jm, variables, x, tx = pair("mlp")
    jmetas = jest.Diagonal(jm, jv(variables)).metas
    tmetas = port_est.Diagonal(tm).metas
    key = jax.random.PRNGKey(11)

    def jquad(d):
        return jmf.ggn_quad(jm, jmetas, jv(variables), jnp.asarray(x), d)
    want = float(jmf.hutchinson_trace(jquad, jmetas, key, num_probes=16))
    probes = [to_torch(jmf.random_deltas(jmetas, k))
              for k in jax.random.split(key, 16)]

    def tquad(d):
        return tmf.ggn_quad(tm, tmetas, tx, d)
    got = float(tmf.hutchinson_trace(tquad, tmetas, probes=probes))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    mine = float(tmf.hutchinson_trace(
        tquad, tmetas, torch.Generator().manual_seed(11), num_probes=256))
    shapes = tmf.delta_shapes(tmetas)
    trace = 0.0
    for n, s in shapes.items():
        for i in range(int(np.prod(s))):
            e = {m: torch.zeros(t) for m, t in shapes.items()}
            e[n].view(-1)[i] = 1.0
            trace += float(tquad(e))
    assert abs(mine - trace) <= 0.15 * trace, (mine, trace)


def test_random_deltas_kinds():
    """Rademacher probes are +-1, normal ones are not; both have the
    matrix-view shapes and the generator's device."""
    tm, *_ = pair("grouped")
    metas = port_est.Diagonal(tm).metas
    gen = torch.Generator().manual_seed(0)
    r = tmf.random_deltas(metas, gen)
    g = tmf.random_deltas(metas, gen, kind="normal")
    for n, s in tmf.delta_shapes(metas).items():
        assert tuple(r[n].shape) == s and tuple(g[n].shape) == s
        assert set(np.unique(np_(r[n]))) <= {-1.0, 1.0}
        assert not set(np.unique(np_(g[n]))) <= {-1.0, 1.0}


# -- the fidelity report ------------------------------------------------------

def _jax_fidelity_probes(metas, rng, num_probes, rows):
    """JAX fidelity_report's Rademacher draws, row by row (its key
    schedule rebuilt), as {row: [probe dicts]}."""
    shapes = jmf.delta_shapes(metas)
    out = {}
    for row, names in rows:
        out[row] = []
        for _ in range(num_probes):
            rng, key = jax.random.split(rng)
            probe = {}
            for n in names:
                key, sub = jax.random.split(key)
                probe[n] = np.asarray(jax.random.rademacher(
                    sub, shapes[n], jnp.float32))
            out[row].append(probe)
    return out


def _fitted(kind, tm, jm, variables, x, tx, labels):
    """JAX's estimator fitted on ``labels``, the port's fed its state."""
    jvars = jv(variables)
    if kind == "kfac":
        je, te = jest.KFAC(jm, jvars, use_pallas=False), port_est.KFAC(tm)
    elif kind == "block":
        je, te = jest.BlockDiagonal(jm, jvars), port_est.BlockDiagonal(tm)
    else:
        je, te = jest.Diagonal(jm, jvars), port_est.Diagonal(tm)
    je.update(jnp.asarray(x), labels=jnp.asarray(labels))
    te.state = tmodels.state_from_jax(je.state, "cpu")
    return je, te


@pytest.mark.parametrize("kind", ["diag", "kfac", "block"])
@pytest.mark.parametrize("name", ["mlp", "bn"])
def test_fidelity_report_matches_jax(name, kind):
    """Every row (each layer and ``__joint__``) with JAX's probes
    injected: each number within 1e-4 relative of JAX's."""
    tm, jm, variables, x, tx = pair(name)
    classes = 4 if name == "mlp" else 5
    labels = np.random.default_rng(2).integers(
        0, classes, (3, x.shape[0])).astype(np.int32)
    je, te = _fitted(kind, tm, jm, variables, x, tx, labels)
    key = jax.random.PRNGKey(1)
    want = j_fidelity(je, jnp.asarray(x), key, num_probes=3, norm=3.0,
                      joint=True)
    rows = [(n, [n]) for n in je.metas] + [("__joint__", list(je.metas))]
    got = fidelity_report(te, tx, num_probes=3, norm=3.0, joint=True,
                          probes=_jax_fidelity_probes(je.metas, key, 3,
                                                      rows))
    assert list(got) == list(want)
    for row, r in want.items():
        for k, v in r.items():
            assert abs(got[row][k] - v) <= 1e-4 * max(abs(v), 1e-6), \
                (row, k, got[row][k], v)


def test_fidelity_report_draws_and_filters_layers():
    """Drawn probes give finite rows with a positive alpha; ``layers``
    restricts the rows."""
    tm, *_ , tx = pair("mlp")
    est = port_est.KFAC(tm)
    est.update(tx, generator=torch.Generator().manual_seed(0),
               num_samples=50)
    rep = fidelity_report(est, tx, torch.Generator().manual_seed(1),
                          num_probes=4, norm=50.0, layers=["fc2"],
                          joint=True)
    assert list(rep) == ["fc2", "__joint__"]
    for r in rep.values():
        assert all(np.isfinite(list(r.values())))
        assert r["alpha"] > 0.0


def test_fidelity_unknown_layer_raises():
    tm, *_ , tx = pair("mlp")
    est = port_est.Diagonal(tm)
    est.update(tx, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not tracked"):
        fidelity_report(est, tx, torch.Generator().manual_seed(1),
                        layers=["nope"])
