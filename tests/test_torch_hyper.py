"""The damping search (``pipelines/hyper.py``) and ``evaluate
--predictive`` of the port against the JAX package.

The optimizers on closed-form objectives (the numpy streams are JAX's, so
random, grid and gp propose JAX's points), the per-layer coordinate
descent on a deterministic evaluator, the batched evaluator on LeNet-5
with the bundled weights over JAX's KFAC factors of the bundled digits
(JAX's posterior draws rebuilt from its key schedule), the penalties at
the reference's boundary points, the stats and best-params files read by
the other package, and ``run`` for every optimizer and objective.
Tolerances are stated per test.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu.eval import marglik as jml
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import factors as jfactors
from curvature_tpu.pipelines import hyper as jhyper
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.eval import predictive as tpred
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import hyper as thyper
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", tloaders.FIXTURE_DIR, "--batch_size", "128",
        "--samples", "2", "--estimator", "kfac"]
SAMPLES = 2


def _objective(a, b):
    """A smooth closed-form stand-in for the validation cost."""
    return float((a - 1.3) ** 2 + 0.5 * (b + 2.0) ** 2 + 3.0 * np.sin(a))


# -- the optimizers -----------------------------------------------------------

@pytest.mark.parametrize("method,calls,x0", [
    ("random", 7, None), ("random", 14, jhyper.BOUNDARY_X0),
    ("grid", 0, None), ("gp", 12, None), ("gp", 15, jhyper.BOUNDARY_X0)])
def test_optimize_proposes_jaxs_points(method, calls, x0):
    """The same points and costs as JAX's ``optimize`` (exactly for
    random and grid; 1e-12 for gp, whose GP follows scikit-learn's
    arithmetic step by step)."""
    wx, wy = jhyper.optimize(_objective, method, calls, 3, x0)
    gx, gy = thyper.optimize(_objective, method, calls, 3, x0)
    np.testing.assert_allclose(np.asarray(gx, float), np.asarray(wx, float),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gy, wy, rtol=1e-12, atol=1e-12)
    assert len(gx) == (9 if method == "grid" else calls)


@pytest.mark.parametrize("method", ["forest", "gbrt"])
def test_tree_optimizers_are_deterministic(method):
    """The tree surrogates draw from numpy's streams, not scikit-learn's:
    their proposals are not JAX's, but the same seed gives the same
    search, every point inside the space, ``calls`` evaluations, and the
    best no worse than the random starts'."""
    xs, ys = thyper.optimize(_objective, method, 10, 5)
    again = thyper.optimize(_objective, method, 10, 5)
    assert xs == again[0] and ys == again[1]
    assert len(xs) == 10 and np.abs(np.asarray(xs)).max() <= 10.0
    starts = min(10, max(1, 10 // 5))
    assert min(ys) <= min(ys[:starts])


def _fake_evaluator(num_layers):
    """A deterministic candidate cost with a per-layer optimum."""
    target_n = np.linspace(-2.0, 3.0, num_layers)
    target_s = np.linspace(4.0, 1.0, num_layers)

    def evaluate(norms, scales, _key):
        out = []
        for n, s in zip(norms, scales):
            ln = np.broadcast_to(np.log10(n), (num_layers,))
            ls = np.broadcast_to(np.log10(s), (num_layers,))
            cost = float(np.sum((ln - target_n) ** 2)
                         + 0.5 * np.sum((ls - target_s) ** 2))
            out.append({"norm": np.asarray(n, float).tolist(),
                        "scale": np.asarray(s, float).tolist(),
                        "acc": 100.0 - cost, "ece": 0.0, "nll": cost,
                        "ent": 0.0, "cost": cost})
        return out
    return evaluate


def test_per_layer_search_matches_jax():
    """Norms, scales, cost and every stats row equal to JAX's (1e-12)."""
    argv = ARGV + ["--calls", "6", "--seed", "3"]
    num_layers = 5
    ws = {k: [] for k in thyper.STATS_KEYS}
    gs = {k: [] for k in thyper.STATS_KEYS}
    wn, wsc, wc = jhyper.per_layer_search(
        jconfig.parse_args(argv), _fake_evaluator(num_layers), num_layers,
        ws, "")
    gn, gsc, gc = thyper.per_layer_search(
        tconfig.parse_args(argv), _fake_evaluator(num_layers), num_layers,
        gs, "")
    np.testing.assert_allclose(gn, wn, rtol=1e-12)
    np.testing.assert_allclose(gsc, wsc, rtol=1e-12)
    assert gc == pytest.approx(wc, rel=1e-12)
    assert len(gs["cost"]) == len(ws["cost"]) > 6
    for k in thyper.STATS_KEYS:
        np.testing.assert_allclose(np.asarray(gs[k], float),
                                   np.asarray(ws[k], float), rtol=1e-12)


# -- the LeNet-5 workspace ----------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """KFAC factors of the bundled digits written by JAX's CLI, loaded by
    both packages' ``load_estimator``, with each package's validation
    batches."""
    root = str(tmp_path_factory.mktemp("hyper"))
    argv = ARGV + ["--root_dir", root, "--results_dir", root,
                   "--mc_samples", "1"]
    jfactors.main(argv)
    t, j = tconfig.parse_args(argv), jconfig.parse_args(argv)
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    return dict(
        root=root, argv=argv, t=t, j=j, tm=tm, jm=jm, jv=jv,
        te=tevaluate.load_estimator(t, tm),
        je=jevaluate.load_estimator(j, jm, jv),
        tval=list(tcommon.on_device(tcommon.build_data(t, splits="val"),
                                    "cpu")),
        jval=list(jcommon.build_data(j, splits="val")))


def _candidate_noise(t, key, candidates, samples):
    """JAX's batched-evaluator draws: one key per candidate, one per
    sample, then one per layer in meta order."""
    out = []
    for kc in jax.random.split(key, candidates):
        per = []
        for ks in jax.random.split(kc, samples):
            noise = {}
            for name, shape in t.noise_shapes().items():
                ks, k = jax.random.split(ks)
                noise[name] = np.array(jax.random.normal(k, shape,
                                                         jnp.float32))
            per.append(noise)
        out.append(per)
    return out


@pytest.mark.parametrize("per_layer", [False, True])
def test_batched_evaluator_matches_jax(workspace, per_layer):
    """Per candidate, with JAX's draws: accuracy equal, ECE (in %) within
    0.05 points, NLL and entropy within 1e-3 relative, cost within 0.05.
    The port inverts the factors itself, its damped inverse Choleskys
    within 5e-4 of JAX's at scale 5e4 (tests/test_torch_pipelines.py):
    measured on the CPU, ECE 0.0017 points, NLL 1.3e-4 and entropy
    1.1e-4 relative at worst."""
    w = workspace
    n = len(w["te"].metas)
    if per_layer:
        norms = [np.linspace(1.0, 10.0, n), np.full(n, 1e3)]
        scales = [np.geomspace(1e3, 5e4, n), np.full(n, 1e2)]
    else:
        norms, scales = [1.0, 10.0, 1e3], [5e4, 1e3, 1e2]
    key = jax.random.PRNGKey(7)
    want = jhyper.make_batched_evaluator(w["j"], w["jm"], w["jv"], w["je"],
                                         w["jval"])(norms, scales, key)
    ev = thyper.make_batched_evaluator(w["t"], w["tm"], w["te"], w["tval"])
    got = ev(norms, scales,
             noise=_candidate_noise(w["te"], key, len(norms), SAMPLES))
    assert ev.penalized == 0 and len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g["norm"], r["norm"], rtol=1e-7)
        np.testing.assert_allclose(g["scale"], r["scale"], rtol=1e-7)
        assert g["acc"] == pytest.approx(r["acc"], abs=1e-9)
        assert abs(g["ece"] - r["ece"]) <= 0.05
        assert abs(g["cost"] - r["cost"]) <= 0.05
        for k in ("nll", "ent"):
            assert g[k] == pytest.approx(r[k], rel=1e-3), k
    # est.inv_state is left alone
    assert w["te"].inv_state is None


def test_boundary_penalties_match_jax(workspace):
    """At the reference's 12 boundary points the same candidates are
    penalized as in JAX, by the batched evaluator (JAX: non-finite
    probabilities; the port: ``LinAlgError`` or non-finite), by the
    sequential objective (an inverse that is NaN in JAX, an inversion
    that raises or is non-finite here) and by the evidence (NaN in JAX);
    every penalty row recorded with JAX's values."""
    w = workspace
    pts = jhyper.BOUNDARY_X0
    norms = [10.0 ** p[0] for p in pts]
    scales = [10.0 ** p[1] for p in pts]
    want = jhyper.make_batched_evaluator(w["j"], w["jm"], w["jv"], w["je"],
                                         w["jval"])(norms, scales,
                                                    jax.random.PRNGKey(0))
    ev = thyper.make_batched_evaluator(w["t"], w["tm"], w["te"], w["tval"])
    got = ev(norms, scales, torch.Generator().manual_seed(0))
    w_pen = [r["cost"] == jhyper.SINGULAR_COST for r in want]
    g_pen = [r["cost"] == thyper.SINGULAR_COST for r in got]
    assert g_pen == w_pen and any(g_pen) and not all(g_pen)
    assert ev.penalized == sum(g_pen)
    for r in got:
        if r["cost"] == thyper.SINGULAR_COST:
            assert (r["acc"], r["ece"], r["ent"]) == (0.0, 0.0, 0.0)
            assert r["nll"] == float("inf")

    ws = {k: [] for k in thyper.STATS_KEYS}
    gs = {k: [] for k in thyper.STATS_KEYS}
    jobj = jhyper.make_objective(w["j"], w["jm"], w["jv"], w["je"],
                                 w["jval"], ws, "")
    tobj = thyper.make_objective(w["t"], w["tm"], w["te"], w["tval"], gs, "")
    wy = [jobj(*p) for p in pts]
    gy = [tobj(*p) for p in pts]
    w_pen = [y == jhyper.SINGULAR_COST for y in wy]
    assert [y == thyper.SINGULAR_COST for y in gy] == w_pen
    assert tobj.penalized == sum(w_pen) and len(gs["cost"]) == len(pts)
    for k in thyper.STATS_KEYS:
        rows = [v for v, p in zip(gs[k], w_pen) if p]
        assert rows == [v for v, p in zip(ws[k], w_pen) if p], k

    nll = 1000.0
    w_pen = [not np.isfinite(jml.log_marginal_likelihood(
        w["je"], nll, 10.0 ** a, 10.0 ** b)) for a, b in pts]
    ms = {k: [] for k in thyper.STATS_KEYS}
    mobj = thyper.make_marglik_objective(w["t"], w["te"], nll, ms, "")
    assert [mobj(*p) == thyper.MARGLIK_PENALTY for p in pts] == w_pen
    assert mobj.penalized == sum(w_pen) and len(ms["cost"]) == len(pts)


# -- files and run() ----------------------------------------------------------

def _stats_path(cfg, optimizer, layer=False):
    path, _ = jckpt.results_paths(cfg, optimizer)
    return path + ("_hyperopt_stats_layer.npy" if layer
                   else "_hyperopt_stats.npy")


def test_stats_and_best_params_swap_both_ways(workspace, tmp_path):
    """JAX's run writes the stats and best params; the port's run over the
    same flags resumes JAX's stats file (its rows first, the port's
    appended) and rewrites the best params, which JAX's
    ``invert_from_config`` reads; and the other way round."""
    w = workspace
    argv = w["argv"] + ["--results_dir", str(tmp_path), "--optimizer",
                        "random", "--calls", "3"]
    j, t = jconfig.parse_args(argv), tconfig.parse_args(argv)
    jhyper.run(j)
    path = _stats_path(j, "random")
    jax_rows = np.load(path, allow_pickle=True).item()
    assert len(jax_rows["cost"]) == 3
    out = thyper.run(t)
    rows = np.load(path, allow_pickle=True).item()
    assert sorted(rows) == sorted(thyper.STATS_KEYS)
    assert len(rows["cost"]) == 6 and rows["cost"][:3] == jax_rows["cost"]
    assert all(len(r) == len(w["te"].metas) for r in rows["norms"])
    best = np.load(jckpt.results_paths(j)[0] + "_best_params.npy")
    i = int(np.argmin(rows["cost"]))
    np.testing.assert_allclose(best, [rows["norms"][i], rows["scales"][i]])
    assert out["best_cost"] == min(rows["cost"][3:])
    # JAX reads the port's best params
    j_eval = dataclasses.replace(j, norm=-1.0, scale=-1.0)
    je = jevaluate.load_estimator(j_eval, w["jm"], w["jv"])
    norm, scale = jevaluate.invert_from_config(
        j_eval, je, jckpt.results_paths(j_eval)[0])
    np.testing.assert_allclose(np.ravel(norm)[0], best[0][0], rtol=1e-7)
    np.testing.assert_allclose(np.ravel(scale)[0], best[1][0], rtol=1e-7)
    # and JAX resumes the port's file
    jhyper.run(j)
    assert len(np.load(path, allow_pickle=True).item()["cost"]) == 9


CASES = [("cost", "random", ["--calls", "14", "--boundaries"], 14),
         ("cost", "grid", [], 9),
         ("cost", "gp", ["--calls", "4"], 4),
         ("cost", "forest", ["--calls", "3"], 3),
         ("cost", "gbrt", ["--calls", "3"], 3),
         ("cost", "random", ["--layer", "--calls", "4"], None),
         ("marglik", "random", ["--calls", "12", "--boundaries"], 12),
         ("marglik", "grid", [], 9),
         ("marglik", "gp", ["--calls", "6"], 6),
         ("marglik", "forest", ["--calls", "4"], 4),
         ("marglik", "gbrt", ["--calls", "4"], 4),
         ("marglik", "grad", ["--calls", "100"], 1),
         ("marglik", "grad", ["--layer"], 1)]


@pytest.mark.parametrize("objective,optimizer,extra,rows", CASES)
def test_run_every_optimizer_and_objective(workspace, tmp_path, capsys,
                                           objective, optimizer, extra,
                                           rows):
    """``run`` (through ``main``) for every optimizer, both objectives and
    ``--layer``: the stats file under JAX's name with one row per
    evaluated candidate, finite best cost, the penalty count printed, the
    best-params file written."""
    argv = workspace["argv"] + ["--results_dir", str(tmp_path),
                                "--optimizer", optimizer, "--objective",
                                objective] + extra
    out = thyper.main(argv)
    cfg = tconfig.parse_args(argv)
    layer = "--layer" in extra
    stats = np.load(_stats_path(cfg, optimizer, layer),
                    allow_pickle=True).item()
    if rows is not None:
        assert len(stats["cost"]) == rows
    assert np.isfinite(out["best_cost"])
    assert out["best_cost"] == min(stats["cost"]) or layer
    printed = capsys.readouterr().out
    if optimizer == "grad":
        assert "log marginal likelihood" in printed
        assert len(out["trace"]) == 100
    else:
        assert f"penalized candidates (singular or non-finite): " \
            f"{out['penalized']} of {len(stats['cost'])}" in printed
    if "--boundaries" in extra:
        assert out["penalized"] > 0
    assert os.path.exists(jckpt.results_paths(cfg)[0] + "_best_params.npy")


def test_marglik_layer_needs_grad(workspace, tmp_path):
    argv = workspace["argv"] + ["--results_dir", str(tmp_path),
                                "--objective", "marglik", "--layer"]
    with pytest.raises(ValueError, match="--optimizer grad"):
        thyper.main(argv)
    with pytest.raises(ValueError, match="unknown optimizer"):
        thyper.optimize(_objective, "bayes", 3)


def test_evaluate_reads_the_best_params(workspace, tmp_path):
    """After a search, ``evaluate`` with no --norm/--scale inverts at the
    best-params file's per-layer damping, bit for bit."""
    argv = workspace["argv"] + ["--results_dir", str(tmp_path),
                                "--optimizer", "gp", "--calls", "3"]
    thyper.main(argv)
    cfg = tconfig.parse_args(argv)
    results_path = jckpt.results_paths(cfg)[0]
    best = np.load(results_path + "_best_params.npy")
    est = tevaluate.load_estimator(cfg, workspace["tm"])
    norm, scale = tevaluate.invert_from_config(cfg, est, results_path)
    np.testing.assert_array_equal(norm, best[0])
    np.testing.assert_array_equal(scale, best[1])
    ref = tevaluate.load_estimator(cfg, workspace["tm"])
    ref.invert(best[0], best[1])
    for name in est.metas:
        for k in ("a_chol", "g_chol"):
            assert torch.equal(est.inv_state[name][k], ref.inv_state[name][k])
    probs, _ = tevaluate.main(argv)
    assert probs.shape == (256, 10)


# -- evaluate --predictive ----------------------------------------------------

@pytest.mark.parametrize("kind", ["probit", "bridge", "linearized",
                                  "linearized_probit", "linearized_bridge"])
def test_evaluate_alternative_predictives(workspace, tmp_path, monkeypatch,
                                          kind):
    """``evaluate --ood --predictive`` (the OOD set, KMNIST, is not in the
    repo: the digits scaled as ``x * 2 + 1`` stand in): the BNN
    predictions are the predictive's over one draw from a generator
    seeded with --seed, [256, 10], finite, rows summing to 1; the npz has
    JAX's keys with empty running stats."""
    w = workspace

    def ood(cfg, batch_size=None):
        test = list(tcommon.build_data(cfg, splits="test"))
        return test, [(x * 2.0 + 1.0, y) for x, y in test]
    monkeypatch.setattr(tevaluate, "build_ood_data", ood)
    argv = w["argv"] + ["--results_dir", str(tmp_path), "--ood", "--norm",
                        "1", "--scale", "5e4", "--predictive", kind]
    preds, bnn, labels = tevaluate.main(argv)
    assert bnn.shape == (256, 10) and np.isfinite(bnn).all()
    np.testing.assert_allclose(bnn.sum(1), 1.0, atol=1e-5)
    cfg = tconfig.parse_args(argv)
    est = tevaluate.load_estimator(cfg, w["tm"])
    est.invert(1.0, 5e4)
    data = list(tcommon.on_device(ood(cfg)[0], "cpu"))
    gen = torch.Generator().manual_seed(cfg.seed)
    if kind in ("probit", "bridge"):
        want, _ = tpred.eval_bnn_closed_form(w["tm"], est, data, SAMPLES,
                                             generator=gen, method=kind)
    else:
        want, _ = tpred.eval_bnn_linearized(
            w["tm"], est, data, SAMPLES, generator=gen,
            method=kind[len("linearized"):].lstrip("_") or "mc")
    np.testing.assert_allclose(bnn, want, rtol=1e-6, atol=1e-7)
    with np.load(jckpt.results_paths(cfg)[0] + ".npz",
                 allow_pickle=True) as f:
        assert sorted(f.files) == sorted(
            ["stats", "labels", "predictions", "bnn_predictions",
             "ood_predictions", "bnn_ood_predictions", "auroc"])
        assert f["stats"].item() == {}


@pytest.mark.parametrize("flags,match", [
    (["--stats"], "--stats"), (["--sample_chunk", "2"], "--sample_chunk")])
def test_evaluate_predictive_refusals(workspace, tmp_path, monkeypatch,
                                      flags, match):
    """--stats and --sample_chunk are refused with a non-sampled
    predictive (JAX :196-205), as is a vocabulary-scale output
    (:134-138)."""
    monkeypatch.setattr(tevaluate, "build_ood_data", lambda cfg: (
        list(tcommon.build_data(cfg, splits="test")),) * 2)
    argv = workspace["argv"] + ["--results_dir", str(tmp_path), "--ood",
                                "--norm", "1", "--scale", "5e4",
                                "--predictive", "probit"] + flags
    with pytest.raises(ValueError, match=match):
        tevaluate.main(argv)
    cfg = tconfig.parse_args(["--platform", "cpu", "--model", "gpt2_tiny",
                              "--data", "tokens", "--vocab", "50257",
                              "--predictive", "bridge"])
    with pytest.raises(ValueError, match="vocab-scale"):
        tevaluate.out_of_domain(cfg, None, None, "", "")
