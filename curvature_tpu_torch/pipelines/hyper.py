"""Damping hyperparameter search (reference scripts/hyper.py).

Port of ``curvature_tpu/pipelines/hyper.py``. It searches (log10 norm,
log10 scale) in [-10, 10]^2 with the reference's objective, ``(100 -
accuracy) + ECE%`` of a Bayesian eval on the validation split, a singular
inversion costing 200 (hyper.py:134-162), and the same optimizers:
random, grid, GP BayesOpt (Matern kernel, skopt's ``gp_hedge`` portfolio
of EI/PI/LCB), extra trees and gradient-boosted trees, whose surrogates
are ``pipelines/surrogates.py`` (numpy and scipy; no scikit-learn).
``--layer`` runs a per-layer coordinate descent; ``--objective marglik``
scores a candidate by the Laplace evidence instead (no forward pass),
with any optimizer or with ``--optimizer grad``, gradient ascent on it.

The optimizers' numpy streams are JAX's (``default_rng(seed)``), so for
one objective random, grid and gp propose JAX's points. The posterior
draws come from a ``torch.Generator`` seeded with ``--seed`` (``--seed``
+ 1 for the per-layer search's validation draws). A damping whose
inversion fails (``torch.linalg.LinAlgError`` from a Cholesky, where JAX
gets NaN) or gives non-finite values is recorded with JAX's penalty;
``run`` prints how many were. The stats ``.npy`` (a pickled dict of
lists) and ``<results>_best_params.npy`` have JAX's layout and paths, so
each package reads the other's. ``--parallel``/``--mesh`` split each
validation batch over the ranks' data axis: every rank computes the same
costs, and rank 0 writes the files. ``--plot`` draws the cost scatter
(``<figures>_hyper.pdf``, ``pipelines/plot.py``).

    python -m curvature_tpu_torch.pipelines.hyper --model lenet5 \\
        --data mnist --data_dir <dir> --estimator kfac --optimizer gp \\
        --calls 12
"""
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from curvature_tpu_torch.estimators.base import normalize_damping
from curvature_tpu_torch.eval import eval_bnn, metrics
from curvature_tpu_torch.eval.marglik import (
    dataset_map_nll, log_marginal_likelihood, marglik_gradient_tune)
from curvature_tpu_torch.nn.core import apply_matrix_delta
from curvature_tpu_torch.pipelines import plot, surrogates
from curvature_tpu_torch.pipelines.common import (
    build_data, build_model, on_device)
from curvature_tpu_torch.pipelines.evaluate import load_estimator
from curvature_tpu_torch.parallel.mesh import build_mesh
from curvature_tpu_torch.utils.checkpoint import results_paths, write_once

SPACE = (-10.0, 10.0)
SINGULAR_COST = 200.0
#: failed-candidate penalty on the marglik scale (see the marglik objective)
MARGLIK_PENALTY = 1e12

#: boundary-probing start points (reference hyper.py:108-120)
BOUNDARY_X0 = [
    [-10, -10], [10, 10], [-10, 10], [10, -10],
    [-5, -10], [5, 10], [-10, 5], [10, -5],
    [-5, -5], [5, 5], [-5, 5], [5, -5],
]

STATS_KEYS = ("norms", "scales", "acc", "ece", "nll", "ent", "cost")


def _tree_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_tree_finite(v) for v in tree.values())
    return bool(torch.isfinite(tree).all())


def _scalar_or_list(v):
    a = np.asarray(v, dtype=float)
    return float(a) if a.ndim == 0 else a.tolist()


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.no_grad()
def candidate_ensemble(est, inv, samples: int,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[List[Dict]] = None) -> List[Dict]:
    """``samples`` posterior parameter dicts from the inverse state
    ``inv`` (not ``est.inv_state``): each draw's standard-normal noise
    (from ``generator``, or ``noise[s]``) is sampled and added to the
    MAP one after the other."""
    out = []
    for s in range(samples):
        z = (est.draw_noise(generator) if noise is None
             else est._as_noise(noise[s]))
        out.append(apply_matrix_delta(est.metas, est.mean_params,
                                      est.sample_state(inv, z)))
    return out


def make_batched_evaluator(cfg, model, est, val_batches, mesh=None):
    """Evaluate many (norm, scale) candidates: ``evaluate(norms, scales,
    generator=None, noise=None)`` with [C] shared or [C, L] per-layer raw
    damping values returns one stat dict per candidate (keys
    norm/scale/acc/ece/nll/ent/cost).

    JAX vmaps invert -> sample -> predict over the candidates (:47-139);
    here the candidates run one after the other, each inverting
    ``invert_state(est.state, ...)`` (``est.inv_state`` is left alone)
    and keeping only its own ensemble resident. ``noise[c][s]`` gives
    candidate c's s-th standard-normal draw (else ``generator`` draws).
    A candidate whose inversion raises ``torch.linalg.LinAlgError`` or
    whose predictions are not finite gets the penalty row; the function's
    ``penalized`` attribute counts them. With ``mesh`` each validation
    batch splits over the data axis (JAX :90-92)."""
    num_layers = len(est.metas)
    batches = list(val_batches)

    def evaluate(norms, scales, generator=None, noise=None):
        out = []
        for i in range(len(norms)):
            add, mult = normalize_damping(
                np.array(norms[i], float),
                cfg.pre_scale * np.array(scales[i], float), num_layers,
                est.device, est.dtype)
            probs = None
            try:
                with torch.no_grad():
                    inv = est._wrap_inv(est.invert_state(est.state, add,
                                                         mult))
                ens = candidate_ensemble(
                    est, inv, cfg.samples, generator,
                    None if noise is None else noise[i])
                probs, labels, _ = eval_bnn(model, est, batches,
                                            cfg.samples, ensemble_params=ens,
                                            mesh=mesh)
                del ens, inv
            except torch.linalg.LinAlgError:
                probs = None
            row = {"norm": _scalar_or_list(norms[i]),
                   "scale": _scalar_or_list(scales[i])}
            if probs is None or not np.isfinite(probs).all():
                evaluate.penalized += 1
                row.update(acc=0.0, ece=0.0, nll=float("inf"), ent=0.0,
                           cost=SINGULAR_COST)
            else:
                acc = float(metrics.accuracy(probs, labels))
                ece = 100.0 * float(
                    metrics.expected_calibration_error(probs, labels)[0])
                row.update(
                    acc=acc, ece=ece,
                    nll=float(metrics.negative_log_likelihood(probs,
                                                              labels)),
                    ent=float(metrics.predictive_entropy(probs, mean=True)),
                    cost=(100.0 - acc) + ece)
            out.append(row)
        return out

    evaluate.penalized = 0
    return evaluate


def per_layer_search(cfg, evaluator, num_layers: int, stats: Dict[str, list],
                     stats_path: str, rounds: int = 2,
                     grid=(-1.0, -0.5, 0.5, 1.0), device="cpu"):
    """Per-layer damping search by coordinate descent (``--layer``; the
    reference's flag only relabels the stats file, hyper.py:60, 79).

    From the best *shared* (norm, scale) of ``max(cfg.calls, 4)`` random
    pairs, each layer's (norm_l, scale_l) is refined against a log-offset
    grid, a layer's candidates in one evaluator call. Every call draws
    from a generator seeded with ``cfg.seed``, so the objective is
    deterministic and the search monotone; a move is accepted only if its
    cost averaged with its cost under a second seed (``cfg.seed + 1``)
    beats the incumbent's two-seed average (one noise draw can be
    overfit). ``device`` is where the generators draw.
    """
    rng_np = np.random.default_rng(cfg.seed)
    raw_evaluator = evaluator

    def evaluator(ns, ss, seed):
        return raw_evaluator(ns, ss, _generator(device, seed))

    def record(res):
        for r in res:
            stats["norms"].append(
                list(np.broadcast_to(r["norm"], (num_layers,)).astype(float)))
            stats["scales"].append(
                list(np.broadcast_to(r["scale"], (num_layers,)).astype(float)))
            for k in ("acc", "ece", "nll", "ent", "cost"):
                stats[k].append(r[k])
        if stats_path:
            write_once(np.save, stats_path, stats)

    seed, seed2 = cfg.seed, cfg.seed + 1
    # phase 1: shared-damping random init
    xs = [list(p) for p in rng_np.uniform(*SPACE, size=(max(cfg.calls, 4), 2))]
    res = evaluator([10.0 ** p[0] for p in xs], [10.0 ** p[1] for p in xs],
                    seed)
    record(res)
    best = min(res, key=lambda r: r["cost"])
    norms = np.full(num_layers, np.log10(np.broadcast_to(
        best["norm"], (1,))[0]))
    scales = np.full(num_layers, np.log10(np.broadcast_to(
        best["scale"], (1,))[0]))
    best_cost = best["cost"]
    # incumbent's cost under the validation seed -> two-seed average
    res2 = evaluator([np.broadcast_to(best["norm"], (num_layers,))],
                     [np.broadcast_to(best["scale"], (num_layers,))], seed2)
    best_avg = 0.5 * (best_cost + res2[0]["cost"])

    # phase 2: per-layer coordinate descent
    for _ in range(rounds):
        improved = False
        for layer in range(num_layers):
            cand_n, cand_s = [], []
            for dn in grid:
                for ds in grid:
                    nn_ = norms.copy()
                    ss = scales.copy()
                    nn_[layer] = np.clip(nn_[layer] + dn, *SPACE)
                    ss[layer] = np.clip(ss[layer] + ds, *SPACE)
                    cand_n.append(10.0 ** nn_)
                    cand_s.append(10.0 ** ss)
            res = evaluator(np.stack(cand_n), np.stack(cand_s), seed)
            record(res)
            idx = int(np.argmin([r["cost"] for r in res]))
            if res[idx]["cost"] < best_cost - 1e-9:
                # cross-validate the move under the held-out seed first
                val = evaluator([np.asarray(res[idx]["norm"])],
                                [np.asarray(res[idx]["scale"])], seed2)
                cand_avg = 0.5 * (res[idx]["cost"] + val[0]["cost"])
                if cand_avg < best_avg - 1e-9:
                    best_cost = res[idx]["cost"]
                    best_avg = cand_avg
                    norms = np.log10(np.asarray(res[idx]["norm"]))
                    scales = np.log10(np.asarray(res[idx]["scale"]))
                    improved = True
        if not improved:
            break
    return 10.0 ** norms, 10.0 ** scales, best_cost


def _record_row(stats, norms, scales, cost, nll, acc=0.0, ece=0.0,
                ent=0.0):
    """Append one candidate's row to the stats (JAX's keys and order)."""
    stats["norms"].append(norms)
    stats["scales"].append(scales)
    stats["acc"].append(acc)
    stats["ece"].append(ece)
    stats["nll"].append(nll)
    stats["ent"].append(ent)
    stats["cost"].append(cost)


def make_objective(cfg, model, est, val_batches, stats: Dict[str, list],
                   stats_path: str, mesh=None) -> Callable:
    """The sequential objective of the adaptive optimizers: invert the
    estimator at (10^norm_log10, 10^scale_log10) for every layer, then a
    ``cfg.samples``-sample Bayesian eval whose draws come from a
    generator seeded with ``cfg.seed`` at each call. An inversion that
    raises ``torch.linalg.LinAlgError`` or leaves a non-finite inverse
    state costs ``SINGULAR_COST``, its row recorded (``run`` finds the
    best candidate by index over the rows); ``objective.penalized``
    counts them. ``mesh`` splits the eval batches over its data axis."""
    num_layers = len(est.metas)
    chunk = getattr(cfg, "sample_chunk", 0) or None
    batches = list(val_batches)

    def objective(norm_log10: float, scale_log10: float) -> float:
        norms = [10.0 ** norm_log10] * num_layers
        scales = [10.0 ** scale_log10] * num_layers
        try:
            est.invert(np.asarray(norms), cfg.pre_scale * np.asarray(scales))
            finite = _tree_finite(est.inv_state)
        except torch.linalg.LinAlgError:
            finite = False
        if not finite:
            objective.penalized += 1
            _record_row(stats, norms, scales, SINGULAR_COST, float("inf"))
            if stats_path:
                write_once(np.save, stats_path, stats)
            return SINGULAR_COST
        predictions, labels, _ = eval_bnn(
            model, est, batches, cfg.samples,
            generator=_generator(est.device, cfg.seed), sample_chunk=chunk,
            mesh=mesh)
        err = 100.0 - float(metrics.accuracy(predictions, labels))
        ece = 100.0 * float(
            metrics.expected_calibration_error(predictions, labels)[0])
        nll = float(metrics.negative_log_likelihood(predictions, labels))
        ent = float(metrics.predictive_entropy(predictions, mean=True))
        _record_row(stats, norms, scales, err + ece, nll, 100.0 - err, ece,
                    ent)
        if stats_path:
            # incremental resume (hyper.py:160)
            write_once(np.save, stats_path, stats)
        return err + ece

    objective.penalized = 0
    return objective


# -- optimizers --------------------------------------------------------------

def _expected_improvement(mu, sigma, best):
    from scipy.stats import norm as norm_dist
    sigma = np.maximum(sigma, 1e-9)
    z = (best - mu) / sigma
    return (best - mu) * norm_dist.cdf(z) + sigma * norm_dist.pdf(z)


def _probability_improvement(mu, sigma, best):
    from scipy.stats import norm as norm_dist
    sigma = np.maximum(sigma, 1e-9)
    return norm_dist.cdf((best - mu) / sigma)


def _gp_hedge_next(mu, sigma, cand, best, gains, rng):
    """One gp_hedge step (skopt's default GP acquisition; the reference's
    gp_minimize, hyper.py:174-176): EI, PI and LCB (kappa 1.96) each
    propose their best candidate, one is chosen with probability
    softmax(gains), and each member's gain is then lowered by the GP
    mean at its own proposal (by the caller). Returns (next point,
    proposals)."""
    proposals = [
        cand[int(np.argmax(_expected_improvement(mu, sigma, best)))],
        cand[int(np.argmax(_probability_improvement(mu, sigma, best)))],
        cand[int(np.argmin(mu - 1.96 * sigma))],     # LCB, minimized
    ]
    logits = gains - np.max(gains)
    probs = np.exp(logits) / np.exp(logits).sum()
    choice = rng.choice(len(proposals), p=probs)
    return proposals[choice], proposals


def _surrogate_minimize(objective, calls: int, seed: int, x0, kind: str):
    """Sequential model-based optimization over a random candidate pool
    of 512 per step (the skopt gp/forest/gbrt pattern, hyper.py:164-194)."""
    rng = np.random.default_rng(seed)
    xs: List[List[float]] = []
    ys: List[float] = []
    starts = list(x0) if x0 else [
        list(rng.uniform(*SPACE, size=2))
        for _ in range(min(10, max(1, calls // 5)))]
    for p in starts[:calls]:
        xs.append(list(p))
        ys.append(objective(*p))

    if kind == "gp":
        make = surrogates.GaussianProcess
    elif kind == "forest":
        def make():
            return surrogates.ExtraTrees(n_estimators=50, random_state=seed)
    else:  # gbrt
        def make():
            return surrogates.GradientBoosting(random_state=seed)

    gains = np.zeros(3)          # gp_hedge portfolio state (EI, PI, LCB)
    while len(xs) < calls:
        model = make()
        model.fit(np.asarray(xs), np.asarray(ys))
        cand = rng.uniform(*SPACE, size=(512, 2))
        if kind == "gp":
            mu, sigma = model.predict(cand, return_std=True)
            nxt, proposals = _gp_hedge_next(mu, sigma, cand, np.min(ys),
                                            gains, rng)
            gains -= model.predict(np.asarray(proposals))
        else:
            if kind == "forest":
                per_tree = np.stack(
                    [t.predict(cand) for t in model.estimators_])
                mu, sigma = per_tree.mean(0), per_tree.std(0)
            else:
                mu = model.predict(cand)
                sigma = np.full_like(mu, np.std(ys) + 1e-6)
            ei = _expected_improvement(mu, sigma, np.min(ys))
            nxt = cand[int(np.argmax(ei))]
        xs.append(list(nxt))
        ys.append(objective(*nxt))
    return xs, ys


def optimize(objective, method: str, calls: int, seed: int = 0,
             x0: Optional[list] = None) -> Tuple[list, list]:
    rng = np.random.default_rng(seed)
    if method == "random":
        xs = [list(p) for p in (x0 or [])]
        xs += [list(rng.uniform(*SPACE, size=2))
               for _ in range(calls - len(xs))]
        return xs, [objective(*p) for p in xs]
    if method == "grid":
        vals = np.arange(SPACE[0], SPACE[1] + 1, 10)  # hyper.py:191
        xs = [[float(n), float(s)] for n in vals for s in vals]
        return xs, [objective(*p) for p in xs]
    if method in ("gp", "forest", "gbrt"):
        return _surrogate_minimize(objective, calls, seed, x0, method)
    raise ValueError(f"unknown optimizer {method!r}")


def aggregate_best_params(cfg, filename: str):
    """Scan every hyperopt stats file under the estimator's results tree
    and save the best (norms, scales) (reference hyper.py:206-218)."""
    path = os.path.join(cfg.results_dir, cfg.model, "data", cfg.estimator)
    all_stats = {"norms": [], "scales": [], "cost": []}
    for subdir, _, files in os.walk(path):
        for fn in files:
            if fn.endswith(".npy") and "hyperopt_stats" in fn:
                try:
                    st = np.load(os.path.join(subdir, fn),
                                 allow_pickle=True).item()
                except (ValueError, OSError):
                    continue
                for key in all_stats:
                    all_stats[key].extend(st.get(key, []))
    if not all_stats["cost"]:
        return None
    best = int(np.argmin(all_stats["cost"]))
    out = np.array([all_stats["norms"][best], all_stats["scales"][best]])
    write_once(np.save, os.path.join(path, f"{filename}_best_params.npy"),
               out)
    return out


def _marglik_grad(cfg, est, nll: float, stats, stats_path: str):
    """``--objective marglik --optimizer grad``: gradient ascent on the
    evidence (``max(--calls, 100)`` Adam steps; ``--layer`` tunes all 2L
    per-layer dampings jointly), recorded as one row."""
    steps = max(cfg.calls, 100)
    res = marglik_gradient_tune(est, nll, steps=steps,
                                pre_scale=cfg.pre_scale, per_layer=cfg.layer)
    cost = -res["log_marglik"]
    _record_row(stats, [float(v) for v in res["norms"]],
                [float(v) for v in res["scales"]], cost, float(nll),
                float("nan"), float("nan"), float("nan"))
    if not cfg.no_results:
        write_once(np.save, stats_path, stats)
        aggregate_best_params(
            cfg, f"{cfg.prefix}{cfg.model}_{cfg.data}{cfg.suffix}")
    print(f"log marginal likelihood {res['log_marglik']:.3f} after "
          f"{steps} gradient steps "
          f"({'per-layer' if cfg.layer else 'shared'} damping)", flush=True)
    return {"best_x": [np.log10(res["norms"]).tolist(),
                       np.log10(res["scales"]).tolist()],
            "best_cost": cost, "stats": stats, "penalized": 0,
            "trace": res["trace"]}


def make_marglik_objective(cfg, est, nll: float, stats, stats_path: str
                           ) -> Callable:
    """``--objective marglik``: the negative evidence at (10^norm_log10,
    10^scale_log10) as the cost of any optimizer; no forward pass. A
    damped factor whose Cholesky raises ``torch.linalg.LinAlgError``, or
    a non-finite evidence, costs ``MARGLIK_PENALTY``
    (``objective.penalized`` counts them)."""
    num_layers = len(est.metas)

    def objective(norm_log10: float, scale_log10: float) -> float:
        norm = 10.0 ** norm_log10
        scale = cfg.pre_scale * 10.0 ** scale_log10
        try:
            cost = -log_marginal_likelihood(est, nll, norm, scale)
        except torch.linalg.LinAlgError:
            cost = float("nan")
        if not np.isfinite(cost):
            # marglik magnitudes are data-scale (thousands): the
            # reference's 200 would win the argmin, this always loses
            objective.penalized += 1
            cost = MARGLIK_PENALTY
        _record_row(stats, [norm] * num_layers,
                    [10.0 ** scale_log10] * num_layers, cost, float(nll),
                    float("nan"), float("nan"), float("nan"))
        if stats_path:
            write_once(np.save, stats_path, stats)
        return cost

    objective.penalized = 0
    return objective


def run(cfg):
    subdir = cfg.optimizer if cfg.exp_id == "-1" else \
        os.path.join(cfg.optimizer, cfg.exp_id)
    results_path, _ = results_paths(cfg, subdir)
    model = build_model(cfg)
    device = next(model.parameters()).device
    val_batches = list(on_device(build_data(cfg, splits="val"), device))
    est = load_estimator(cfg, model)
    mesh = build_mesh(cfg)      # --parallel/--mesh (reference hyper.py:60-61)
    if not getattr(est, "metas", None):
        raise ValueError(
            "hyper tunes the damping of curvature estimators; "
            f"--estimator {cfg.estimator} has no damping to tune (SWAG's "
            "covariance scale is the --scale flag at evaluate time)")

    stats_path = results_path + (
        "_hyperopt_stats_layer.npy" if cfg.layer else "_hyperopt_stats.npy")
    try:
        stats = np.load(stats_path, allow_pickle=True).item()
    except (FileNotFoundError, OSError):
        stats = {k: [] for k in STATS_KEYS}
    rows_before = len(stats["cost"])

    x0 = BOUNDARY_X0 if cfg.boundaries else None
    if getattr(cfg, "objective", "cost") == "marglik":
        # the Laplace evidence (eval/marglik.py): the MAP NLL is constant
        # in (norm, scale), so a candidate costs one logdet per layer
        if cfg.layer and cfg.optimizer != "grad":
            raise ValueError("--objective marglik supports --layer only "
                             "with --optimizer grad (joint per-layer "
                             "gradient tuning)")
        train = list(on_device(build_data(cfg, splits="train"), device))
        nll = dataset_map_nll(model, train, loss=est.loss)
        if cfg.optimizer == "grad":
            return _marglik_grad(cfg, est, nll, stats, stats_path)
        objective = make_marglik_objective(
            cfg, est, nll, stats, "" if cfg.no_results else stats_path)
        xs, ys = optimize(objective, cfg.optimizer, cfg.calls, cfg.seed, x0)
        penalized = objective.penalized
    elif cfg.layer:
        evaluator = make_batched_evaluator(cfg, model, est, val_batches,
                                           mesh)
        norms, scales, best_cost = per_layer_search(
            cfg, evaluator, len(est.metas), stats,
            "" if cfg.no_results else stats_path, device=device)
        xs = [[norms.tolist(), scales.tolist()]]
        ys = [best_cost]
        penalized = evaluator.penalized
    elif cfg.optimizer in ("random", "grid"):
        # non-adaptive search: the batched evaluator, stats saved per
        # chunk of 8 candidates
        rng_np = np.random.default_rng(cfg.seed)
        if cfg.optimizer == "grid":
            vals = np.arange(SPACE[0], SPACE[1] + 1, 10)
            xs = [[float(n), float(s)] for n in vals for s in vals]
        else:
            xs = [list(p) for p in (x0 or [])]
            xs += [list(rng_np.uniform(*SPACE, size=2))
                   for _ in range(max(cfg.calls - len(xs), 0))]
        evaluator = make_batched_evaluator(cfg, model, est, val_batches,
                                           mesh)
        num_layers = len(est.metas)
        gen = _generator(device, cfg.seed)
        ys = []
        chunk = 8
        for i in range(0, len(xs), chunk):
            sel = xs[i:i + chunk]
            res = evaluator([10.0 ** p[0] for p in sel],
                            [10.0 ** p[1] for p in sel], gen)
            for r in res:
                _record_row(stats, [r["norm"]] * num_layers,
                            [r["scale"]] * num_layers, r["cost"], r["nll"],
                            r["acc"], r["ece"], r["ent"])
                ys.append(r["cost"])
            if not cfg.no_results:
                write_once(np.save, stats_path, stats)
        penalized = evaluator.penalized
    else:
        objective = make_objective(cfg, model, est, val_batches, stats,
                                   "" if cfg.no_results else stats_path,
                                   mesh)
        xs, ys = optimize(objective, cfg.optimizer, cfg.calls, cfg.seed, x0)
        penalized = objective.penalized

    if not cfg.no_results:
        write_once(np.save, stats_path, stats)
        filename = f"{cfg.prefix}{cfg.model}_{cfg.data}{cfg.suffix}"
        aggregate_best_params(cfg, filename)
    best = int(np.argmin(ys))
    if cfg.layer:
        print(f"Minimal cost {ys[best]:.3f} with per-layer damping over "
              f"{len(est.metas)} layers")
    else:
        stats_idx = len(stats["cost"]) - len(ys) + best  # past resumed runs
        print(f"Minimal cost {ys[best]:.3f} at norm "
              f"{stats['norms'][stats_idx][0]:.4g}, "
              f"scale {stats['scales'][stats_idx][0]:.4g}")
    print(f"penalized candidates (singular or non-finite): {penalized} of "
          f"{len(stats['cost']) - rows_before}", flush=True)
    if cfg.plot:
        _, fig_path = results_paths(cfg, subdir)
        plot.hyper_results(stats, fig_path + "_hyper.pdf")
    return {"best_x": xs[best], "best_cost": ys[best], "stats": stats,
            "penalized": penalized}


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
