"""Evaluation pipeline (reference scripts/evaluate.py): deterministic test,
in-domain vs out-of-domain Bayesian eval, and FGSM sweeps, with the
reference's artefact layout and best-params fallback.

Port of ``curvature_tpu/pipelines/evaluate.py``: the estimator is rebuilt
from factor files of either package, inverted at ``--norm``/``--scale``
(or the hyperparameter search's ``<results>_best_params.npy`` when either
is -1), and its posterior samples are drawn from a ``torch.Generator``
seeded with ``--seed``. Results go into npz files with JAX's keys. With
an output of 8,192 classes or more (``--vocab 50257``) ``--ood`` runs the
per-token sufficient-statistics eval (``_out_of_domain_stats``): four
numbers per token, computed on the device, written to ``*_stats.npz``.
``--predictive probit|bridge|linearized|linearized_probit|
linearized_bridge`` replaces the sampled Bayesian predictive of ``--ood``
by a closed-form or linearized one over the same posterior draws
(``eval/predictive.py``).

    python -m curvature_tpu_torch.pipelines.evaluate --model lenet5 \\
        --data mnist --data_dir <dir> --estimator kfac --norm 1 \\
        --scale 5e4 --fgsm
"""
import numpy as np
import torch

from curvature_tpu_torch import estimators
from curvature_tpu_torch.estimators.swag import update_batch_stats
from curvature_tpu_torch.eval import (
    STATS_COLUMNS, eval_bnn_closed_form, eval_bnn_linearized, eval_bnn_stats,
    eval_fgsm, eval_fgsm_bnn, eval_nn, eval_nn_and_bnn, eval_nn_stats,
    metrics)
from curvature_tpu_torch.models import state_from_jax
from curvature_tpu_torch.pipelines.common import (
    NUM_CLASSES, build_data, build_model, build_ood_data, layer_filter,
    loss_kind, on_device)
from curvature_tpu_torch.utils.checkpoint import (
    factors_path, load_pytree, results_paths)
from curvature_tpu_torch.utils.table import tabulate


def _compute_dtype(cfg):
    """--precision bfloat16: forwards in bf16; softmax and metrics f32."""
    return torch.bfloat16 if cfg.precision == "bfloat16" else None


def _generator(cfg, model) -> torch.Generator:
    device = next(model.parameters()).device
    return torch.Generator(device=device).manual_seed(cfg.seed)


def load_estimator(cfg, model):
    """Rebuild an estimator from saved factors (evaluate.py:347-370)."""
    name = cfg.estimator
    kw = dict(layer_filter=layer_filter(cfg), loss=loss_kind(cfg))
    device = next(model.parameters()).device

    def load(*args, **kw):
        return state_from_jax(load_pytree(factors_path(cfg, *args, **kw)),
                              device)
    if name == "diag":
        est = estimators.Diagonal(model, **kw)
        est.state = load()
    elif name == "kfac":
        est = estimators.KFAC(model, g_block_size=cfg.g_block_size,
                              attention_qkv_split=cfg.qkv_split,
                              attention_head_split=cfg.head_split, **kw)
        est.state = load()
    elif name == "efb":
        est = estimators.EFB(model, load("kfac"), **kw)
        est.state = load()
    elif name == "inf":
        est = estimators.INF(model, load("diag"), load("kfac"), load("efb"),
                             **kw)
        est.state = load(rank=str(cfg.rank))
    elif name == "swag":
        # SWAG rides the training pipeline (--swag), not factors: its state
        # lives next to the weights, in JAX's layout
        from curvature_tpu_torch.pipelines.training import weights_path
        est = estimators.SWAG(model)
        return est.load_jax_state(load_pytree(weights_path(cfg, "_swag")))
    elif name == "subspace":
        raise NotImplementedError(
            f"--estimator {name} is not ported yet (ROADMAP Queue 1 item 8)")
    else:
        raise ValueError(f"unknown estimator {name!r}")
    missing = set(est.metas) - set(est.state)
    if missing:
        # factors computed under a narrower --layers than this run asks for
        raise ValueError(
            f"saved factors at {factors_path(cfg)} lack layers "
            f"{sorted(missing)}; recompute factors or pass the matching "
            "--layers filter")
    return est


def invert_from_config(cfg, est, results_path: str):
    """norm/scale from flags or the hyperparameter search's best-params
    file; the scale is multiplied by pre_scale (evaluate.py:373-378)."""
    if cfg.norm == -1 or cfg.scale == -1:
        best = np.load(results_path + "_best_params.npy", allow_pickle=True)
        norm = np.asarray(best[0], dtype=float)
        scale = np.asarray(best[1], dtype=float)
        if norm.size == 1:
            norm = float(norm.ravel()[0])
            scale = float(scale.ravel()[0])
    else:
        norm, scale = cfg.norm, cfg.scale
    est.invert(norm, np.asarray(cfg.pre_scale * np.asarray(scale)))
    return norm, scale


def summary(predictions, labels):
    """(accuracy %, ECE, NLL) of [N, K] probabilities."""
    return (float(metrics.accuracy(predictions, labels)),
            float(metrics.expected_calibration_error(predictions, labels)[0]),
            float(metrics.negative_log_likelihood(predictions, labels)))


def _print_summary(tag: str, predictions, labels):
    """The reference prints accuracy/ECE after every eval pass
    (evaluate.py:114-118, 149-152)."""
    acc, ece, nll = summary(predictions, labels)
    print(f"{tag}: accuracy {acc:.2f}% | ECE {100 * ece:.2f}% | NLL "
          f"{nll:.4f}", flush=True)


def _stats_mode_k(cfg) -> int:
    """The output cardinality where the sufficient-statistics eval must
    be used (a vocabulary-sized head: a full [N, K] prediction matrix
    would be GBs), else 0."""
    k = getattr(cfg, "vocab", 0) or NUM_CLASSES.get(cfg.data, 10)
    return k if k >= 8192 else 0


def _print_stats_summary(tag: str, stats):
    acc = 100.0 * float(np.mean(stats[:, 2]))
    ece = float(metrics.ece_from_confidence(stats[:, 1], stats[:, 2])[0])
    nll = float(-np.mean(np.log(np.clip(stats[:, 0], 1e-12, None))))
    print(f"{tag}: accuracy {acc:.2f}% | ECE {100 * ece:.2f}% | NLL "
          f"{nll:.4f}", flush=True)


def _out_of_domain_stats(cfg, model, est, results_path: str):
    """Vocabulary-scale :func:`out_of_domain`: the per-token
    STATS_COLUMNS of the NN and the BNN on the in-domain and OOD tokens,
    computed on the device (JAX :126-180); returns (nn stats, bnn stats,
    labels)."""
    pred_kind = getattr(cfg, "predictive", "sampled") or "sampled"
    if pred_kind != "sampled":
        raise ValueError(
            f"--predictive {pred_kind} is not implemented for vocab-scale "
            "outputs (>= 8192 classes); use the sampled predictive")
    in_data, out_data = build_ood_data(cfg)
    device = next(model.parameters()).device
    in_data = list(on_device(in_data, device))
    out_data = list(on_device(out_data, device))
    dtype = _compute_dtype(cfg)
    chunk = getattr(cfg, "sample_chunk", 0) or None
    nn_s, labels = eval_nn_stats(model, in_data, compute_dtype=dtype)
    bnn_s, _ = eval_bnn_stats(model, est, in_data, cfg.samples,
                              _generator(cfg, model), sample_chunk=chunk,
                              compute_dtype=dtype)
    ood_nn_s, _ = eval_nn_stats(model, out_data, compute_dtype=dtype)
    ood_bnn_s, _ = eval_bnn_stats(model, est, out_data, cfg.samples,
                                  _generator(cfg, model), sample_chunk=chunk,
                                  compute_dtype=dtype)
    _print_stats_summary("NN ", nn_s)
    _print_stats_summary("BNN", bnn_s)
    auroc_nn = metrics.auroc(nn_s[:, 3], ood_nn_s[:, 3])
    auroc_bnn = metrics.auroc(bnn_s[:, 3], ood_bnn_s[:, 3])
    print(f"OOD AUROC (predictive entropy): NN {auroc_nn:.4f} "
          f"| BNN {auroc_bnn:.4f}", flush=True)
    if not cfg.no_results:
        np.savez_compressed(results_path + "_stats.npz",
                            stats_columns=np.asarray(STATS_COLUMNS),
                            labels=labels, nn_stats=nn_s, bnn_stats=bnn_s,
                            ood_nn_stats=ood_nn_s, ood_bnn_stats=ood_bnn_s,
                            auroc=np.asarray([auroc_nn, auroc_bnn]))
    return nn_s, bnn_s, labels


def out_of_domain(cfg, model, est, results_path: str, fig_path: str):
    """In-domain + OOD eval for NN and BNN (evaluate.py:199-280), with
    the OOD AUROC of the predictive entropy."""
    if _stats_mode_k(cfg):
        return _out_of_domain_stats(cfg, model, est, results_path)
    in_data, out_data = build_ood_data(cfg)
    device = next(model.parameters()).device
    in_data = list(on_device(in_data, device))
    out_data = list(on_device(out_data, device))
    dtype = _compute_dtype(cfg)
    chunk = getattr(cfg, "sample_chunk", 0) or None
    pred_kind = getattr(cfg, "predictive", "sampled") or "sampled"
    if pred_kind == "sampled":
        predictions, bnn_predictions, labels, stats = eval_nn_and_bnn(
            model, est, in_data, cfg.samples, _generator(cfg, model),
            cfg.stats, compute_dtype=dtype, sample_chunk=chunk)
        ood_predictions, bnn_ood_predictions, _, _ = eval_nn_and_bnn(
            model, est, out_data, cfg.samples, _generator(cfg, model), False,
            compute_dtype=dtype, sample_chunk=chunk)
    else:
        predictions, bnn_predictions, labels, ood_predictions, \
            bnn_ood_predictions = _alternative_predictive(
                cfg, model, est, in_data, out_data, pred_kind, chunk)
        stats = {}
    _print_summary("NN ", predictions, labels)
    _print_summary("BNN", bnn_predictions, labels)

    def _ent(p):
        return metrics.predictive_entropy(p).numpy()
    auroc_nn = metrics.auroc(_ent(predictions), _ent(ood_predictions))
    auroc_bnn = metrics.auroc(_ent(bnn_predictions),
                              _ent(bnn_ood_predictions))
    print(f"OOD AUROC (predictive entropy): NN {auroc_nn:.4f} "
          f"| BNN {auroc_bnn:.4f}", flush=True)
    if not cfg.no_results:
        np.savez_compressed(results_path + ".npz",
                            stats=stats,
                            labels=labels,
                            predictions=predictions,
                            bnn_predictions=bnn_predictions,
                            ood_predictions=ood_predictions,
                            bnn_ood_predictions=bnn_ood_predictions,
                            auroc=np.asarray([auroc_nn, auroc_bnn]))
    return predictions, bnn_predictions, labels


def _alternative_predictive(cfg, model, est, in_data, out_data,
                            pred_kind: str, chunk):
    """The closed-form / linearized predictives of ``--predictive``
    (JAX :192-227): the NN on both sets, the BNN through ``pred_kind``
    over one posterior draw per set from a generator seeded with
    ``--seed``. Returns (predictions, bnn_predictions, labels,
    ood_predictions, bnn_ood_predictions)."""
    if cfg.stats:
        raise ValueError(
            "--stats tracks running statistics over the SAMPLED "
            f"ensemble; it is undefined for --predictive {pred_kind}")
    if chunk:
        # the FGSM precedent: never silently ignore a flag
        raise ValueError(
            "--sample_chunk is only implemented for the sampled "
            f"predictive; drop it or use --predictive sampled "
            f"(got --predictive {pred_kind})")

    def alt_bnn(data):
        gen = _generator(cfg, model)
        if pred_kind in ("probit", "bridge"):
            return eval_bnn_closed_form(model, est, data, cfg.samples,
                                        generator=gen, method=pred_kind)[0]
        if pred_kind.startswith("linearized"):
            method = pred_kind[len("linearized"):].lstrip("_") or "mc"
            return eval_bnn_linearized(model, est, data, cfg.samples,
                                       generator=gen, method=method)[0]
        raise ValueError(f"unknown --predictive {pred_kind!r}")

    dtype = _compute_dtype(cfg)
    predictions, labels = eval_nn(model, in_data, compute_dtype=dtype)
    bnn_predictions = alt_bnn(in_data)
    ood_predictions, _ = eval_nn(model, out_data, compute_dtype=dtype)
    return (predictions, bnn_predictions, labels, ood_predictions,
            alt_bnn(out_data))


#: the reference's epsilon sweep (evaluate.py:307)
FGSM_STEPS = np.concatenate([np.linspace(0, 0.2, 11), np.linspace(0.3, 1, 8)])


def adversarial_attack(cfg, model, est, results_path: str, fig_path: str):
    """FGSM sweep for NN and BNN (evaluate.py:283-318); with --epsilon > 0
    one NN attack at that epsilon."""
    device = next(model.parameters()).device
    data = list(on_device(build_data(cfg, splits="test"), device))
    if cfg.epsilon > 0:
        return eval_fgsm(model, data, cfg.epsilon)[-1]
    stats_dict = {k: [] for k in ("eps", "acc", "ece1", "ece2", "nll", "ent")}
    bnn_stats_dict = {k: [] for k in stats_dict}
    if getattr(cfg, "sample_chunk", 0):
        raise ValueError(
            "--sample_chunk is not supported by the FGSM sweep (the "
            "ensemble stays resident across the epsilon grid); drop the "
            "flag or lower --samples")
    ensemble = est.ensemble_params(cfg.samples,
                                   generator=_generator(cfg, model))
    for step in FGSM_STEPS:
        s = eval_fgsm(model, data, float(step))[-1]
        bs = eval_fgsm_bnn(model, est, data, cfg.samples, float(step),
                           ensemble_params=ensemble)[-1]
        for k in stats_dict:
            stats_dict[k].append(s[k])
            bnn_stats_dict[k].append(bs[k])
        if not cfg.no_results:
            np.savez(results_path + "_fgsm.npz", stats=stats_dict,
                     bnn_stats=bnn_stats_dict)
    print(tabulate(stats_dict, headers="keys"))
    print(tabulate(bnn_stats_dict, headers="keys"), flush=True)
    return stats_dict, bnn_stats_dict


def test(cfg, model, fig_path: str = ""):
    """Plain deterministic test pass (evaluate.py:173-196)."""
    device = next(model.parameters()).device
    predictions, labels = eval_nn(
        model, on_device(build_data(cfg, splits="test"), device),
        compute_dtype=_compute_dtype(cfg))
    _print_summary("NN ", predictions, labels)
    return predictions, labels


def run(cfg):
    results_path, fig_path = results_paths(cfg)
    model = build_model(cfg)
    if cfg.ood or cfg.fgsm:
        est = load_estimator(cfg, model)
        if cfg.estimator == "swag" and cfg.bn_update \
                and next(model.buffers(), None) is not None:
            # SWA-averaged weights shift the activation statistics: the
            # running statistics are re-estimated at the SWA mean, as
            # standard SWAG practice (the model keeps its own weights)
            device = next(model.parameters()).device
            update_batch_stats(model, est.mean, on_device(
                build_data(cfg, splits="train"), device))
        invert_from_config(cfg, est, results_path)
        if cfg.fgsm:
            return adversarial_attack(cfg, model, est, results_path,
                                      fig_path)
        return out_of_domain(cfg, model, est, results_path, fig_path)
    return test(cfg, model, fig_path)


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
