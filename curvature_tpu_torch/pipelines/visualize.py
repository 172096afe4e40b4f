"""Figure assembly CLI over saved results (reference scripts/visualize.py).

Port of ``curvature_tpu/pipelines/visualize.py``: loads the ``.npz``/
``.npy`` artifacts written by the factors / evaluate / hyper / loss
pipelines and draws comparison figures (``pipelines/plot.py``, as PDF)
and tables (``utils/table.py``, ``tabulate``'s format byte for byte),
dispatching on the same toggles as the reference (visualize.py:457-481):
``--calibration``, ``--networks``, ``--ood``/``--ecdf``/``--entropy``,
``--eigvals`` (the factors' eigenvalues on the run's device), ``--hyper``,
``--fgsm``, ``--summary``, ``--landscapes``. Under ``--mesh`` rank 0
writes.

    python -m curvature_tpu_torch.pipelines.visualize --model lenet5 \\
        --data mnist --root_dir <root> --estimator kfac --summary --eigvals
"""
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.pipelines import plot
from curvature_tpu_torch.utils import figure as plt
from curvature_tpu_torch.utils.checkpoint import (factors_path, load_pytree,
                                                  results_paths, write_once)
from curvature_tpu_torch.utils.table import tabulate

ESTIMATORS = ("diag", "kfac", "efb", "inf")
#: the toggles that draw figures (reference visualize.py:457-481)
FIGURE_TOGGLES = ("calibration", "networks", "ood", "ecdf", "entropy",
                  "eigvals", "hyper", "fgsm", "landscapes")


def load_results(path: str) -> Dict[str, np.ndarray]:
    """Load a saved predictions archive (reference load_data,
    visualize.py:19-30)."""
    with np.load(path + ".npz", allow_pickle=True) as data:
        return {k: data[k] for k in data.files}


def calibration_comparison(cfg, fig_path: str = ""):
    """Per-model calibration across estimators (visualize.py:72-113)."""
    fig, ax = plt.subplots(figsize=(8, 7), tight_layout=True)
    colors = ["black", "dodgerblue", "crimson", "forestgreen", "darkorange"]
    drew_nn = False
    for i, est in enumerate(ESTIMATORS):
        c = dataclasses.replace(cfg, estimator=est)
        results_path, _ = results_paths(c)
        try:
            res = load_results(results_path)
        except FileNotFoundError:
            continue
        if not drew_nn:
            plot.calibration(res["predictions"], res["labels"], axis=ax,
                             label="NN", color=colors[0])
            drew_nn = True
        plot.calibration(res["bnn_predictions"], res["labels"], axis=ax,
                         label=f"BNN-{est.upper()}", color=colors[i + 1])
    # SWA/SWAG baselines (reference visualize.py:105-113): the SWAG chain
    # (training --swag -> evaluate --estimator swag) writes this layout;
    # archives with 'predictions' + 'labels' under 'swa' / 'swag' overlay
    for est, color in (("swa", "slategray"), ("swag", "mediumorchid")):
        c = dataclasses.replace(cfg, estimator=est)
        results_path, _ = results_paths(c)
        try:
            res = load_results(results_path)
        except FileNotFoundError:
            continue
        preds = res.get("bnn_predictions", res.get("predictions"))
        plot.calibration(preds, res["labels"], axis=ax,
                         label=est.upper(), color=color)
    if fig_path:
        write_once(fig.savefig, fig_path + "_calibration.pdf",
                   bbox_inches="tight")
    return fig


def networks_overview(cfg, models_list: Optional[List[str]] = None,
                      fig_path: str = ""):
    """Calibration overview across model architectures for one estimator
    (reference visualize.py:116-145, 211-240)."""
    models_list = models_list or [cfg.model]
    fig, ax = plt.subplots(figsize=(8, 7), tight_layout=True)
    cmap = plt.get_cmap("tab10")
    for i, m in enumerate(models_list):
        c = dataclasses.replace(cfg, model=m)
        results_path, _ = results_paths(c)
        try:
            res = load_results(results_path)
        except FileNotFoundError:
            continue
        plot.calibration(res["predictions"], res["labels"], axis=ax,
                         label=f"{m} NN", color=cmap(i))
        plot.calibration(res["bnn_predictions"], res["labels"], axis=ax,
                         label=f"{m} BNN-{cfg.estimator.upper()}",
                         color=cmap(i))
    if fig_path:
        write_once(fig.savefig, fig_path + "_networks.pdf",
                   bbox_inches="tight")
    return fig


def ood_comparison(cfg, fig_path: str = ""):
    """OOD inverse-ECDF panels per estimator (visualize.py:148-208)."""
    results_path, default_fig = results_paths(cfg)
    res = load_results(results_path)
    plot.ood_panels(cfg, res["predictions"], res["bnn_predictions"],
                    res["ood_predictions"], res["bnn_ood_predictions"],
                    res["labels"], fig_path or default_fig)


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in tree.items()}


def eigenvalue_figure(cfg, fig_path: str = ""):
    """Eigenvalue histogram of the saved factors (visualize.py:243-254),
    their eigenvalues computed on the run's device (``--platform``).

    When a ``factors --spectrum`` artifact exists alongside, the top Ritz
    values of the TRUE curvature are overlaid and its spectral density
    drawn."""
    from curvature_tpu_torch.utils.config import device
    state = _on(load_pytree(factors_path(cfg)), device(cfg))
    ev = metrics.get_eigenvalues(state).cpu().numpy()
    spectrum_path = factors_path(cfg) + "_spectrum.npz"
    ritz = None
    base = (fig_path or results_paths(cfg)[1])
    if os.path.exists(spectrum_path):
        spec = np.load(spectrum_path)
        ritz = spec["ritz"]
        plot.spectral_density(ritz, spec["weights"],
                              path=base + "_spectrum_density.pdf",
                              label="exact curvature")
    return plot.eigenvalue_histogram(
        ev, path=base + "_eigvals.pdf",
        label=cfg.estimator.upper(), true_spectrum=ritz)


def hyperparameter_table(cfg) -> str:
    """Best (norm, scale) per estimator, reproducing the README table
    (visualize.py:257-275)."""
    rows: List[List] = []
    for est in ESTIMATORS:
        c = dataclasses.replace(cfg, estimator=est)
        path = os.path.join(c.results_dir, c.model, "data", est,
                            f"{c.prefix}{c.model}_{c.data}{c.suffix}"
                            "_best_params.npy")
        try:
            best = np.load(path, allow_pickle=True)
            norm = np.ravel(np.asarray(best[0], dtype=float))[0]
            scale = np.ravel(np.asarray(best[1], dtype=float))[0]
            rows.append([est.upper(), f"{norm:.3g}", f"{scale:.3g}"])
        except (FileNotFoundError, OSError):
            rows.append([est.upper(), "-", "-"])
    table = tabulate(rows, headers=["Estimator", "norm", "scale"])
    print(table)
    return table


def hyper_convergence(cfg, fig_path: str = ""):
    """Hyperopt cost scatter (visualize.py:278-338)."""
    subdir = cfg.optimizer
    results_path, default_fig = results_paths(cfg, subdir)
    stats = np.load(results_path + "_hyperopt_stats.npy",
                    allow_pickle=True).item()
    return plot.hyper_results(
        stats, (fig_path or default_fig) + "_hyper.pdf")


def fgsm_comparison(cfg, fig_path: str = ""):
    """Replot a saved FGSM sweep (visualize.py:341-370)."""
    results_path, default_fig = results_paths(cfg)
    with np.load(results_path + "_fgsm.npz", allow_pickle=True) as data:
        stats = data["stats"].item()
        bnn_stats = data["bnn_stats"].item()
    return plot.adversarial_results(stats["eps"], stats, bnn_stats,
                                    (fig_path or default_fig) + "_fgsm.pdf")


def summary_table(cfg) -> str:
    """Factor shapes and sizes per layer (the reference's ``summary``,
    visualize.py:373-440)."""
    state = load_pytree(factors_path(cfg))
    rows = []
    total = 0
    for name, val in state.items():
        if isinstance(val, dict):
            shapes = {k: tuple(np.asarray(v).shape) for k, v in val.items()}
            size = sum(np.asarray(v).size for v in val.values())
        else:
            shapes = tuple(np.asarray(val).shape)
            size = np.asarray(val).size
        total += size
        rows.append([name, str(shapes), size])
    rows.append(["TOTAL", "", total])
    table = tabulate(rows, headers=["Layer", "Factor shapes", "Size"])
    print(table)
    return table


def landscape_figures(cfg, fig_path: str = ""):
    """Replot saved loss-landscape scans (visualize.py:443-454)."""
    results_path, default_fig = results_paths(cfg)
    target = fig_path or default_fig
    out = []
    p1 = results_path + "_loss1d.npy"
    if os.path.exists(p1):
        out.append(plot.plot_loss1d(
            np.load(p1, allow_pickle=True).item(), target + "_loss1d.pdf"))
    p2 = results_path + "_loss2d.npy"
    if os.path.exists(p2):
        out.append(plot.plot_surfaces(
            np.load(p2, allow_pickle=True).item(), target + "_loss2d.pdf"))
    return out


def run(cfg):
    """Toggle dispatch (reference visualize.py:457-481). Returns the
    ``--summary`` table, if asked for."""
    _, fig_path = results_paths(cfg)
    table = None
    if cfg.calibration:
        calibration_comparison(cfg, fig_path)
    if cfg.networks:
        networks_overview(cfg, fig_path=fig_path)
    if cfg.ood or cfg.ecdf or cfg.entropy:
        ood_comparison(cfg, fig_path)
    if cfg.eigvals:
        eigenvalue_figure(cfg, fig_path)
    if cfg.hyper:
        hyperparameter_table(cfg)
        try:
            hyper_convergence(cfg, fig_path)
        except (FileNotFoundError, OSError):
            pass
    if cfg.fgsm:
        fgsm_comparison(cfg, fig_path)
    if cfg.summary:
        table = summary_table(cfg)
    if cfg.landscapes:
        landscape_figures(cfg, fig_path)
    return table


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
