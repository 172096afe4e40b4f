"""Plot primitives (reference scripts/plot.py:11-511).

Port of ``curvature_tpu/pipelines/plot.py``: every function under the
same name and signature, its numbers from the port's ``eval/metrics.py``.
Where JAX returns matplotlib's figure or axes, these return the port's
(``utils/figure.py``), drawn when ``path`` is given in the format its
suffix names, PDF, SVG or PNG (``Figure.savefig``, at JAX's 300 dpi);
another suffix raises ``ValueError`` (JAX, through matplotlib, writes
more; no CLI path does).
Inputs may be numpy arrays or tensors. Under ``--mesh`` rank 0 writes.
"""
import os
from typing import Dict, Optional, Sequence

import numpy as np

from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.utils import figure as plt
from curvature_tpu_torch.utils.checkpoint import write_once


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


def _save(fig, path: Optional[str]):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_once(fig.savefig, path, format=path.rsplit(".", 1)[-1],
                   dpi=300, bbox_inches="tight")


def training_curves(history: Dict, path: Optional[str] = None):
    """Loss / validation accuracy over epochs (plot.py:11-30)."""
    fig, ax1 = plt.subplots(figsize=(8, 5), tight_layout=True)
    ax1.plot(history.get("loss", []), color="tab:blue", label="train loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    if history.get("val_acc"):
        ax2 = ax1.twinx()
        ax2.plot(history["val_acc"], color="tab:orange", label="val acc")
        ax2.set_ylabel("Accuracy [%]")
    _save(fig, path)
    return fig


def factor_norms(state: Dict, path: Optional[str] = None):
    """Frobenius norm of each layer's factors (plot.py:33-45)."""
    fig, ax = plt.subplots(figsize=(10, 5), tight_layout=True)
    names = list(state)
    for key in ("a", "g"):
        vals = []
        for n in names:
            v = state[n]
            arr = v[key] if isinstance(v, dict) and key in v else v
            vals.append(float(np.linalg.norm(_np(arr))))
        ax.plot(vals, marker="o", label=f"factor {key.upper()}")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=90, fontsize=6)
    ax.set_yscale("log")
    ax.set_ylabel("||F||_F")
    ax.legend()
    _save(fig, path)
    return fig


def calibration(probabilities, labels, path: Optional[str] = None,
                label: str = "", axis=None, color=None):
    """Accuracy vs confidence using equal-count bins (plot.py:48-83)."""
    _, xs, ys, _ = metrics.calibration_curve(probabilities, labels)
    ax = axis or plt.subplots(figsize=(7, 6), tight_layout=True)[1]
    ax.plot([0, 1], [0, 1], "k:", linewidth=1)
    ax.plot(xs, ys, marker="o", label=label, color=color)
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    if label:
        ax.legend(frameon=False)
    if axis is None:
        _save(ax.figure, path)
    return ax


def reliability_diagram(probabilities, labels, bins: int = 10,
                        path: Optional[str] = None):
    """Equal-width-bin reliability bars with gap overlay (plot.py:190-219)."""
    ece, ace, accs, confs = metrics.expected_calibration_error(
        probabilities, labels, bins)
    edges = np.linspace(0, 1, bins + 1)
    centers = (edges[:-1] + edges[1:]) / 2
    fig, ax = plt.subplots(figsize=(7, 6), tight_layout=True)
    ax.bar(centers, _np(accs), width=1.0 / bins, edgecolor="k",
           color="dodgerblue", label="Accuracy")
    gap = _np(confs) - _np(accs)
    ax.bar(centers, gap, bottom=_np(accs), width=1.0 / bins,
           edgecolor="crimson", color="none", hatch="//", label="Gap")
    ax.plot([0, 1], [0, 1], "k:")
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.set_title(f"ECE: {100 * float(ece):.2f}%")
    ax.legend(frameon=False)
    _save(fig, path)
    return fig


def confidence_hist(probabilities, path: Optional[str] = None):
    """Histogram of prediction confidences (plot.py:222-257)."""
    conf = _np(metrics.confidence(probabilities, mean=False))
    fig, ax = plt.subplots(figsize=(7, 5), tight_layout=True)
    ax.hist(conf, bins=30, color="dodgerblue", edgecolor="k")
    ax.axvline(conf.mean(), color="crimson", linestyle="--",
               label=f"mean {conf.mean():.3f}")
    ax.set_xlabel("Confidence")
    ax.legend(frameon=False)
    _save(fig, path)
    return fig


def inv_ecdf_vs_pred_entropy(probabilities, color=None, linestyle="-",
                             label: str = "", axis=None,
                             path: Optional[str] = None):
    """Inverse ECDF of predictive entropy (plot.py:141-158)."""
    ent = np.sort(_np(metrics.predictive_entropy(probabilities)))
    frac = 1.0 - np.arange(1, len(ent) + 1) / len(ent)
    ax = axis or plt.subplots(figsize=(8, 6), tight_layout=True)[1]
    ax.plot(ent, frac, color=color, linestyle=linestyle, label=label)
    ax.set_xlabel("Predictive entropy")
    ax.set_ylabel("1 - ECDF")
    if axis is None:
        _save(ax.figure, path)
    return ax


def true_false_ecdf(probabilities, labels, path: Optional[str] = None):
    """Separate entropy ECDFs for correct vs wrong predictions
    (plot.py:161-187)."""
    probabilities = _np(probabilities)
    ent = _np(metrics.predictive_entropy(probabilities))
    correct = np.argmax(probabilities, 1) == _np(labels)
    fig, ax = plt.subplots(figsize=(8, 6), tight_layout=True)
    for mask, name, color in ((correct, "correct", "dodgerblue"),
                              (~correct, "wrong", "crimson")):
        e = np.sort(ent[mask])
        if len(e):
            ax.plot(e, np.arange(1, len(e) + 1) / len(e), color=color,
                    label=name)
    ax.set_xlabel("Predictive entropy")
    ax.set_ylabel("ECDF")
    ax.legend(frameon=False)
    _save(fig, path)
    return fig


def entropy_hist(in_predictions, ood_predictions,
                 path: Optional[str] = None):
    """In- vs out-of-domain predictive entropy histograms with the JSD in
    the title (plot.py:260-341)."""
    e_in = _np(metrics.predictive_entropy(in_predictions))
    e_out = _np(metrics.predictive_entropy(ood_predictions))
    jsd = metrics.binned_kl_distance(e_in, e_out)
    fig, ax = plt.subplots(figsize=(8, 6), tight_layout=True)
    bins = np.linspace(0, max(e_in.max(), e_out.max()) + 1e-6, 40)
    ax.hist(e_in, bins=bins, alpha=0.6, color="dodgerblue", label="in-domain",
            density=True)
    ax.hist(e_out, bins=bins, alpha=0.6, color="crimson", label="OOD",
            density=True)
    ax.set_xlabel("Predictive entropy")
    ax.set_title(f"JSD: {jsd:.3f}")
    ax.legend(frameon=False)
    _save(fig, path)
    return fig


def eigenvalue_histogram(eigenvalues, path: Optional[str] = None,
                         label: str = "", true_spectrum=None):
    """Log-scale histogram of factor eigenvalues (plot.py:344-397), with an
    optional rug of the exact-curvature Ritz values (factors --spectrum)."""
    ev = _np(eigenvalues)
    ev = ev[np.isfinite(ev)]
    fig, ax = plt.subplots(figsize=(8, 5), tight_layout=True)
    pos = ev[ev > 0]
    if len(pos):
        ax.hist(np.log10(pos), bins=60, color="dodgerblue", label=label)
    if true_spectrum is not None:
        ts = _np(true_spectrum)
        ts = ts[np.isfinite(ts) & (ts > 0)]
        for i, v in enumerate(np.log10(ts)):
            ax.axvline(v, color="crimson", alpha=0.6, linewidth=1,
                       label="true curvature (Lanczos)" if i == 0 else None)
    ax.set_xlabel("log10 eigenvalue")
    ax.set_ylabel("Count")
    if label or true_spectrum is not None:
        ax.legend(frameon=False)
    _save(fig, path)
    return fig


def spectral_density(ritz, weights, path: Optional[str] = None,
                     label: str = "", sigma: float = 0.25):
    """Smoothed spectral density from Lanczos quadrature nodes/weights
    (factors --spectrum artifact): density(x) = sum_j w_j N(x; log10 l_j,
    sigma^2) on the log-eigenvalue axis."""
    ritz = np.asarray(_np(ritz), dtype=np.float64)
    weights = np.asarray(_np(weights), dtype=np.float64)
    keep = np.isfinite(ritz) & (ritz > 0)
    ritz, weights = ritz[keep], weights[keep]
    fig, ax = plt.subplots(figsize=(8, 5), tight_layout=True)
    if len(ritz):
        logs = np.log10(ritz)
        grid = np.linspace(logs.min() - 3 * sigma, logs.max() + 3 * sigma,
                           512)
        dens = (weights[None, :] * np.exp(
            -0.5 * ((grid[:, None] - logs[None, :]) / sigma) ** 2)).sum(1)
        dens /= sigma * np.sqrt(2 * np.pi)
        ax.semilogy(grid, np.maximum(dens, 1e-12), color="crimson",
                    label=label or None)
        ax.vlines(logs, 1e-12, dens.max(), color="crimson", alpha=0.2,
                  linewidth=0.8)
    ax.set_xlabel("log10 eigenvalue")
    ax.set_ylabel("Spectral density (Lanczos quadrature)")
    if label:
        ax.legend(frameon=False)
    _save(fig, path)
    return fig


def adversarial_results(steps: Sequence[float], stats: Dict, bnn_stats: Dict,
                        path: Optional[str] = None):
    """NN vs BNN panels over FGSM step size (plot.py:86-138)."""
    fig, axes = plt.subplots(1, 3, figsize=(16, 5), tight_layout=True)
    for ax, key, name in zip(axes, ("acc", "ece1", "ent"),
                             ("Accuracy [%]", "ECE [%]", "Entropy")):
        ax.plot(steps, stats[key], marker="o", color="dodgerblue", label="NN")
        ax.plot(steps, bnn_stats[key], marker="s", color="crimson",
                label="BNN")
        ax.set_xlabel("FGSM step size")
        ax.set_ylabel(name)
        ax.legend(frameon=False)
    _save(fig, path if path is None or path.endswith(".pdf")
          else path + "_fgsm.pdf")
    return fig


def hyper_results(stats: Dict, path: Optional[str] = None):
    """Hyperopt cost landscape scatter over (log norm, log scale)
    (plot.py:400-451)."""
    norms = np.log10(np.asarray([n[0] for n in stats["norms"]]))
    scales = np.log10(np.asarray([s[0] for s in stats["scales"]]))
    cost = np.asarray(stats["cost"])
    fig, ax = plt.subplots(figsize=(8, 6), tight_layout=True)
    sc = ax.scatter(norms, scales, c=cost, cmap="viridis", s=40)
    best = int(np.argmin(cost))
    ax.scatter([norms[best]], [scales[best]], marker="*", s=300, color="crimson")
    fig.colorbar(sc, label="cost")
    ax.set_xlabel("log10 norm")
    ax.set_ylabel("log10 scale")
    _save(fig, path)
    return fig


def plot_loss1d(result: Dict, path: Optional[str] = None):
    """1-D loss line scan (plot.py:454-482)."""
    xs = result["xcoordinates"]
    fig, ax1 = plt.subplots(figsize=(8, 5), tight_layout=True)
    ax1.plot(xs, result["train_loss"], "b-", label="train loss")
    if result.get("val_loss") is not None:
        ax1.plot(xs, result["val_loss"], "b--", label="val loss")
    ax1.set_xlabel("alpha")
    ax1.set_ylabel("Loss", color="b")
    ax2 = ax1.twinx()
    ax2.plot(xs, result["train_acc"], "r-", label="train acc")
    if result.get("val_acc") is not None:
        ax2.plot(xs, result["val_acc"], "r--", label="val acc")
    ax2.set_ylabel("Accuracy [%]", color="r")
    _save(fig, path)
    return fig


def plot_surfaces(result: Dict, path: Optional[str] = None,
                  levels: int = 30):
    """2-D loss contour + surface (plot.py:483-511)."""
    xs, ys = result["xcoordinates"], result["ycoordinates"]
    zz = result["loss"]
    fig = plt.figure(figsize=(14, 6), tight_layout=True)
    ax1 = fig.add_subplot(1, 2, 1)
    cs = ax1.contour(xs, ys, zz, levels=levels, cmap="viridis")
    ax1.clabel(cs, inline=True, fontsize=6)
    ax1.set_xlabel("alpha")
    ax1.set_ylabel("beta")
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")
    xg, yg = np.meshgrid(xs, ys)
    ax2.plot_surface(xg, yg, zz, cmap="viridis", linewidth=0)
    _save(fig, path)
    return fig


def ood_panels(cfg, predictions, bnn_predictions, ood_predictions,
               bnn_ood_predictions, labels, fig_path: str):
    """The evaluate pipeline's OOD figure set (evaluate.py:263-280)."""
    fig, ax = plt.subplots(figsize=(12, 7), tight_layout=True)
    inv_ecdf_vs_pred_entropy(predictions, color="dodgerblue", linestyle="--",
                             axis=ax,
                             label=f"NN {cfg.data.upper()} | Acc.: "
                                   f"{float(metrics.accuracy(predictions, labels)):.2f}%")
    inv_ecdf_vs_pred_entropy(ood_predictions, color="crimson",
                             linestyle="--", axis=ax, label="NN OOD")
    inv_ecdf_vs_pred_entropy(bnn_predictions, color="dodgerblue", axis=ax,
                             label=f"BNN {cfg.data.upper()} | Acc.: "
                                   f"{float(metrics.accuracy(bnn_predictions, labels)):.2f}%")
    inv_ecdf_vs_pred_entropy(bnn_ood_predictions, color="crimson", axis=ax,
                             label="BNN OOD")
    ax.legend(fontsize=12, frameon=False)
    _save(fig, fig_path + "_ecdf.pdf")

    reliability_diagram(predictions, labels, path=fig_path + "_reliability.pdf")
    reliability_diagram(bnn_predictions, labels,
                        path=fig_path + "_bnn_reliability.pdf")
    entropy_hist(predictions, ood_predictions, path=fig_path + "_entropy.pdf")
    entropy_hist(bnn_predictions, bnn_ood_predictions,
                 path=fig_path + "_bnn_entropy.pdf")
