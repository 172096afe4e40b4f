"""Calibration / uncertainty metrics.

Port of ``curvature_tpu/eval/metrics.py`` (reference utils.py:21-267).
The scalar metrics (``accuracy``, ``confidence``,
``negative_log_likelihood``, ``predictive_entropy``, the equal-width ECE
and ``ece_from_confidence``) and ``get_eigenvalues`` run in torch: inputs
may be numpy arrays or tensors, results are tensors. The plot-facing
helpers (``calibration_curve``, ``binned_kl_distance``,
``linear_interpolation``, ``rmse``, ``gaussian_nll``, ``auroc``) run in
numpy on the host, as in JAX.
"""
from typing import Dict

import numpy as np
import torch


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype)


def accuracy(probabilities, labels) -> torch.Tensor:
    """Top-1 accuracy in percent (utils.py:79-90)."""
    p, y = _t(probabilities), _t(labels)
    return 100.0 * (p.argmax(dim=1) == y.to(p.device)).float().mean()


def confidence(probabilities, mean: bool = True) -> torch.Tensor:
    """Max predicted probability (utils.py:125-138)."""
    conf = _t(probabilities).max(dim=1).values
    return conf.mean() if mean else conf


def negative_log_likelihood(probabilities, labels) -> torch.Tensor:
    """NLL of the predicted class probabilities (utils.py:141-152)."""
    p, y = _t(probabilities), _t(labels).long()
    picked = p.gather(1, y.to(p.device)[:, None])[:, 0]
    return -torch.log(picked + 1e-12).mean()


def predictive_entropy(probabilities, mean: bool = False) -> torch.Tensor:
    """Row-wise Shannon entropy, rows renormalized (utils.py:250-267)."""
    p = _t(probabilities)
    p = p / p.sum(dim=1, keepdim=True)
    ent = -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum(1)
    return ent.mean() if mean else ent


def expected_calibration_error(probabilities, labels, bins: int = 10):
    """Equal-width-bin ECE (utils.py:207-247). Returns (ece, bin_ace,
    bin_accuracy, bin_confidence); empty bins contribute zeros."""
    p, y = _t(probabilities), _t(labels)
    conf = p.max(dim=1).values
    correct = (p.argmax(dim=1) == y.to(p.device)).to(conf.dtype)
    return ece_from_confidence(conf, correct, bins)


def ece_from_confidence(conf, correct, bins: int = 10):
    """Equal-width-bin ECE from per-sample (confidence, correctness), the
    sufficient statistics; :func:`expected_calibration_error` delegates
    here."""
    conf = _t(conf)
    correct = _t(correct).to(conf.dtype)
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=conf.dtype,
                           device=conf.device)
    mask = ((conf[None, :] > edges[:-1, None])
            & (conf[None, :] <= edges[1:, None])).to(conf.dtype)
    count = mask.sum(dim=1)
    nonempty = count > 0
    safe = count.clamp(min=1)
    zero = torch.zeros_like(count)
    bin_acc = torch.where(nonempty, (mask * correct).sum(1) / safe, zero)
    bin_conf = torch.where(nonempty, (mask * conf).sum(1) / safe, zero)
    ace = torch.where(nonempty, bin_conf - bin_acc, zero)
    ece = (count / conf.shape[0] * ace.abs()).sum()
    return ece, ace, bin_acc, bin_conf


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def calibration_curve(probabilities, labels, bins: int = 20):
    """Equal-count-bin ECE (utils.py:155-204): bin edges every ``step``-th
    sorted confidence (plus the max), strict inequalities on both sides.
    Returns (ece, avg_confidence, accuracy, proportion) over the non-empty
    bins, in numpy."""
    probabilities = _np(probabilities)
    labels = _np(labels)
    conf = np.max(probabilities, axis=1)
    n = conf.shape[0]
    step = (n + bins - 1) // bins
    edges = np.sort(conf)[::step]
    if n % step != 1:
        edges = np.concatenate([edges, [np.max(conf)]])
    correct = np.argmax(probabilities, axis=1) == labels
    xs, ys, zs = [], [], []
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf < hi)
        prop = in_bin.mean()
        if prop > 0:
            acc_in = correct[in_bin].mean()
            conf_in = conf[in_bin].mean()
            ece += np.abs(conf_in - acc_in) * prop
            xs.append(conf_in)
            ys.append(acc_in)
            zs.append(prop)
    return float(ece), np.array(xs), np.array(ys), np.array(zs)


def binned_kl_distance(dist1, dist2, smooth: float = 1e-7,
                       bins: np.ndarray = None) -> float:
    """Symmetric discrete KL (JSD) between two samples (utils.py:93-122)."""
    if bins is None:
        bins = np.logspace(-7, 1, num=200)
    p1, _ = np.histogram(_np(dist1), bins)
    p2, _ = np.histogram(_np(dist2), bins)
    p1 = (p1 + smooth) / (p1 + smooth).sum()
    p2 = (p2 + smooth) / (p2 + smooth).sum()
    return float(np.sum(p1 * np.log(p1 / p2)) + np.sum(p2 * np.log(p2 / p1)))


def linear_interpolation(min_val: float, max_val: float,
                         data) -> np.ndarray:
    """Rescale ``data`` linearly into [min_val, max_val] (utils.py:63-76)."""
    data = _np(data)
    return ((max_val - min_val) * (data - np.min(data))
            / (np.max(data) - np.min(data)) + min_val)


def rmse(mean, targets) -> float:
    """Root-mean-square error over all outputs (regression)."""
    d = _np(mean).astype(np.float64) - _np(targets).astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def gaussian_nll(mean, var, targets) -> float:
    """Mean heteroscedastic Gaussian NLL (natural log)."""
    m = _np(mean).astype(np.float64)
    v = _np(var).astype(np.float64)
    y = _np(targets).astype(np.float64)
    return float(np.mean(0.5 * (np.log(2 * np.pi * v) + (y - m) ** 2 / v)))


def auroc(scores_negative, scores_positive) -> float:
    """Area under the ROC curve via the rank (Mann-Whitney U) statistic:
    P(score_positive > score_negative) + 0.5 P(tie), ties at their mid
    rank. OOD detection scores with predictive entropy (positive = OOD)."""
    neg = _np(scores_negative).astype(np.float64).ravel()
    pos = _np(scores_positive).astype(np.float64).ravel()
    both = np.concatenate([neg, pos])
    order = np.argsort(both, kind="mergesort")
    ranks = np.empty_like(both)
    ranks[order] = np.arange(1, both.size + 1, dtype=np.float64)
    uniq, inv, cnt = np.unique(both, return_inverse=True,
                               return_counts=True)
    if (cnt > 1).any():
        sums = np.zeros(uniq.size)
        np.add.at(sums, inv, ranks)
        ranks = (sums / cnt)[inv]
    u = ranks[neg.size:].sum() - pos.size * (pos.size + 1) / 2.0
    return float(u / (neg.size * pos.size))


def get_eigenvalues(state: Dict) -> torch.Tensor:
    """All factor eigenvalues, concatenated over layers (utils.py:21-42):
    a KFAC layer gives the outer product of its two factors' eigenvalues
    (per block where factors carry leading block axes), a diagonal-style
    layer its flattened entries."""
    pieces = []
    for value in state.values():
        if isinstance(value, dict) and "a" in value and "g" in value:
            wa = torch.linalg.eigvalsh(_t(value["a"]))
            wg = torch.linalg.eigvalsh(_t(value["g"]))
            if wa.ndim < wg.ndim:
                wa = wa.reshape(wa.shape[:-1] + (1,) * (wg.ndim - wa.ndim)
                                + wa.shape[-1:])
            elif wg.ndim < wa.ndim:
                wg = wg.reshape(wg.shape[:-1] + (1,) * (wa.ndim - wg.ndim)
                                + wg.shape[-1:])
            pieces.append((wa[..., :, None] * wg[..., None, :]).reshape(-1))
            if "a_bias" in value:
                wb = _t(value["a_bias"])[..., None]
                pieces.append((wb * torch.linalg.eigvalsh(_t(value["g"])))
                              .reshape(-1))
        else:
            arr = value if not isinstance(value, dict) else value.get("lam")
            pieces.append(_t(arr).reshape(-1))
    return torch.cat(pieces)
