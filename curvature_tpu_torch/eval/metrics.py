"""Calibration / uncertainty metrics.

Port of ``curvature_tpu/eval/metrics.py`` (``accuracy``,
``expected_calibration_error``, ``negative_log_likelihood``,
``predictive_entropy``) in torch; inputs may be numpy arrays or tensors,
results are tensors.
"""
import torch


def _t(a, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype)


def accuracy(probabilities, labels) -> torch.Tensor:
    """Top-1 accuracy in percent."""
    p, y = _t(probabilities), _t(labels)
    return 100.0 * (p.argmax(dim=1) == y.to(p.device)).float().mean()


def negative_log_likelihood(probabilities, labels) -> torch.Tensor:
    """NLL of the predicted class probabilities."""
    p, y = _t(probabilities), _t(labels).long()
    picked = p.gather(1, y.to(p.device)[:, None])[:, 0]
    return -torch.log(picked + 1e-12).mean()


def predictive_entropy(probabilities, mean: bool = False) -> torch.Tensor:
    """Row-wise Shannon entropy, rows renormalized."""
    p = _t(probabilities)
    p = p / p.sum(dim=1, keepdim=True)
    ent = -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum(1)
    return ent.mean() if mean else ent


def expected_calibration_error(probabilities, labels, bins: int = 10):
    """Equal-width-bin ECE. Returns (ece, bin_ace, bin_accuracy,
    bin_confidence); empty bins contribute zeros."""
    p, y = _t(probabilities), _t(labels)
    conf = p.max(dim=1).values
    correct = (p.argmax(dim=1) == y.to(p.device)).to(conf.dtype)
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
