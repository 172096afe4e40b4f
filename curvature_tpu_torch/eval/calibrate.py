"""Temperature scaling (Guo et al., 2017), the deterministic calibration
baseline the Bayesian predictives are compared against.

Port of ``curvature_tpu/eval/calibrate.py``: one scalar temperature T is
fit by NLL minimization on a validation set (Adam on log T, 200 steps at
lr 0.05: ``torch.optim.Adam``, whose defaults b1 0.9, b2 0.999, eps 1e-8
outside the square root are optax's), then applied as
``softmax(logits / T)``. It keeps the argmax, so it changes calibration,
never accuracy.
"""
from typing import Iterable, Tuple

import numpy as np
import torch

from curvature_tpu_torch.eval.evaluate import _batches, _device
from curvature_tpu_torch.eval.predictive import eval_mode


@torch.no_grad()
def collect_logits(model, data: Iterable) -> Tuple[np.ndarray, np.ndarray]:
    """[N, K] raw logits and [N] labels over a dataset (eval mode)."""
    outs, labels = [], []
    with eval_mode(model):
        for x, y in _batches(data, _device(model)):
            logits = model(x).float()
            outs.append(logits.reshape(-1, logits.shape[-1]).cpu().numpy())
            labels.append(y)
    return np.concatenate(outs), np.concatenate(labels)


def fit_temperature(logits, labels, steps: int = 200, lr: float = 0.05
                    ) -> float:
    """Scalar temperature minimizing the validation NLL, optimized in
    log T from T = 1 (JAX runs the loop as one ``lax.scan``; here it is
    ``steps`` Adam steps on the logits' device)."""
    logits = torch.as_tensor(logits, dtype=torch.float32)
    labels = torch.as_tensor(np.asarray(labels), device=logits.device).long()
    log_t = torch.zeros((), device=logits.device, requires_grad=True)
    opt = torch.optim.Adam([log_t], lr=lr)
    for _ in range(int(steps)):
        opt.zero_grad()
        logp = torch.log_softmax(logits / torch.exp(log_t), dim=-1)
        nll = -logp.gather(1, labels[:, None]).mean()
        nll.backward()
        opt.step()
    return float(torch.exp(log_t.detach()))


def temperature_scale(logits, temperature: float) -> np.ndarray:
    """softmax(logits / T) probabilities."""
    z = torch.as_tensor(logits, dtype=torch.float32) / float(temperature)
    return torch.softmax(z, dim=-1).cpu().numpy()


def eval_nn_temperature(model, val_data: Iterable, test_data: Iterable
                        ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fit T on ``val_data``; return (scaled test probabilities, test
    labels, T)."""
    v_logits, v_labels = collect_logits(model, val_data)
    t = fit_temperature(v_logits, v_labels)
    t_logits, t_labels = collect_logits(model, test_data)
    return temperature_scale(t_logits, t), t_labels, t
