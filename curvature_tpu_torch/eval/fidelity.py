"""Estimator-fidelity diagnostics against the exact (matrix-free) Fisher.

Port of ``curvature_tpu/eval/fidelity.py``. After ``U`` updates with
``S`` label samples each, a factor state estimates ``U*S*F_block``; the
exact block Fisher is the GGN, computable matrix-free (``ops/matfree.py``),
so each estimator's structural approximation quality is measured by
comparing its undamped quadratic form against the exact one on random
Rademacher probes restricted to each layer's block (and, with
``joint=True``, on probes across all layers at once).
"""
from typing import Dict, List, Optional

import torch

from curvature_tpu_torch.ops.matfree import (
    delta_shapes, ggn_quad, random_deltas)

__all__ = ["fidelity_report"]


def fidelity_report(est, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    num_probes: int = 8, norm: float = 1.0,
                    train: bool = True, layers: Optional[list] = None,
                    joint: bool = False,
                    probes: Optional[Dict[str, List[Dict]]] = None
                    ) -> Dict[str, Dict]:
    """Per-layer relative error of the estimator's implied Fisher.

    Args:
      est: a fitted estimator (``update`` already accumulated factors).
      x: a representative batch in the model's input layout: the exact
        Fisher is evaluated on it.
      generator: draws the Rademacher probes, row by row and probe by
        probe, where ``probes`` does not give them.
      norm: updates*samples accumulated into ``est.state`` (the states are
        raw running sums; dividing by ``norm`` gives per-update-per-sample
        Fisher units).
      layers: restrict to these layer names (default: all tracked).
      probes: injected probes, ``{row: [num_probes dicts {layer: probe}]}``
        with ``row`` a layer name or ``"__joint__"`` (every layer).

    Returns ``{layer: {"rel_err", "scaled_rel_err", "alpha", "q_true",
    "q_est"}}``, plus a ``"__joint__"`` row with ``joint=True``:

      * ``rel_err``: probe-averaged ``|q_est/norm - q_true| / |q_true|``;
      * ``alpha``/``scaled_rel_err``: the least-squares scale ``alpha =
        argmin sum(alpha*q_est - q_true)^2`` over the probes and the
        residual error under it, the scale-free structural error;
      * ``q_true``/``q_est``: the probe means.

    The joint row's residual for a layer-local estimator is the
    cross-layer curvature it drops, which the global ``Subspace`` keeps.
    """
    metas = est.metas
    names = list(metas) if layers is None else list(layers)
    unknown = [n for n in names if n not in metas]
    if unknown:
        raise ValueError(f"not tracked by this estimator: {unknown}")
    shapes = delta_shapes(metas)
    device = est.device

    def draw(probe_names):
        sub = {n: metas[n] for n in probe_names}
        return random_deltas(sub, generator, device=device)

    def one_row(row, probe_names):
        errs, q_trues, q_ests = [], [], []
        for j in range(num_probes):
            probe = (probes[row][j] if probes is not None
                     else draw(probe_names))
            probe = {n: torch.as_tensor(probe[n], dtype=torch.float32,
                                        device=device)
                     for n in probe_names}
            deltas = {n: probe[n] if n in probe
                      else torch.zeros(shapes[n], device=device)
                      for n in metas}
            q_true = float(ggn_quad(est.model, metas, x, probe,
                                    loss=est.loss, train=train))
            q_est = est.quadratic_form(deltas, add=0.0,
                                       multiply=1.0) / norm
            errs.append(abs(q_est - q_true) / (abs(q_true) + 1e-30))
            q_trues.append(q_true)
            q_ests.append(q_est)
        qt = torch.tensor(q_trues, dtype=torch.float32)
        qe = torch.tensor(q_ests, dtype=torch.float32)
        alpha = float(torch.sum(qe * qt) / (torch.sum(qe * qe) + 1e-30))
        scaled = float(torch.mean(torch.abs(alpha * qe - qt)
                                  / (torch.abs(qt) + 1e-30)))
        return {
            "rel_err": float(torch.mean(torch.tensor(errs,
                                                     dtype=torch.float32))),
            "scaled_rel_err": scaled,
            "alpha": alpha,
            "q_true": float(torch.mean(qt)),
            "q_est": float(torch.mean(qe)),
        }

    report = {name: one_row(name, [name]) for name in names}
    if joint:
        report["__joint__"] = one_row("__joint__", names)
    return report
