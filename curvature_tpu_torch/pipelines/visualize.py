"""Tables over saved results (reference scripts/visualize.py).

Port of the table half of ``curvature_tpu/pipelines/visualize.py``:
``load_results``, the best-damping table (``hyperparameter_table``) and
the factor summary (``summary_table``, ``--summary``), printed as JAX
prints them with ``tabulate`` (``utils/table.py``, byte for byte). The
figures need matplotlib, which the port does not use: each figure toggle
(``--calibration``, ``--networks``, ``--ood``, ``--ecdf``,
``--entropy``, ``--eigvals``, ``--hyper``, whose table comes before a
figure, ``--fgsm`` and ``--landscapes``) raises ``NotImplementedError``.

    python -m curvature_tpu_torch.pipelines.visualize --model lenet5 \\
        --data mnist --root_dir <root> --estimator kfac --summary
"""
import dataclasses
import os
from typing import Dict, List

import numpy as np

from curvature_tpu_torch.utils.checkpoint import factors_path, load_pytree
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


def run(cfg):
    """Toggle dispatch (reference visualize.py:457-481): the tables; a
    figure toggle raises."""
    figures = [f"--{t}" for t in FIGURE_TOGGLES if getattr(cfg, t)]
    if figures:
        raise NotImplementedError(
            f"{'/'.join(figures)}: visualize's figures need matplotlib, "
            "which the port does not use (ROADMAP Queue 1 item 7)")
    if cfg.summary:
        return summary_table(cfg)
    return None


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
