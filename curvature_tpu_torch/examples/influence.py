"""Data attribution with curvature inverse products: find label noise.

Port of ``examples/influence.py``. Influence functions (Koh & Liang,
2017) rank training examples by their effect on a test loss,
``-g_test^T P^{-1} g_train``; self-influence ``g_i^T P^{-1} g_i``
(Feldman & Zhang, 2020) scores how much an example relies on its own
memorization. Every estimator applies its inverse exactly
(``precision_solve``), so neither score iterates.

A small MLP is trained on synthetic classification data with a fraction
of deliberately FLIPPED labels, a KFAC Fisher is fitted at the optimum,
and self-influence must put the flipped examples at the top of its
ranking (the data are numpy seed 0's, as in JAX).

    python -m curvature_tpu_torch.examples.influence [--platform cpu]
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from curvature_tpu_torch import estimators, models
from curvature_tpu_torch.eval.influence import (
    influence_scores, self_influence)
from curvature_tpu_torch.utils.device import resolve_device


def make_data(rng, n, dim, classes):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    w = rng.standard_normal((dim, classes)).astype(np.float32)
    y = np.argmax(x @ w + 0.3 * rng.standard_normal((n, classes)), axis=1)
    return x, y.astype(np.int64)


def train(model, x, y, steps, lr=1e-2):
    """``steps`` full-batch Adam steps on the mean cross-entropy."""
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
    return model


def main(argv=None):
    """Returns {"precision": self-influence top-k precision, "frac":
    share of flipped examples among the largest |test influence|,
    "chance": the flipped share}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="")
    ap.add_argument("--flip", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    rng = np.random.default_rng(0)
    dim, classes = 20, 5
    x, y = make_data(rng, args.n, dim, classes)
    x_test, y_test = make_data(rng, 256, dim, classes)

    # flip a fraction of the training labels
    n_flip = int(args.flip * args.n)
    flip_idx = rng.choice(args.n, n_flip, replace=False)
    y_noisy = y.copy()
    y_noisy[flip_idx] = (y_noisy[flip_idx]
                         + rng.integers(1, classes, n_flip)) % classes

    x, y_noisy, x_test, y_test = (torch.as_tensor(v, device=device)
                                  for v in (x, y_noisy, x_test, y_test))
    torch.manual_seed(0)
    model = models.mlp([32], classes, in_features=dim, device=device)
    train(model, x, y_noisy, args.steps)

    est = estimators.KFAC(model)
    est.update(x, generator=torch.Generator(device=device).manual_seed(1),
               num_samples=4)

    si = self_influence(est, x, y_noisy, add=1.0,
                        multiply=1.0).cpu().numpy()
    order = np.argsort(-si)                  # most self-influential first
    top = order[:n_flip]
    hits = len(set(top.tolist()) & set(flip_idx.tolist()))
    precision = hits / max(n_flip, 1)
    base_rate = n_flip / args.n
    print(f"flipped {n_flip}/{args.n} labels; self-influence top-{n_flip} "
          f"precision {precision:.2f} (chance {base_rate:.2f})")
    if precision <= 2 * base_rate:
        raise SystemExit("self-influence failed to rank the label noise")

    # test-set influence: the flipped examples are the most CONTESTED,
    # their |influence| on a clean test loss dwarfs the clean examples'
    inf = influence_scores(est, x, y_noisy, x_test, y_test, add=1.0,
                           multiply=1.0).cpu().numpy()
    frac = float(np.isin(np.argsort(-np.abs(inf))[:n_flip],
                         flip_idx).mean())
    print(f"largest |test influence| top-{n_flip}: {frac:.2f} are flipped "
          f"examples (chance {base_rate:.2f})")
    if frac <= 2 * base_rate:
        raise SystemExit("test influence failed to rank the label noise")
    print("influence OK")
    return {"precision": precision, "frac": frac, "chance": base_rate}


if __name__ == "__main__":
    main()
