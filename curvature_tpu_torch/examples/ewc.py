"""Elastic Weight Consolidation with Laplace curvature (Kirkpatrick et
al., 2017): the Gaussian API's quadratic form as a training penalty.

Port of ``examples/ewc.py``. Sequential tasks: train on task A, fit a
KFAC Fisher at the task-A optimum, then train on task B with the penalty

    L_B(theta) + lam/2 * (theta - theta_A)^T F_A (theta - theta_A)

where the quadratic form is the estimator's ``quad_state``, differentiated
by autograd inside each task-B step (optax's Adam is ``torch.optim.Adam``).
The tasks are feature-permuted versions of one synthetic classification
problem (permuted-MNIST style), drawn from numpy seed 0 as in JAX.

    python -m curvature_tpu_torch.examples.ewc [--platform cpu] [--lam 50]

Prints task-A retention with and without the penalty; EWC must retain
more.
"""
import argparse
import copy

import numpy as np
import torch
import torch.nn.functional as F

from curvature_tpu_torch import estimators, models
from curvature_tpu_torch.nn.core import param_key, param_matrix
from curvature_tpu_torch.utils.device import resolve_device


def make_task(rng, n, dim, classes, perm=None):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    w = rng.standard_normal((dim, classes)).astype(np.float32)
    y = np.argmax(x @ w + 0.5 * rng.standard_normal((n, classes)), axis=1)
    if perm is not None:
        x = x[:, perm]
    return x, y.astype(np.int64)


@torch.no_grad()
def accuracy(model, x, y):
    model.eval()
    return float((model(x).argmax(-1) == y).float().mean())


def train(model, x, y, steps, lr, penalty=None):
    """``steps`` full-batch Adam steps on the mean cross-entropy (plus
    ``penalty(model)``) of a copy of ``model``; returns the copy."""
    model = copy.deepcopy(model)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        if penalty is not None:
            loss = loss + penalty(model)
        loss.backward()
        opt.step()
    return model


def main(argv=None):
    """Returns {"plain": task-A accuracy after B, "ewc": ...}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="")
    ap.add_argument("--lam", type=float, default=50.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mc_samples", type=int, default=8)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    rng = np.random.default_rng(0)
    dim, classes = 20, 5
    xa, ya = make_task(rng, 1024, dim, classes)
    perm = rng.permutation(dim)
    xb, yb = make_task(rng, 1024, dim, classes, perm=perm)
    xa, ya, xb, yb = (torch.as_tensor(v, device=device)
                      for v in (xa, ya, xb, yb))

    torch.manual_seed(0)
    model = models.mlp([64], classes, in_features=dim, device=device)

    # task A
    model_a = train(model, xa, ya, args.steps, 1e-2)
    acc_a0 = accuracy(model_a, xa, ya)

    # Fisher at the task-A optimum (MC-label KFAC, the reference's
    # protocol, factors.py:33-62)
    est = estimators.KFAC(model_a)
    est.update(xa, generator=torch.Generator(device=device).manual_seed(1),
               num_samples=args.mc_samples)
    metas = est.metas
    map_mats = {n: param_matrix(m, est.mean_params[param_key(n, "weight")],
                                est.mean_params.get(param_key(n, "bias")))
                for n, m in metas.items()}
    add = torch.full((len(metas),), 1e-8, device=device)
    mul = torch.ones(len(metas), device=device)

    def ewc_penalty(m):
        own = dict(m.named_parameters())
        deltas = {n: param_matrix(meta, own[param_key(n, "weight")],
                                  own.get(param_key(n, "bias"))) - map_mats[n]
                  for n, meta in metas.items()}
        return 0.5 * args.lam * est.quad_state(est.state, add, mul, deltas)

    # task B, with and without consolidation
    plain = train(model_a, xb, yb, args.steps, 1e-2)
    ewc = train(model_a, xb, yb, args.steps, 1e-2, penalty=ewc_penalty)

    rows = [("task A after A", acc_a0, None),
            ("plain  B", accuracy(plain, xb, yb), accuracy(plain, xa, ya)),
            ("EWC    B", accuracy(ewc, xb, yb), accuracy(ewc, xa, ya))]
    for name, b, a in rows:
        retained = "" if a is None else f"   task-A retained {100 * a:.1f}%"
        print(f"{name:<15} acc {100 * b:6.1f}%{retained}")
    plain_a, ewc_a = rows[1][2], rows[2][2]
    print(f"EWC retention gain: {100 * (ewc_a - plain_a):+.1f} points")
    if ewc_a <= plain_a:
        raise SystemExit("EWC did not retain more task-A accuracy")
    return {"plain": plain_a, "ewc": ewc_a}


if __name__ == "__main__":
    main()
