"""The modern Laplace workflow in one script.

Port of ``examples/modern_laplace.py``. Trains LeNet-5 on synthetic data
(collecting SWAG iterates on the way), then compares calibrated
predictives side by side:

  MAP            plain softmax
  MAP + temp     temperature scaling (Guo et al., 2017)
  KFAC sampled   the reference's MC push-through
  KFAC GLM       linearized-Laplace predictive (Immer et al., 2021)
  last-layer     subnetwork Laplace via layer_filter='last'
  SWAG           SGD-iterate Gaussian (Maddox et al., 2019)

with the damping tuned by evidence gradient ascent (no validation pass).

    python -m curvature_tpu_torch.examples.modern_laplace [--platform cpu]
"""
import argparse

import torch

from curvature_tpu_torch import laplace
from curvature_tpu_torch.estimators.swag import SWAG
from curvature_tpu_torch.eval import (
    eval_bnn, eval_nn, eval_nn_temperature, metrics)
from curvature_tpu_torch.pipelines import training
from curvature_tpu_torch.pipelines.common import (
    build_data, build_model, on_device)
from curvature_tpu_torch.utils.config import Config


def row(name, probs, labels):
    acc = float(metrics.accuracy(probs, labels))
    ece = 100 * float(metrics.expected_calibration_error(probs, labels)[0])
    nll = float(metrics.negative_log_likelihood(probs, labels))
    print(f"{name:<14} acc {acc:6.2f}%   ECE {ece:5.2f}%   NLL {nll:.4f}")
    return acc, ece, nll


def main(argv=None):
    """Returns {row name: (acc %, ECE %, NLL)} and the evidence under
    ``"log marginal likelihood"``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--samples", type=int, default=20)
    args = ap.parse_args(argv)

    cfg = Config(model="lenet5", data="synthetic", batch_size=64,
                 epochs=args.epochs, lr=5e-2, samples=args.samples,
                 swag=True, seed=0, platform=args.platform)
    model = build_model(cfg)
    device = next(model.parameters()).device
    train_np = list(build_data(cfg, splits="train"))
    train_data = list(on_device(train_np, device))
    test_data = list(on_device(build_data(cfg, splits="test"), device))
    out = {}

    print(f"Training ({cfg.epochs} epochs) with SWAG collection...")
    swag = SWAG(model, max_rank=cfg.swag_rank)
    training.train(model, train_np, cfg, swag=swag)
    swag.invert(multiply=1.0)

    probs, labels = eval_nn(model, test_data)
    out["MAP"] = row("MAP", probs, labels)

    t_probs, _, temp = eval_nn_temperature(model, train_data, test_data)
    out["MAP + temp"] = row(f"MAP + T={temp:.2f}", t_probs, labels)

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    print("Fitting KFAC + tuning damping by evidence gradient ascent...")
    la = laplace.fit(model, train_data, estimator="kfac", mc_samples=2,
                     generator=gen())
    res = la.optimize_prior_precision(steps=150)
    out["log marginal likelihood"] = res["log_marglik"]
    print(f"  log marginal likelihood {res['log_marglik']:.1f}")
    xs = torch.cat([x for x, _ in test_data])
    out["KFAC sampled"] = row(
        "KFAC sampled", la.predictive(xs, samples=cfg.samples), labels)
    out["KFAC GLM"] = row("KFAC GLM", la.predictive(
        xs, method="linearized", samples=cfg.samples), labels)

    ll = laplace.fit(model, train_data, estimator="kfac", subset="last",
                     mc_samples=2, generator=gen())
    ll.optimize_prior_precision(steps=150)
    out["last-layer"] = row("last-layer",
                            ll.predictive(xs, samples=cfg.samples), labels)

    sw_probs, _, _ = eval_bnn(
        model, swag, test_data, samples=cfg.samples,
        generator=torch.Generator(device=device).manual_seed(2))
    out["SWAG"] = row("SWAG", sw_probs, labels)
    return out


if __name__ == "__main__":
    main()
