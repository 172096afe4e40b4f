"""The 60-second blitz (reference scripts/test.py, README.rst:91-149):
KFAC on LeNet-5 -> invert -> sample posterior weights -> Bayesian eval.

Port of ``examples/blitz.py``. With no flags it runs on the bundled
artifacts: the converted LeNet-5 checkpoint
(``models/assets/lenet5_mnist.npz``) and the 1024 real handwritten digits
of ``data/fixtures/digits`` (MNIST idx layout; the MNIST-trained net reads
them at ~75%). ``--data_dir`` may point at a directory holding MNIST/raw;
``--synthetic`` forces random data.

    python -m curvature_tpu_torch.examples.blitz [--platform cpu]
"""
import argparse
import os

import torch

from curvature_tpu_torch import estimators
from curvature_tpu_torch.data.loaders import FIXTURE_DIR
from curvature_tpu_torch.eval import eval_bnn, eval_nn, metrics
from curvature_tpu_torch.pipelines.common import (
    build_data, build_model, on_device)
from curvature_tpu_torch.utils.config import Config


def main(argv=None):
    """Returns {"NN": (acc %, ECE %, NLL), "BNN": (...)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_dir", default="")
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--mc_samples", type=int, default=10)
    ap.add_argument("--norm", type=float, default=1.0,
                    help="damping 'add' (reference test.py uses 0.5)")
    ap.add_argument("--scale", type=float, default=5e4,
                    help="damping 'multiply': the default gives the "
                    "reference tutorial's regime (BNN accuracy equal to "
                    "the NN's, slightly better ECE) on the bundled digits")
    ap.add_argument("--platform", default="",
                    help="'cpu' runs on the CPU; the default is the CUDA "
                    "device")
    ap.add_argument("--synthetic", action="store_true",
                    help="random data instead of the bundled digits")
    args = ap.parse_args(argv)

    data_dir = args.data_dir
    if not data_dir and not args.synthetic:
        data_dir = FIXTURE_DIR          # checked-in real handwritten digits
    have_mnist = bool(data_dir) and os.path.exists(
        os.path.join(data_dir, "MNIST/raw")) and not args.synthetic
    cfg = Config(model="lenet5", data="mnist" if have_mnist else "synthetic",
                 data_dir=data_dir or ".", batch_size=100,
                 samples=args.samples, mc_samples=args.mc_samples,
                 platform=args.platform)

    print(f"Building LeNet-5 ({cfg.data})")
    model = build_model(cfg)
    device = next(model.parameters()).device
    train_data = list(on_device(build_data(cfg, splits="train"), device))
    test_data = list(on_device(build_data(cfg, splits="test"), device))

    # Estimate the Fisher: per batch one forward, MC label draws from the
    # model distribution, their backwards, the factor update.
    print("Estimating KFAC factors")
    kfac = estimators.KFAC(model)
    gen = torch.Generator(device=device).manual_seed(0)
    for x, _ in train_data:
        kfac.update(x, generator=gen, num_samples=cfg.mc_samples)

    # Invert the damped factors: 'add' and 'multiply' are the two Laplace
    # regularization hyperparameters (tune with pipelines.hyper).
    print("Inverting")
    kfac.invert(add=args.norm, multiply=args.scale)

    # Deterministic vs Bayesian predictions.
    probs, labels = eval_nn(model, test_data)
    bnn_probs, _, _ = eval_bnn(
        model, kfac, test_data, samples=cfg.samples,
        generator=torch.Generator(device=device).manual_seed(1))
    out = {}
    for name, p in (("NN", probs), ("BNN", bnn_probs)):
        acc = float(metrics.accuracy(p, labels))
        ece = 100 * float(metrics.expected_calibration_error(p, labels)[0])
        nll = float(metrics.negative_log_likelihood(p, labels))
        out[name] = (acc, ece, nll)
        print(f"{name:<3}: accuracy {acc:.2f}% | ECE {ece:.2f}% | NLL "
              f"{nll:.3f}")
    return out


if __name__ == "__main__":
    main()
