"""The port's examples (``curvature_tpu_torch/examples``) run in-process
on the CPU at small sizes and print the JAX examples' markers
(tests/test_examples.py): ``accuracy`` (blitz), ``EWC retention gain``,
``influence OK``, the modern Laplace rows, the MoE GPT-2's per-expert
factors and routing, ResNet-50's update rate and predictor. Importing an example runs nothing."""
import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

NAMES = ("blitz", "ewc", "influence", "modern_laplace", "moe_laplace",
         "resnet50_scale")


def _main(name):
    return importlib.import_module(
        f"curvature_tpu_torch.examples.{name}").main


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_without_side_effects(name, capsys):
    importlib.reload(importlib.import_module(
        f"curvature_tpu_torch.examples.{name}"))
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


def test_blitz_example(capsys):
    """On the bundled digits with the bundled weights: the NN reads them
    at 75.78% (JAX's number), the BNN of 3 samples well above chance."""
    res = _main("blitz")(["--samples", "3", "--mc_samples", "1",
                          "--platform", "cpu"])
    assert "accuracy" in capsys.readouterr().out.lower()
    assert res["NN"][0] == pytest.approx(75.78125)
    assert res["BNN"][0] > 20.0 and np.isfinite(res["BNN"][2])


def test_modern_laplace_example(capsys):
    res = _main("modern_laplace")(["--platform", "cpu", "--epochs", "2",
                                   "--samples", "4"])
    out = capsys.readouterr().out
    for marker in ("MAP", "KFAC GLM", "last-layer", "SWAG",
                   "log marginal likelihood"):
        assert marker in out, (marker, out[-2000:])
    assert np.isfinite(res["log marginal likelihood"])
    for key in ("MAP", "MAP + temp", "KFAC sampled", "KFAC GLM",
                "last-layer", "SWAG"):
        assert np.isfinite(res[key]).all(), key


def test_ewc_example(capsys):
    res = _main("ewc")(["--platform", "cpu", "--steps", "150"])
    assert "EWC retention gain" in capsys.readouterr().out
    assert res["ewc"] > res["plain"]


def test_influence_example(capsys):
    res = _main("influence")(["--platform", "cpu", "--steps", "250"])
    assert "influence OK" in capsys.readouterr().out
    assert res["precision"] > 2 * res["chance"]
    assert res["frac"] > 2 * res["chance"]


def test_moe_laplace_example(capsys):
    """JAX tests/test_examples.py:47's run (3 samples, 2 batches): the
    per-expert factors, the routed shares (summing to 1 under top-1) and
    both predictives; the expert-sharded step on two ranks, each holding
    half of the experts' A factors, their gathered factor held to one
    process's (JAX's bar, inside the script)."""
    res = _main("moe_laplace")(["--platform", "cpu", "--samples", "3",
                                "--batches", "2"])
    out = capsys.readouterr().out
    for marker in ("per-expert A factors", "expert utilization",
                   "per-token NLL", "expert-sharded factors on expert:2"):
        assert marker in out, (marker, out[-2000:])
    assert res["a_shape"] == (4, 64, 64)
    assert res["ep_block"] == (2, 64, 64)
    assert res["ep_err"] <= 1e-5
    assert res["shares"].sum() == pytest.approx(1.0)
    assert np.isfinite([res["map_nll"], res["bnn_nll"],
                        res["log_marglik"]]).all()


def test_resnet50_scale_example(capsys):
    """ResNet-50 at 64², B=4, 10 classes: the KFAC update loop through the
    prefetcher, the invert and a 2-sample predictor."""
    res = _main("resnet50_scale")(["--platform", "cpu", "--batch", "4",
                                   "--steps", "1", "--size", "64",
                                   "--classes", "10", "--samples", "2"])
    out = capsys.readouterr().out
    assert "factor update:" in out and "mean epistemic" in out
    assert res["img_s"] > 0 and np.isfinite(res["epistemic"])


def test_examples_default_to_the_card():
    """Without --platform an example asks for the CUDA device and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for name in ("ewc", "influence"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _main(name)([])
