"""``--plot`` in the port's CLIs and ``visualize``'s figure toggles
against JAX's CLIs on the same flags.

LeNet-5 on the bundled digits: one ``factors`` run (kfac, the port's; its
file has JAX's layout) serves both packages; then each package runs
``evaluate`` (plain, ``--fgsm`` over 3 of the sweep's steps, ``--ood``
with the digits as ``x * 2 + 1`` standing in for KMNIST, as the other CLI
tests build it), ``hyper --optimizer random --calls 3`` and
``loss_landscape --loss1d``/``--loss2d`` at a few points, each with
``--plot``, into its own root.
Each CLI, and ``visualize`` with each of its 9 figure toggles over those
roots, must write the same file names in the port as in JAX, and every
file the port writes must parse (``tests/torch_pdf_check.py``) and show
its figure's labels.
"""
import functools
import os
import shutil

import pytest
import torch

import matplotlib
matplotlib.use("Agg")

from curvature_tpu.pipelines import common as jcommon  # noqa: E402
from curvature_tpu.pipelines import evaluate as jevaluate  # noqa: E402
from curvature_tpu.pipelines import hyper as jhyper  # noqa: E402
from curvature_tpu.pipelines import loss_landscape as jll  # noqa: E402
from curvature_tpu.pipelines import visualize as jvis  # noqa: E402
from curvature_tpu_torch.data.loaders import FIXTURE_DIR  # noqa: E402
from curvature_tpu_torch.pipelines import common as tcommon  # noqa: E402
from curvature_tpu_torch.pipelines import evaluate as tevaluate  # noqa: E402
from curvature_tpu_torch.pipelines import factors as tfactors  # noqa: E402
from curvature_tpu_torch.pipelines import hyper as thyper  # noqa: E402
from curvature_tpu_torch.pipelines import loss_landscape as tll  # noqa: E402
from curvature_tpu_torch.pipelines import visualize as tvis  # noqa: E402
from curvature_tpu_torch.utils import pdf as tpdf  # noqa: E402
from tests.torch_pdf_check import parse_pdf  # noqa: E402

torch.set_num_threads(1)

BASE = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", FIXTURE_DIR, "--batch_size", "128", "--mc_samples",
        "1", "--estimator", "kfac"]
DAMPING = ["--norm", "1", "--scale", "5e4", "--samples", "2"]
#: the CLIs, by case id: (JAX module, port module, flags)
CLIS = {
    "evaluate": (jevaluate, tevaluate, DAMPING + ["--plot"]),
    "evaluate_fgsm": (jevaluate, tevaluate, DAMPING + ["--fgsm", "--plot"]),
    "evaluate_ood": (jevaluate, tevaluate, DAMPING + ["--ood", "--plot"]),
    "hyper": (jhyper, thyper, ["--optimizer", "random", "--calls", "3",
                               "--samples", "2", "--plot"]),
    "loss1d": (jll, tll, ["--loss1d", "--plot"]),
    "loss2d": (jll, tll, ["--loss2d", "--plot"]),
}
TOGGLES = ("calibration", "networks", "ood", "ecdf", "entropy", "eigvals",
           "hyper", "fgsm", "landscapes")


def _figures(root):
    out = set()
    for d, _, files in os.walk(os.path.join(root, "lenet5", "figures")):
        out |= {os.path.relpath(os.path.join(d, f), root) for f in files}
    return out


def _clear_figures(root):
    shutil.rmtree(os.path.join(root, "lenet5", "figures"),
                  ignore_errors=True)


def _digits_ood(common):
    def build(cfg, batch_size=None):
        test = list(common.build_data(cfg, splits="test"))
        return test, [(x * 2.0 + 1.0, y) for x, y in test]
    return build


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Each package's root after its CLIs, and per CLI the figure files
    it wrote: {"jax"|"port": {"root", "written": {case: {path: parsed}}}},
    a port file parsed as it was written (the next CLI clears them)."""
    base = tmp_path_factory.mktemp("figures")
    out = {}
    jroot, troot = str(base / "jax"), str(base / "port")
    tfactors.main(BASE + ["--root_dir", troot, "--results_dir", troot])
    shutil.copytree(os.path.join(troot, "factors"),
                    os.path.join(jroot, "factors"))
    with pytest.MonkeyPatch.context() as mp:
        for ev in (jevaluate, tevaluate):
            mp.setattr(ev, "FGSM_STEPS", ev.FGSM_STEPS[[0, 5, 12]])
        mp.setattr(jevaluate, "build_ood_data", _digits_ood(jcommon))
        mp.setattr(tevaluate, "build_ood_data", _digits_ood(tcommon))
        # a few points of each scan
        for ll in (jll, tll):
            mp.setattr(ll, "loss1d", functools.partial(ll.loss1d, steps=3,
                                                       chunk=4))
            mp.setattr(ll, "loss2d", functools.partial(ll.loss2d, xsteps=4,
                                                       ysteps=3, chunk=4))
        for name, root, idx in (("jax", jroot, 0), ("port", troot, 1)):
            written = {}
            for case, spec in CLIS.items():
                _clear_figures(root)
                spec[idx].main(BASE + ["--root_dir", root, "--results_dir",
                                       root] + spec[2])
                written[case] = {f: _parsed(root, f) if name == "port"
                                 else None for f in _figures(root)}
            out[name] = {"root": root, "written": written}
    return out


def _parsed(root, f):
    """(shown strings by the tests' own parse, ``read_pdf``'s reading)."""
    path = os.path.join(root, f)
    return parse_pdf(path), tpdf.read_pdf(path)


def _check_port_files(files):
    for f, (shown, info) in files.items():
        assert info["pages"] == 1 and info["strings"] == shown, f
        assert info["painted"] >= 1, f
        yield f, shown


@pytest.mark.parametrize("case", sorted(CLIS))
def test_cli_plot_writes_jaxs_figure_files(roots, case):
    want = roots["jax"]["written"][case]
    got = roots["port"]["written"][case]
    assert want and sorted(got) == sorted(want)
    labels = {"evaluate": "Confidence", "evaluate_fgsm": "FGSM step size",
              "evaluate_ood": "Predictive entropy", "hyper": "log10 norm",
              "loss1d": "alpha", "loss2d": "beta"}[case]
    for f, shown in _check_port_files(got):
        if case != "evaluate_ood" or f.endswith(("_ecdf.pdf",
                                                 "_entropy.pdf")):
            assert labels in shown, (f, shown)


@pytest.mark.parametrize("toggle", TOGGLES)
def test_visualize_toggle_draws_jaxs_figure_files(roots, toggle):
    """One figure toggle of ``visualize`` (``--hyper`` reads the random
    search's stats): the same new files as JAX's ``visualize``, each
    parsing."""
    written = {}
    for name, module in (("jax", jvis), ("port", tvis)):
        root = roots[name]["root"]
        _clear_figures(root)
        module.main(BASE + ["--root_dir", root, "--results_dir", root,
                            "--optimizer", "random", f"--{toggle}"])
        written[name] = _figures(root)
    assert written["jax"] and written["port"] == written["jax"], written
    root = roots["port"]["root"]
    for f, shown in _check_port_files({f: _parsed(root, f)
                                       for f in written["port"]}):
        assert shown, f
