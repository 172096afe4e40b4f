"""The port stands alone: it imports neither JAX nor anything of the JAX
package, nor scikit-learn, optax, matplotlib, tabulate, PIL or pandas
(the card's machine has none of them), and its entry points run on CUDA
unless told otherwise."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
import curvature_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    curvature_tpu_torch.__path__, "curvature_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "curvature_tpu", "sklearn",
                                    "optax", "matplotlib", "tabulate",
                                    "PIL", "pandas"))
print(len(names), bad)
assert len(names) >= 20, names
for required in ("curvature_tpu_torch.utils.casting",
                 "curvature_tpu_torch.data.images",
                 "curvature_tpu_torch.ops.cuda.patch_gram",
                 "curvature_tpu_torch.ops.cuda.sym_gram",
                 "curvature_tpu_torch.pipelines.factors",
                 "curvature_tpu_torch.pipelines.evaluate",
                 "curvature_tpu_torch.nn.scan",
                 "curvature_tpu_torch.models.gpt",
                 "curvature_tpu_torch.models.blocks",
                 "curvature_tpu_torch.models.convnext",
                 "curvature_tpu_torch.models.efficientnet",
                 "curvature_tpu_torch.models.mnasnet",
                 "curvature_tpu_torch.models.mobilenet",
                 "curvature_tpu_torch.models.regnet",
                 "curvature_tpu_torch.models.shufflenet",
                 "curvature_tpu_torch.pipelines.hyper",
                 "curvature_tpu_torch.pipelines.surrogates",
                 "curvature_tpu_torch.eval.marglik",
                 "curvature_tpu_torch.eval.predictive",
                 "curvature_tpu_torch.eval.calibrate",
                 "curvature_tpu_torch.eval.predictor",
                 "curvature_tpu_torch.laplace",
                 "curvature_tpu_torch.pipelines.training",
                 "curvature_tpu_torch.pipelines.loss_landscape",
                 "curvature_tpu_torch.pipelines.visualize",
                 "curvature_tpu_torch.optim",
                 "curvature_tpu_torch.estimators.swag",
                 "curvature_tpu_torch.models.densenet",
                 "curvature_tpu_torch.models.vgg",
                 "curvature_tpu_torch.models.alexnet",
                 "curvature_tpu_torch.models.squeezenet",
                 "curvature_tpu_torch.models.googlenet",
                 "curvature_tpu_torch.models.inception",
                 "curvature_tpu_torch.models.mlp",
                 "curvature_tpu_torch.models.torch_convert",
                 "curvature_tpu_torch.data.native",
                 "curvature_tpu_torch.data.prefetch",
                 "curvature_tpu_torch.models.transformer",
                 "curvature_tpu_torch.models.transformer2",
                 "curvature_tpu_torch.models.vit",
                 "curvature_tpu_torch.models.swin",
                 "curvature_tpu_torch.models.maxvit",
                 "curvature_tpu_torch.ops.matfree",
                 "curvature_tpu_torch.eval.fidelity",
                 "curvature_tpu_torch.eval.influence",
                 "curvature_tpu_torch.estimators.subspace",
                 "curvature_tpu_torch.examples.blitz",
                 "curvature_tpu_torch.examples.ewc",
                 "curvature_tpu_torch.examples.influence",
                 "curvature_tpu_torch.examples.modern_laplace",
                 "curvature_tpu_torch.examples.moe_laplace",
                 "curvature_tpu_torch.nn.layers",
                 "curvature_tpu_torch.nn.core",
                 "curvature_tpu_torch.examples.resnet50_scale",
                 "curvature_tpu_torch.parallel",
                 "curvature_tpu_torch.parallel.mesh",
                 "curvature_tpu_torch.parallel.distributed",
                 "curvature_tpu_torch.nn.adapter",
                 "curvature_tpu_torch.nn.placement",
                 "curvature_tpu_torch.nn.scan",
                 "curvature_tpu_torch.estimators.capture",
                 "curvature_tpu_torch.estimators.inf",
                 "curvature_tpu_torch.models.gpt",
                 "curvature_tpu_torch.utils.checkpoint"):
    assert required in names, required
assert not bad, bad
"""


def _is_jax_side(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "curvature_tpu"))


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax_and_no_jax_package():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
    assert "curvature_tpu_torch.ops.cuda" in imported
    assert not [m for m in imported if _is_jax_side(m)], imported


def test_dist_worker_imports_no_jax_and_no_jax_package():
    """The ranks of the parallel tests (tests/torch_dist_worker.py) run
    the port alone: no JAX and nothing of the JAX package, in the module
    or after it ran a job's imports."""
    path = REPO / "tests" / "torch_dist_worker.py"
    imported = list(_imports(path))
    assert "curvature_tpu_torch" in imported
    assert not [m for m in imported if _is_jax_side(m)], imported
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import torch_dist_worker as W; W.mlp(); "
            "import curvature_tpu_torch.pipelines.hyper, "
            "curvature_tpu_torch.pipelines.loss_landscape; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'curvature_tpu')]; assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            yield from (a.name for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.module:
            yield n.module


def test_no_import_of_packages_the_card_lacks():
    """No module of the port, and not chip_smoke.py, imports scikit-learn,
    optax, matplotlib, tabulate, PIL or pandas anywhere, function-local
    imports included (the damping search's surrogates are
    ``pipelines/surrogates.py``, the tables' formatter ``utils/table.py``,
    the UCI CSV reader ``data/loaders.read_csv``)."""
    files = sorted((REPO / "curvature_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imports(f)
           if m.split(".")[0] in ("sklearn", "optax", "matplotlib",
                                  "tabulate", "PIL", "pandas")}
    assert len(files) > 40 and not bad, bad


def test_default_device_entry_point_raises_without_a_gpu():
    from curvature_tpu_torch import models, resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.resnet18()
    for name in ("resnext50_32x4d", "efficientnet_b0", "convnext_tiny"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            models.build(name)
    assert resolve_device("cpu").type == "cpu"


def test_bundled_assets_are_byte_copies():
    """The port's own copies of the JAX package's assets (it imports
    nothing of that package) stay identical to them, and the PNG
    writer's DejaVu Sans and its licence to matplotlib's files, where
    matplotlib is installed (only that pair is left out where it is
    not)."""
    import filecmp
    import importlib.util
    raw = "data/fixtures/digits/MNIST/raw"
    files = ["models/assets/lenet5_mnist.npz"] + [
        f"{raw}/{f}" for f in ("train-images-idx3-ubyte.gz",
                               "train-labels-idx1-ubyte.gz",
                               "t10k-images-idx3-ubyte.gz",
                               "t10k-labels-idx1-ubyte.gz")]
    pairs = [(REPO / "curvature_tpu_torch" / f, REPO / "curvature_tpu" / f)
             for f in files]
    spec = importlib.util.find_spec("matplotlib")
    if spec is not None:
        ttf = Path(spec.origin).parent / "mpl-data" / "fonts" / "ttf"
        pairs += [(REPO / "curvature_tpu_torch" / "utils" / "fonts" / f,
                   ttf / f) for f in ("DejaVuSans.ttf", "LICENSE_DEJAVU")]
    for ours, theirs in pairs:
        assert filecmp.cmp(ours, theirs, shallow=False), ours
