"""The port stands alone: it imports neither JAX nor anything of the JAX
package, and its entry points run on CUDA unless told otherwise."""
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
             if m == "jax" or m.startswith("jax.")
             or m == "curvature_tpu" or m.startswith("curvature_tpu."))
print(len(names), bad)
assert len(names) >= 20, names
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_entry_point_raises_without_a_gpu():
    from curvature_tpu_torch import models, resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.resnet18()
    assert resolve_device("cpu").type == "cpu"
