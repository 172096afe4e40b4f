"""No module the runner or a cell loads imports JAX, jaxlib, flax or the
JAX package (``curvature_tpu``), compared by whole top-level name (the
port's name begins with the JAX package's); the reference imports nothing
of the port either.

Statically: every import statement, at any depth, of every harness
module and of every module of the port that a run loads. Dynamically: a
fresh process runs each toy cell on the CPU and lists ``sys.modules``."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

HERE = Path(__file__).resolve().parents[1]
REFERENCE_ALLOWED = {"torch", "math", "fnmatch", "dataclasses", "typing",
                     "gpubench"}


def imported_tops(path: Path):
    """(top-level name, line) of every import in a source file; relative
    imports resolve to their package's top."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "gpubench", node.lineno
            else:
                yield node.module.split(".")[0], node.lineno


def harness_files():
    return [p for p in HERE.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", harness_files(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_harness_imports_nothing_barred(path):
    for top, line in imported_tops(path):
        assert top not in harness.BARRED, f"{path}:{line} imports {top}"
        assert top not in ("benchmarks", "bench", "chip_smoke"), \
            f"{path}:{line} imports {top}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    for top, line in imported_tops(path):
        assert top in REFERENCE_ALLOWED, f"{path}:{line} imports {top}"


PROBE = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
import runpy
runpy.run_path({run_py!r}, run_name="gpubench_run")
from gpubench import harness
from gpubench.tests import toy
root = toy.make(Path({tmp!r}))
for cell in sorted(toy.CELLS):
    for trace in (False, True):
        harness.run_cell(root, cell, 7, 0.2, trace, time.perf_counter(),
                         device="cpu")
import gpubench.calibrate
print(json.dumps({{"modules": sorted(sys.modules),
                  "files": sorted({{getattr(m, "__file__", None) or ""
                                   for m in list(sys.modules.values())}})}}))
"""


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("imports")
    code = PROBE.format(repo=str(HERE.parent), run_py=str(HERE / "run.py"),
                        tmp=str(tmp))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_nothing_barred(loaded):
    barred = [m for m in loaded["modules"]
              if m.split(".")[0] in harness.BARRED]
    assert barred == []


def test_loaded_port_modules_import_nothing_barred(loaded):
    """Every module of the port or the harness that a run loaded, with
    the imports it only makes inside a function."""
    port = [Path(f) for f in loaded["files"]
            if f.endswith(".py") and ("curvature_tpu_torch" in Path(f).parts
                                      or "gpubench" in Path(f).parts)]
    assert any("curvature_tpu_torch" in p.parts for p in port)
    for path in port:
        for top, line in imported_tops(path):
            assert top not in harness.BARRED, f"{path}:{line} imports {top}"
