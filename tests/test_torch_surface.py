"""The port's public surface against the JAX package's.

Every name in an ``__all__`` of ``curvature_tpu/**/__init__.py`` (read by
``ast``, not imported) exists in the port's subpackage of the same path,
or is a row of the README's counterpart table, whose rows name nothing the
port exports. Then the functions this surface added, each held to JAX's on
the same numpy-seeded inputs: ``softmax_cross_entropy``, ``make_fgsm_fn``,
``patch_gram_tiled_supported``; and the port's own: the named model
constructors against the registry's architecture, ``collect(remat=True)``
against ``remat=False``, ``Timer``, ``profile_trace``.
"""
import ast
import glob
import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu.eval import attacks as jattacks
from curvature_tpu.estimators import capture as jcapture
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.estimators import KFAC
from curvature_tpu_torch.estimators.capture import (
    collect, softmax_cross_entropy)
from curvature_tpu_torch.eval.attacks import make_fgsm_fn
from curvature_tpu_torch.ops.cuda import patch_gram as tpg
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.utils import Timer, profile_trace
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
jpg = importlib.import_module("curvature_tpu.ops.pallas.patch_gram")

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "curvature_tpu"
ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", tloaders.FIXTURE_DIR, "--batch_size", "32"]


def _exported():
    """(subpackage path, JAX ``__all__``) of every JAX ``__init__``."""
    out = []
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        sub = ".".join(init.parent.relative_to(JAX_ROOT).parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets):
                out.append((sub, [ast.literal_eval(e)
                                  for e in node.value.elts]))
    return out


EXPORTED = _exported()


def _table():
    """{JAX dotted name: (port counterpart, reason)} from the README's
    counterpart table (the rows of the port section's public-surface
    table whose first cell is a backticked name)."""
    text = (REPO / "README.md").read_text()
    section = text.split("### The public surface", 1)[1].split("\n## ", 1)[0]
    rows = {}
    for line in section.splitlines():
        m = re.match(r"\|\s*`([\w.]+)`\s*\|(.*?)\|(.*?)\|\s*$", line)
        if m:
            rows[m.group(1)] = (m.group(2).strip(), m.group(3).strip())
    return rows


def _port(sub):
    try:
        return importlib.import_module(
            "curvature_tpu_torch" + (f".{sub}" if sub else ""))
    except ImportError:
        return None


@pytest.mark.parametrize("sub,names", EXPORTED,
                         ids=[s or "top" for s, _ in EXPORTED])
def test_every_jax_export_has_a_counterpart(sub, names):
    """Each name is the port subpackage's attribute, or a table row."""
    table = _table()
    mod = _port(sub)
    for name in names:
        dotted = f"{sub}.{name}" if sub else name
        if mod is not None and hasattr(mod, name):
            continue
        assert dotted in table, f"{dotted}: neither in the port nor in " \
            "the README's counterpart table"
        assert table[dotted][1], f"{dotted}: the row gives no reason"


def test_table_rows_name_nothing_the_port_exports():
    """A row stands only for a name the port lacks, and its counterpart,
    where it names one of the port's objects, exists."""
    table = _table()
    assert len(table) >= 14
    for dotted, (counterpart, _) in table.items():
        sub, _, name = dotted.rpartition(".")
        mod = _port(sub)
        assert mod is None or not hasattr(mod, name), \
            f"{dotted} is a row but the port exports it"
        m = re.fullmatch(r"`(curvature_tpu_torch[\w.]*)`", counterpart)
        if m:
            path, _, attr = m.group(1).rpartition(".")
            assert hasattr(importlib.import_module(path), attr), counterpart


def test_top_level_names():
    import curvature_tpu_torch as ct
    assert ct.KFAC is ct.estimators.KFAC
    assert ct.eval.make_ensemble_fn is not None
    assert ct.utils.Timer is Timer


NAMED = ("resnet34", "densenet121", "mnasnet1_0", "shufflenet_v2_x1_0",
         "squeezenet1_0", "squeezenet1_1", "convnext_tiny")


@pytest.mark.parametrize("name", NAMED)
def test_named_constructor_builds_the_registry_architecture(name):
    """The named constructor is the registry's entry, and builds the
    same parameters (count and state-dict keys) as ``models.build``."""
    ctor = getattr(tmodels, name)
    assert tmodels.MODEL_REGISTRY[name] is ctor
    a = ctor(num_classes=10, device="cpu")
    b = tmodels.build(name, num_classes=10, device="cpu")
    assert list(a.state_dict()) == list(b.state_dict())
    assert sum(p.numel() for p in a.parameters()) == \
        sum(p.numel() for p in b.parameters())


def test_resnet18_keeps_jax_defaults():
    """``resnet18()`` has JAX's CIFAR stem and 10 classes; the registry's
    ``resnet18`` JAX's ImageNet stem."""
    assert tmodels.resnet18(device="cpu").fc.weight.shape[0] == 10
    a = tmodels.resnet18(num_classes=10, stem="imagenet", device="cpu")
    b = tmodels.build("resnet18", num_classes=10, device="cpu")
    assert list(a.state_dict()) == list(b.state_dict())
    assert a.conv1.weight.shape == b.conv1.weight.shape == (64, 3, 7, 7)


@pytest.mark.parametrize("shape", [(8, 10), (4, 6, 50)])
def test_softmax_cross_entropy_matches_jax(shape):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(jcapture.softmax_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(labels)))
    got = float(softmax_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.fixture(scope="module")
def lenet():
    t, j = tconfig.parse_args(ARGV), jconfig.parse_args(ARGV)
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    x, y = next(iter(tcommon.build_data(t, splits="test")))
    return tm, jm, jv, np.asarray(x), np.asarray(y)


@pytest.mark.parametrize("eps", [0.05, 0.2])
def test_make_fgsm_fn_matches_jax(lenet, eps):
    """The bundled LeNet-5 weights in both packages: the perturbation's
    sign is JAX's on every pixel where JAX's input gradient is not zero,
    and the perturbed batch within 1e-6."""
    tm, jm, jv, x, y = lenet
    want = np.asarray(jattacks.make_fgsm_fn(jm)(
        jv, jnp.asarray(x), jnp.asarray(y), eps))
    nchw = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = make_fgsm_fn(tm)(None, nchw, torch.from_numpy(y), eps)
    got = got.numpy().transpose(0, 2, 3, 1)
    grad = np.asarray(jax.grad(lambda xx: jcapture.softmax_cross_entropy(
        jm.apply(jv, xx, train=False)[0], jnp.asarray(y)))(jnp.asarray(x)))
    moved = grad != 0
    assert moved.mean() > 0.5
    np.testing.assert_array_equal(np.sign(got - x)[moved],
                                  np.sign(want - x)[moved])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_patch_gram_tiled_supported_matches_jax():
    checked = 0
    for c in (3, 16, 32, 64, 128, 256, 512):
        for k in ((1, 1), (3, 3), (5, 5), (7, 7)):
            for s in ((1, 1), (2, 2), (3, 3)):
                for hw in (7, 14, 32, 56):
                    for batch, item in ((2, 4), (16, 4), (32, 2)):
                        args = (c, k, s, hw, hw, batch, item)
                        assert tpg.patch_gram_tiled_supported(*args) == \
                            jpg.patch_gram_tiled_supported(*args), args
                        checked += 1
    assert checked == 7 * 4 * 3 * 4 * 3


@pytest.mark.parametrize("need", ["probes", "params", "grams",
                                  "stacked_probes"])
def test_collect_remat_equals_plain(need):
    """Recomputing the forward in the backward gives the same captures
    (inputs, probe gradients, parameter gradients, tapped Grams) within
    1e-6 of max, and the same logits: on ResNet-18, and on a depth-stacked
    GPT-2 (``stacked_probes``), whose recompute makes its per-depth probe
    leaves anew while the backward reaches the forward's."""
    torch.manual_seed(0)
    if need == "stacked_probes":
        m = tmodels.gpt2_custom(61, 32, 3, 2, 16, scan_blocks=True,
                                device="cpu")
        metas = KFAC(m, loss="lm").metas
        x = torch.randint(0, 61, (3, 8))
        kw = dict(need_param_grads=False, loss="lm")
    else:
        m = tmodels.resnet18(num_classes=10, device="cpu")
        metas = KFAC(m).metas
        x = torch.randn(4, 3, 32, 32)
        kw = {"probes": dict(need_param_grads=False),
              "params": dict(need_probe_grads=False),
              "grams": dict(need_param_grads=False,
                            gram_probe_names=frozenset(list(metas)[:4]))
              }[need]
    caps = [collect(m, metas, x, generator=torch.Generator().manual_seed(1),
                    num_samples=2, remat=r, **kw) for r in (False, True)]
    if need == "stacked_probes":
        assert any(meta.stacked == 3 for meta in metas.values())
    for field in ("acts", "probe_grads", "param_grads", "probe_grams"):
        a, b = getattr(caps[0], field), getattr(caps[1], field)
        assert (a is None) == (b is None), field
        if a is None:
            continue
        assert a.keys() == b.keys(), field
        for k in a:
            tol = 1e-6 * float(a[k].abs().max())
            assert float((a[k] - b[k]).abs().max()) <= tol, (field, k)
    assert torch.equal(caps[0].logits, caps[1].logits)
    assert caps[0].probe_gram_ntok == caps[1].probe_gram_ntok


def test_timer_accumulates_phases():
    t = Timer()
    for _ in range(3):
        with t.phase("a", block_on={"x": [torch.ones(2)], "y": None}):
            sum(range(1000))
    with t.phase("b"):
        pass
    assert set(t.times) == {"a", "b"}
    assert t.times["a"] > t.times["b"] >= 0.0


def test_profile_trace_writes_a_trace(tmp_path):
    """On the CPU the trace holds the block's ``aten::`` operators."""
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(16, 16) @ torch.ones(16, 16)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(Path(files[0]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::mm") for n in names), sorted(names)[:20]
