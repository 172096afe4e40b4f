"""Torch checkpoints (``.pth``) in the port against the JAX package:
``models.torch_convert`` on synthetic torchvision-named state dicts.

The state dicts come from torch replicas of the reference's models,
independent of both packages: DenseNet-121 (tests/torch_zoo.py, the
torchvision names) and LeNet-5 as the reference's own ``nn.Sequential``
(positional names, carried by ``TORCH_KEY_MAP``), their weights, biases
and BatchNorm statistics drawn from a numpy seed. The port's conversion
equals JAX's ``convert_torch_state_dict`` followed by
``models.state_dict_from_jax``, bit for bit; its export gives the file's
state dict back byte for byte (a zero ``num_batches_tracked``), as JAX's
export does; ``pipelines.common.build_model`` loads a ``.pth`` in both
packages to the same logits and raises JAX's shape-mismatch error.
"""
import importlib

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from curvature_tpu.models import torch_convert as jconvert
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.utils import config as tconfig
from tests.torch_zoo import TorchDenseNet

# the module (``curvature_tpu.models`` exports a function ``lenet5``)
jlenet5_module = importlib.import_module("curvature_tpu.models.lenet5")

torch.set_num_threads(2)


def _lenet_sequential():
    """The reference's LeNet-5 (curvature/lenet5.py): an ``nn.Sequential``
    whose state dict names its layers 0, 3, 7, 9 and 11."""
    return nn.Sequential(
        nn.Conv2d(1, 6, 5, padding=2), nn.ReLU(), nn.MaxPool2d(2, 2),
        nn.Conv2d(6, 16, 5), nn.ReLU(), nn.MaxPool2d(2, 2), nn.Flatten(),
        nn.Linear(400, 120), nn.ReLU(), nn.Linear(120, 84), nn.ReLU(),
        nn.Linear(84, 10))


def _seeded_state(module, seed):
    """``module``'s state dict with every float entry drawn from a numpy
    seed (running variances in [0.8, 1.2]); ``num_batches_tracked`` a
    nonzero count, as a trained checkpoint has."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, v in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(1234, dtype=torch.int64)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(
                rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
        else:
            scale = 0.05 if key.endswith(("bias", "running_mean")) else \
                np.sqrt(2.0 / max(v[0].numel(), 1)) if v.ndim > 1 else 0.2
            base = 1.0 if key.endswith("weight") and v.ndim == 1 else 0.0
            sd[key] = torch.from_numpy((base + scale * rng.standard_normal(
                v.shape)).astype(np.float32))
    return sd


#: name -> (torch module, key map, model, dataset)
CASES = {
    "densenet121": (lambda: TorchDenseNet("densenet121", 10), None,
                    "densenet121", "cifar10"),
    "lenet5": (_lenet_sequential, tmodels.TORCH_KEY_MAP, "lenet5", "mnist"),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, key_map, model, data = CASES[request.param]
    return {"sd": _seeded_state(make(), 0), "key_map": key_map,
            "model": model, "data": data}


def test_conversion_equals_jax_then_state_dict_from_jax(case):
    """Every entry of the port's conversion equals JAX's conversion
    carried into the port's layout by ``models.state_dict_from_jax``, bit
    for bit, with no ``num_batches_tracked`` left; the key map is JAX's."""
    assert tmodels.TORCH_KEY_MAP == jlenet5_module.TORCH_KEY_MAP
    got = tmodels.convert_torch_state_dict(case["sd"], case["key_map"])
    want = tmodels.state_dict_from_jax(
        jconvert.convert_torch_state_dict(case["sd"], case["key_map"]))
    assert sorted(got) == sorted(want)
    assert not [k for k in got if "num_batches_tracked" in k]
    for key, val in want.items():
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], val), key
    model = tmodels.build(case["model"], 10, device="cpu")
    model.load_state_dict(got, strict=True)


def test_export_round_trips_byte_for_byte(case):
    """``export_torch_state_dict(convert_torch_state_dict(sd))`` is the
    file's state dict: the same keys in the same order, the same bytes,
    each BatchNorm's ``num_batches_tracked`` a zero int64 (JAX's export
    writes the same zero); every value equals JAX's export of JAX's
    conversion."""
    inverse = None if case["key_map"] is None else {
        v: k for k, v in case["key_map"].items()}
    back = tmodels.export_torch_state_dict(
        tmodels.convert_torch_state_dict(case["sd"], case["key_map"]),
        inverse)
    assert list(back) == list(case["sd"])
    jback = jconvert.export_torch_state_dict(
        jconvert.convert_torch_state_dict(case["sd"], case["key_map"]),
        inverse)
    assert sorted(jback) == sorted(back)
    for key, val in case["sd"].items():
        if key.endswith("num_batches_tracked"):
            assert back[key].dtype == torch.int64 and int(back[key]) == 0
            assert int(jback[key]) == 0
            continue
        assert back[key].dtype == val.dtype
        assert back[key].numpy().tobytes() == val.numpy().tobytes(), key
        np.testing.assert_array_equal(jback[key], val.numpy())


def _argv(case, root):
    return ["--platform", "cpu", "--model", case["model"], "--data",
            case["data"], "--root_dir", str(root)]


def test_build_model_loads_a_pth_as_jax_does(case, tmp_path):
    """``<root>/weights/<model>_<data>.pth`` is what both packages'
    ``build_model`` load (no npz beside it): the port's weights equal
    JAX's variables carried across, and the eval logits agree within
    1e-5 of max."""
    (tmp_path / "weights").mkdir()
    torch.save(case["sd"], tmp_path / "weights" /
               f"{case['model']}_{case['data']}.pth")
    argv = _argv(case, tmp_path)
    tm = tcommon.build_model(tconfig.parse_args(argv))
    jm, jv = jcommon.build_model(jconfig.parse_args(argv))
    want = tmodels.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jv))
    for key, val in tm.state_dict().items():
        assert torch.equal(val, want[key]), key
    h, w, c = tcommon.input_shape(case["data"])
    x = np.random.default_rng(1).standard_normal((2, h, w, c)) \
        .astype(np.float32)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2)))).numpy()
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x)[0])(
        jv, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


def test_build_model_raises_jax_shape_mismatch(case, tmp_path):
    """A ``.pth`` whose last layer has another width raises the same
    ``ValueError`` in both packages, naming the layer."""
    sd = dict(case["sd"])
    last = "classifier" if case["model"] == "densenet121" else "11"
    sd[f"{last}.weight"] = torch.zeros((7,) + sd[f"{last}.weight"].shape[1:])
    sd[f"{last}.bias"] = torch.zeros(7)
    (tmp_path / "weights").mkdir()
    torch.save(sd, tmp_path / "weights" /
               f"{case['model']}_{case['data']}.pth")
    argv = _argv(case, tmp_path)
    layer = "classifier" if case["model"] == "densenet121" else "fc3"
    with pytest.raises(ValueError) as port_err:
        tcommon.build_model(tconfig.parse_args(argv))
    with pytest.raises(ValueError) as jax_err:
        jcommon.build_model(jconfig.parse_args(argv))
    assert str(port_err.value) == str(jax_err.value)
    assert f"checkpoint shape mismatch for {layer}." in str(port_err.value)


def test_unowned_entries_are_dropped_and_missing_ones_raise(tmp_path):
    """Entries no module owns (torchvision's auxiliary heads) are
    dropped, as JAX's ``apply`` never reads them; a missing one raises."""
    model = tmodels.build("lenet5", 10, device="cpu")
    sd = _seeded_state(_lenet_sequential(), 1)
    path = tmp_path / "aux.pth"
    torch.save(dict(sd, **{"aux1.fc.weight": torch.ones(2, 2)}), path)
    variables = tmodels.load_torch_checkpoint(str(path), model,
                                              tmodels.TORCH_KEY_MAP)
    assert sorted(variables["params"]) == ["conv1", "conv2", "fc1", "fc2",
                                           "fc3"]
    del sd["11.bias"]
    torch.save(sd, path)
    variables = tmodels.load_torch_checkpoint(str(path), model,
                                              tmodels.TORCH_KEY_MAP)
    with pytest.raises(RuntimeError, match="fc3.bias"):
        tmodels.load_jax_variables(model, variables)
