"""The loss landscape (``pipelines/loss_landscape.py``), the weights'
conversion to JAX's layout (``models.variables_to_jax``) and the tables
of ``pipelines/visualize.py`` against the JAX package.

The landscape runs on the BatchNorm net of tests/test_torch_training.py
and LeNet-5 with JAX's directions carried into the port's layout (its
draws come from ``jax.random``); scans written half by one package are
finished by the other. The tables are compared byte for byte with JAX's,
which prints them with ``tabulate``. Tolerances are stated per test.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tabulate as tabulate_lib

from curvature_tpu.data import loaders as jloaders
from curvature_tpu.pipelines import loss_landscape as jll
from curvature_tpu.pipelines import visualize as jvis
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.pipelines import loss_landscape as tll
from curvature_tpu_torch.pipelines import visualize as tvis
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig
from curvature_tpu_torch.utils.table import tabulate

from tests.test_torch_training import _data, _lenet_pair, _pair

torch.set_num_threads(1)


def _to_port(tree):
    """A JAX-layout parameter tree (params, directions, noise) as the
    port's state-dict entries."""
    return tmodels.state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, tree)})


def _nchw_batches(loader):
    return [(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
             torch.from_numpy(np.asarray(y)).long()) for x, y in loader]


# -- directions -----------------------------------------------------------

def _gpt_pair():
    """A stacked GPT-2 (ScanBlocks: [depth, out, in] dense weights,
    [depth, dim] LayerNorms) with seeded weights, in JAX's layout too."""
    tm = tmodels.build("gpt2_tiny", 50, device="cpu", max_len=8,
                       scan_blocks=True)
    variables = tmodels.seeded_variables(tm, 0)
    tm.load_state_dict(tmodels.state_dict_from_jax(variables))
    return variables, tm


@pytest.mark.parametrize("which", ["bn_net", "lenet5", "gpt2_stacked"])
def test_filter_normalize_on_the_ports_axes_matches_jax(which):
    """JAX's ``_filter_normalize`` of each >= 2-D leaf (the output axis
    last in HWIO / [in, out]) against the port's on the converted leaf
    along ``filter_axes`` (first for OIHW, second to last for [(depth,)
    out, in], JAX's last for the rest): 1e-6 of max. Reducing over the
    wrong axes fails this on every conv and dense leaf."""
    if which == "gpt2_stacked":
        variables, tm = _gpt_pair()
        params = variables["params"]
    else:
        _, jv, tm = _pair() if which == "bn_net" else _lenet_pair()
        params = jax.tree_util.tree_map(np.asarray, jv["params"])
    rng = np.random.default_rng(0)
    d = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        params)
    want = jax.tree_util.tree_map(
        lambda dd, w: np.asarray(jll._filter_normalize(jnp.asarray(dd),
                                                       jnp.asarray(w)))
        if np.ndim(w) >= 2 else dd, d, params)
    tw, td, ref = _to_port(params), _to_port(d), _to_port(want)
    axes = tll.filter_axes(tm)
    checked = 0
    for key, w in tw.items():
        if w.ndim < 2:
            continue
        got = tll._filter_normalize(td[key], w, axes[key])
        np.testing.assert_allclose(got.numpy(), ref[key].numpy(),
                                   atol=1e-6 * ref[key].abs().max().item(),
                                   err_msg=key)
        checked += 1
    assert checked >= 3


def test_random_direction_is_filter_normalized():
    """The port's own draws: every filter of a >= 2-D leaf has its
    weight filter's norm (1e-5 relative), 1-D leaves are zero, and the
    same generator seed gives the same direction."""
    _, _, tm = _pair()
    params = {k: p.detach() for k, p in tm.named_parameters()}
    axes = tll.filter_axes(tm)
    d = tll.random_direction(params, torch.Generator().manual_seed(3),
                             axes=axes)
    again = tll.random_direction(params, torch.Generator().manual_seed(3),
                                 axes=axes)
    for key, w in params.items():
        assert torch.equal(d[key], again[key])
        if w.ndim <= 1:
            assert not d[key].any(), key
            continue
        dims = [i for i in range(w.ndim) if i != axes[key] % w.ndim]
        np.testing.assert_allclose(
            torch.linalg.vector_norm(d[key], dim=dims).numpy(),
            torch.linalg.vector_norm(w, dim=dims).numpy(),
            rtol=1e-5, err_msg=key)


# -- the evaluator and the scans -------------------------------------------

@pytest.mark.parametrize("which", ["bn_net", "lenet5"])
def test_evaluate_points_matches_jax(which):
    """Seven points along JAX's direction in chunks of 3 (a padded tail):
    mean losses within 1e-5 relative, accuracies equal."""
    if which == "bn_net":
        jm, jv, tm = _pair()
        x, y = _data(40, seed=4)
        batch = 16
    else:
        jm, jv, tm = _lenet_pair()
        x, y, _, _ = tloaders._idx_dataset(tloaders.FIXTURE_DIR,
                                           tloaders.MNIST_DIR)
        x, y, batch = x[:200], y[:200], 64
    d = jll.random_direction(jv["params"], jax.random.PRNGKey(0))
    coords = np.linspace(-1.0, 1.0, 7)[:, None]
    jb = list(jloaders.ArrayLoader(x, y, batch))
    wl, wa = jll.evaluate_points(jm, jv, [d], coords, jb, chunk=3)
    gl, ga = tll.evaluate_points(tm, [_to_port(d)], coords,
                                 _nchw_batches(tloaders.ArrayLoader(
                                     x, y, batch)), chunk=3)
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    np.testing.assert_array_equal(ga, wa)


def test_chunk_falls_back_to_a_loop_and_agrees(monkeypatch):
    """Where vmap cannot batch the model, the chunk runs as a loop with
    the same numbers (1e-6 relative)."""
    _, jv, tm = _pair()
    d = _to_port(jll.random_direction(jv["params"], jax.random.PRNGKey(0)))
    x, y = _data(32, seed=4)
    batches = _nchw_batches(tloaders.ArrayLoader(x, y, 16))
    coords = np.linspace(-1.0, 1.0, 5)[:, None]
    want = tll.evaluate_points(tm, [d], coords, batches, chunk=2)
    evaluator = tll.make_chunked_eval(tm)
    evaluator.state["vmap"] = False
    monkeypatch.setattr(tll, "make_chunked_eval",
                        lambda model, mesh=None: evaluator)
    got = tll.evaluate_points(tm, [d], coords, batches, chunk=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


def _half_erased(path, out, keys, start):
    res = dict(np.load(path, allow_pickle=True).item())
    for k in keys:
        res[k] = np.array(res[k])
        res[k][start:] = np.nan
    np.save(out, res, allow_pickle=True)
    return res


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_loss1d_file_half_written_is_finished_by_the_other(tmp_path,
                                                           writer):
    """A 9-point scan (train and val, chunks of 2) run whole by one
    package, its last 5 points of each split erased, is finished by the
    other with the same direction: the kept points stay bit for bit, the
    finished ones equal the whole run's (losses 1e-5 relative, accuracies
    equal)."""
    jm, jv, tm = _pair()
    x, y = _data(48, seed=6)
    xv, yv = _data(32, seed=7)
    d = jll.random_direction(jv["params"], jax.random.PRNGKey(0))
    whole, part = str(tmp_path / "whole.npy"), str(tmp_path / "part.npy")
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")

    def run(who, path):
        if who == "jax":
            return jll.loss1d(jm, jv, jloaders.ArrayLoader(x, y, 16, True),
                              jloaders.ArrayLoader(xv, yv, 16),
                              jax.random.PRNGKey(0), steps=9, path=path,
                              chunk=2)
        return tll.loss1d(tm, tloaders.ArrayLoader(x, y, 16, True),
                          tloaders.ArrayLoader(xv, yv, 16), steps=9,
                          path=path, chunk=2, directions=[_to_port(d)])
    full = run(writer, whole)
    kept = _half_erased(whole, part, keys, 4)
    done = run("port" if writer == "jax" else "jax", part)
    for k in keys:
        np.testing.assert_array_equal(done[k][:4], kept[k][:4])
        if k.endswith("loss"):
            np.testing.assert_allclose(done[k], full[k], rtol=1e-5)
        else:
            np.testing.assert_array_equal(done[k], full[k])
    np.testing.assert_array_equal(done["xcoordinates"], full["xcoordinates"])


def test_loss2d_matches_jax_and_resumes_a_row(tmp_path, capsys):
    """A 5 x 3 surface along JAX's (dx, dy) against JAX's (losses 1e-5
    relative, accuracies equal); with one row erased, a second call
    evaluates that row's 5 points only (the others are left bit for bit)
    and equals the first; a third evaluates none."""
    jm, jv, tm = _pair()
    x, y = _data(32, seed=8)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    dirs = [_to_port(jll.random_direction(jv["params"], r))
            for r in (r1, r2)]
    kw = dict(xsteps=5, ysteps=3, chunk=4)
    want = jll.loss2d(jm, jv, jloaders.ArrayLoader(x, y, 16),
                      jax.random.PRNGKey(0), **kw)
    path = str(tmp_path / "s.npy")
    got = tll.loss2d(tm, tloaders.ArrayLoader(x, y, 16), path=path,
                     directions=dirs, **kw)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["acc"], want["acc"])
    assert "loss2d: 15 points in" in capsys.readouterr().out
    res = dict(np.load(path, allow_pickle=True).item())
    res["loss"][1] = np.nan
    np.save(path, res, allow_pickle=True)
    again = tll.loss2d(tm, tloaders.ArrayLoader(x, y, 16), path=path,
                       directions=dirs, **kw)
    assert "loss2d: 5 points in" in capsys.readouterr().out
    tll.loss2d(tm, tloaders.ArrayLoader(x, y, 16), path=path,
               directions=dirs, **kw)
    assert "points" not in capsys.readouterr().out
    np.testing.assert_array_equal(again["loss"][[0, 2]], got["loss"][[0, 2]])
    np.testing.assert_allclose(again["loss"], got["loss"], rtol=1e-6)


def test_loss_landscape_cli_writes_jaxs_file(tmp_path):
    """``loss_landscape --loss1d`` on the digits: JAX's result keys and
    51 finite points per split; a second call computes nothing (the file
    is not rewritten) and returns equal arrays."""
    argv = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
            "--data_dir", tloaders.FIXTURE_DIR, "--root_dir", str(tmp_path),
            "--results_dir", str(tmp_path), "--batch_size", "256",
            "--loss1d"]
    res = tll.main(argv)
    path = jckpt.results_paths(jconfig.parse_args(argv))[0] + "_loss1d.npy"
    assert sorted(res) == ["train_acc", "train_loss", "val_acc",
                           "val_loss", "xcoordinates"]
    assert all(np.isfinite(res[k]).all() and len(res[k]) == 51
               for k in res)
    stamp = os.stat(path).st_mtime_ns
    again = tll.main(argv)
    assert os.stat(path).st_mtime_ns == stamp
    for k in res:
        np.testing.assert_array_equal(again[k], res[k])


# -- the conversion round trip --------------------------------------------

#: one architecture per family of ``models.build``
FAMILIES = ["lenet5", "resnet18", "resnext50_32x4d", "mobilenet_v2",
            "mobilenet_v3_small", "efficientnet_b0", "efficientnet_v2_s",
            "shufflenet_v2_x0_5", "convnext_tiny", "regnet_y_400mf",
            "regnet_x_400mf", "mnasnet0_5", "gpt2_tiny"]


def _assert_trees_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{what}/{k}")
        else:
            assert np.asarray(got[k]).shape == np.asarray(want[k]).shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=what)


@pytest.mark.parametrize("name", FAMILIES + ["gpt2_tiny_stacked"])
def test_variables_to_jax_inverts_state_dict_from_jax(name):
    """``variables_to_jax`` of the model loaded through
    ``state_dict_from_jax`` gives the seeded variables back exactly, and
    its state dict round-trips too."""
    kw = {}
    if name.startswith("gpt2"):
        kw = dict(max_len=8, scan_blocks=name.endswith("stacked"))
        name = "gpt2_tiny"
    tm = tmodels.build(name, 10, device="cpu", **kw)
    variables = tmodels.seeded_variables(tm, 0)
    tm.load_state_dict(tmodels.state_dict_from_jax(variables), strict=True)
    back = tmodels.variables_to_jax(tm)
    _assert_trees_equal(back["params"], variables["params"], "params")
    _assert_trees_equal(back.get("batch_stats", {}),
                        variables.get("batch_stats", {}), "batch_stats")
    sd = tmodels.state_dict_from_jax(back)
    assert sorted(sd) == sorted(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("name", ["resnet18", "resnext50_32x4d",
                                  "gpt2_tiny_stacked", "lenet5"])
def test_stacked_buffers_round_trip_with_a_leading_axis(name):
    """SWAG's [K, ...] deviation buffers: with ``lead=1`` a 5-D conv
    kernel and a 3-D (a stacked model's 4-D) dense kernel take their own
    module's transpose in both directions; identity over the round trip."""
    kw = dict(max_len=8, scan_blocks=True) if name.startswith("gpt2") \
        else {}
    tm = tmodels.build(name.replace("_stacked", ""), 10, device="cpu", **kw)
    rng = np.random.default_rng(0)
    buf = {k: torch.from_numpy(rng.standard_normal(
        (3,) + tuple(p.shape)).astype(np.float32))
        for k, p in tm.named_parameters()}
    jax_layout = tmodels.variables_to_jax(tm, buf, lead=1)
    one = tmodels.variables_to_jax(tm, {k: v[1] for k, v in buf.items()})
    for layer, leaves in one["params"].items():
        for leaf, a in leaves.items():
            np.testing.assert_array_equal(
                jax_layout["params"][layer][leaf][1], a)
    back = tmodels.state_dict_from_jax(jax_layout, lead=1)
    assert sorted(back) == sorted(buf)
    for k, v in buf.items():
        assert torch.equal(back[k], v), k


def test_variables_to_jax_refuses_an_unplaced_key():
    tm = tmodels.lenet5(10, device="cpu")
    state = dict(tm.state_dict(), stray=torch.zeros(3))
    with pytest.raises(KeyError, match="stray"):
        tmodels.variables_to_jax(tm, state)


# -- tables ----------------------------------------------------------------

def _write_best(cfg, est, norm, scale):
    c = dataclasses.replace(cfg, estimator=est)
    path = os.path.join(c.results_dir, c.model, "data", est,
                        f"{c.prefix}{c.model}_{c.data}{c.suffix}"
                        "_best_params.npy")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, np.array([norm, scale]))


@pytest.mark.parametrize("best", [
    {"kfac": (633.1, 3.51e-07), "efb": (0.5, 1e4)},
    {"diag": (1.0, 45600.0), "kfac": (12.0, 5e4), "efb": (1e-3, 2.0),
     "inf": (145307.0, 60.0)},
    {}])
def test_hyperparameter_table_equals_jaxs(tmp_path, capsys, best):
    """The best-damping table, byte for byte, with some estimators
    missing (their "-" makes the column text), all present (numeric
    columns reformatted and decimal-aligned) and none."""
    argv = ["--results_dir", str(tmp_path), "--model", "lenet5"]
    for est, (norm, scale) in best.items():
        _write_best(tconfig.parse_args(argv), est, norm, scale)
    want = jvis.hyperparameter_table(jconfig.parse_args(argv))
    got = tvis.hyperparameter_table(tconfig.parse_args(argv))
    assert got == want
    out = capsys.readouterr().out
    assert out == want + "\n" + got + "\n"


@pytest.mark.parametrize("estimator", ["kfac", "diag"])
def test_summary_table_equals_jaxs(tmp_path, estimator):
    """``visualize --summary`` over a factor file (nested KFAC factors,
    flat diagonal arrays), byte for byte."""
    rng = np.random.default_rng(0)
    if estimator == "kfac":
        state = {"conv1": {"a": rng.standard_normal((26, 26)),
                           "g": rng.standard_normal((6, 6))},
                 "fc": {"a": rng.standard_normal((401, 401)),
                        "g": rng.standard_normal((120, 120))}}
    else:
        state = {"conv1": rng.standard_normal((6, 26)),
                 "fc3": rng.standard_normal((10, 85))}
    argv = ["--platform", "cpu", "--root_dir", str(tmp_path),
            "--estimator", estimator, "--summary"]
    tckpt.save_pytree(tckpt.factors_path(tconfig.parse_args(argv)), state)
    want = jvis.summary_table(jconfig.parse_args(argv))
    assert tvis.main(argv) == want


def test_fgsm_and_odd_tables_equal_tabulate():
    """The formatter against ``tabulate`` on the FGSM sweep's columns
    (``headers="keys"``, floats with nan and integers), numeric strings,
    empty cells and mixed columns."""
    cases = [
        ({"eps": [0.0, 0.1, 0.30000000000000004, 1.0],
          "acc": [75.78125, 60.0, 12.5, float("nan")],
          "n": [1, 2, 3, 100]}, "keys"),
        ([["a", "1,234", 3], ["bb", "", 4.5], ["", "7", None]],
         ["x", "y", "z"]),
        ([["1e+04", "True", "-"], ["2.5", "False", "3"]], ["p", "q", "r"]),
        ([[np.float32(0.1), np.int64(5), "x y "]], ["f", "i", "s"]),
    ]
    for rows, headers in cases:
        assert tabulate(rows, headers) == tabulate_lib.tabulate(
            rows, headers=headers)
