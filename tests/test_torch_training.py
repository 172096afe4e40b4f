"""Training (``pipelines/training.py``), the KFAC optimizer (``optim.py``)
and SWAG (``estimators/swag.py``) of the port against the JAX package.

Two models: a small BatchNorm net (conv -> BN -> conv s2 -> BN -> fc on
[B, 6, 6, 3], with the same names in both packages) and LeNet-5 on the
bundled digits. Weights come from ``models.seeded_variables`` (numpy),
given to JAX as they are and to the port through ``state_dict_from_jax``;
both packages read the same ``ArrayLoader`` batches (the same numpy
shuffles). Tolerances are stated per test, relative to the max of the JAX
value.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from curvature_tpu import estimators as jest
from curvature_tpu import nn as jnn
from curvature_tpu import optim as joptim
from curvature_tpu.data import loaders as jloaders
from curvature_tpu.estimators import swag as jswag
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import training as jtraining
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch import optim as toptim
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.estimators import swag as tswag
from curvature_tpu_torch.nn import core as tcore
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import training as ttraining
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

FIXTURE = tloaders.FIXTURE_DIR
DIGITS = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
          "--data_dir", FIXTURE]
#: the chip smoke's LeNet-5 training flags (chip_smoke.py TRAIN_LENET)
CHIP_FLAGS = ["--epochs", "20", "--lr", "0.01"]


class _JBNNet(jnn.Module):
    """conv -> BN -> ReLU -> conv s2 -> BN -> ReLU -> fc. The convs have no
    bias, as in a ResNet: a bias before BatchNorm has a zero gradient, and
    Adam would scale its rounding noise up to full steps."""

    def __init__(self, classes=5):
        self.c1 = jnn.Conv(8, 3, padding=1, use_bias=False, name="c1")
        self.b1 = jnn.BatchNorm(name="b1")
        self.c2 = jnn.Conv(8, 3, strides=2, padding=1, use_bias=False,
                           name="c2")
        self.b2 = jnn.BatchNorm(name="b2")
        self.fc = jnn.Dense(classes, name="fc")

    def __call__(self, ctx, x):
        x = jnn.ReLU()(ctx, self.b1(ctx, self.c1(ctx, x)))
        x = jnn.ReLU()(ctx, self.b2(ctx, self.c2(ctx, x)))
        return self.fc(ctx, jnn.Flatten()(ctx, x))


def _named(module, name):
    module.name = name
    return module


def _t_bn_net(classes=5):
    return tnn.Sequential([
        tnn.Conv(3, 8, 3, padding=1, bias=False, name="c1"),
        _named(tnn.BatchNorm(8), "b1"), tnn.ReLU(),
        tnn.Conv(8, 8, 3, 2, padding=1, bias=False, name="c2"),
        _named(tnn.BatchNorm(8), "b2"), tnn.ReLU(),
        tnn.Flatten(), tnn.Dense(72, classes, name="fc")])


def _pair(seed=0):
    """The BN net in both packages with the same seeded weights."""
    tm = _t_bn_net()
    variables = tmodels.seeded_variables(tm, seed)
    tmodels.load_jax_variables(tm, variables)
    jm = jnn.Model(_JBNNet())
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, 6, 6, 3), jnp.float32)))
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def _lenet_pair():
    tm = tmodels.lenet5(10, device="cpu")
    variables = tmodels.seeded_variables(tm, 42)
    tmodels.load_jax_variables(tm, variables)
    from curvature_tpu.models.lenet5 import lenet5 as jlenet5
    jm = jlenet5(10)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, 28, 28, 1), jnp.float32)))
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def _data(n=48, seed=1, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6, 6, 3)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def _loaders(x, y, batch=16, shuffle=True):
    return (jloaders.ArrayLoader(x, y, batch, shuffle=shuffle),
            tloaders.ArrayLoader(x, y, batch, shuffle=shuffle))


def _assert_variables_close(got, want, rel, what):
    """Each leaf of JAX-layout ``got`` within ``rel`` of max|leaf| of
    ``want``."""
    for part in ("params", "batch_stats"):
        w, g = want.get(part, {}), got.get(part, {})
        assert sorted(w) == sorted(g), (what, part)
        for layer in w:
            for leaf in w[layer]:
                a, b = np.asarray(g[layer][leaf]), np.asarray(w[layer][leaf])
                np.testing.assert_allclose(
                    a, b, atol=rel * max(np.abs(b).max(), 1e-30),
                    err_msg=f"{what}: {part}/{layer}/{leaf}")


# -- the learning-rate schedule -------------------------------------------

@pytest.mark.parametrize("total", [1, 2, 3, 7, 16, 100])
def test_lr_schedule_equals_optax(total):
    """Exactly optax's ``piecewise_constant_schedule`` with JAX's
    boundaries, every step and a few past the end (equal boundaries at
    T = 1 and 2 decay once)."""
    sched = optax.piecewise_constant_schedule(
        0.05, {int(total * 0.5): 0.1, int(total * 0.75): 0.1})
    for step in range(total + 3):
        assert ttraining.lr_at(step, 0.05, total) == float(sched(step)), step


# -- SGD and Adam ---------------------------------------------------------

@pytest.mark.parametrize("optimizer,flags", [
    ("sgd", ["--lr", "0.05", "--momentum", "0.9", "--l2", "1e-3"]),
    ("adam", ["--lr", "0.01"])])
def test_train_matches_jax(optimizer, flags):
    """Two epochs of 3 batches (6 steps, both lr decays): params and
    BatchNorm statistics within 1e-5 of each leaf's max, the loss history
    within 1e-5 relative, the validation accuracies equal."""
    argv = ["--platform", "cpu", "--epochs", "2"] + flags
    jm, jv, tm = _pair()
    x, y = _data()
    jtrain, ttrain = _loaders(x, y)
    xv, yv = _data(32, seed=2)
    jval, tval = _loaders(xv, yv, shuffle=False)
    want, jhist = jtraining.train(jm, jv, jtrain, jconfig.parse_args(argv),
                                  jval, optimizer=optimizer)
    _, thist = ttraining.train(tm, ttrain, tconfig.parse_args(argv), tval,
                               optimizer=optimizer)
    _assert_variables_close(tmodels.variables_to_jax(tm), want, 1e-5,
                            optimizer)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    assert thist["val_acc"] == jhist["val_acc"]


def test_checkpoint_loads_in_jax_build_model(tmp_path):
    """The port's ``training`` CLI writes ``weights/lenet5_mnist.npz`` in
    JAX's layout: JAX's ``build_model`` loads it and its logits on the
    test digits equal the trained port model's (1e-5 of max)."""
    argv = DIGITS + ["--root_dir", str(tmp_path), "--epochs", "1",
                     "--lr", "0.01"]
    tm, hist = ttraining.main(argv)
    assert len(hist["loss"]) == 1 and len(hist["val_acc"]) == 1
    jm, jv = jcommon.build_model(jconfig.parse_args(argv))
    x, _ = next(iter(tloaders.mnist(FIXTURE, 64, splits="test")))
    want, _ = jm.apply(jv, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5 * np.abs(want).max())


def test_lenet5_chip_flags_train_as_jax(tmp_path, capsys):
    """The chip smoke's LeNet-5 run (from the seeded initialization
    written as the checkpoint, ``CHIP_FLAGS``) in both packages on the
    CPU: test accuracies within 3 points of each other (the bar the card's
    run is held to against JAX's). Prints both."""
    acc = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        tckpt.save_pytree(str(root / "weights" / "lenet5_mnist.npz"),
                          tmodels.seeded_variables(
                              tmodels.lenet5(10, device="cpu"), 42))
        argv = DIGITS + ["--root_dir", str(root), "--results_dir",
                         str(root)]
        if who == "jax":
            jtraining.main(argv + CHIP_FLAGS)
            cfg = jconfig.parse_args(argv)
            probs, labels = jevaluate.test(cfg, *jcommon.build_model(cfg))
        else:
            ttraining.main(argv + CHIP_FLAGS)
            probs, labels = tevaluate.main(argv)
        acc[who] = 100.0 * float(np.mean(np.asarray(probs).argmax(1)
                                         == np.asarray(labels)))
    with capsys.disabled():
        print(f"\nLeNet-5 {' '.join(CHIP_FLAGS)} from the seeded "
              f"initialization, test accuracy: JAX {acc['jax']:.4f}%, "
              f"port {acc['port']:.4f}%")
    assert acc["jax"] > 70.0 and abs(acc["port"] - acc["jax"]) <= 3.0, acc


# -- the KFAC optimizer ---------------------------------------------------

def _metas_pair():
    """One dense, conv, grouped-conv and stacked-dense layer in both
    packages."""
    from curvature_tpu.nn.core import LayerMeta as JMeta
    spec = [("fc", "dense", 5, 7, True, (), (), 0, 1),
            ("cv", "conv", 6, 4 * 9, True, (3, 3), (1, 1), 0, 1),
            ("gc", "conv", 8, 2 * 9, False, (3, 3), (2, 2), 0, 4),
            ("st", "dense", 5, 6, True, (), (), 3, 1)]
    j, t = {}, {}
    for name, kind, out, fan, bias, ks, st, stacked, groups in spec:
        kw = dict(name=name, kind=kind, out_features=out, fan_in=fan,
                  has_bias=bias, kernel_size=ks, strides=st,
                  stacked=stacked, groups=groups)
        j[name] = JMeta(**kw)
        t[name] = tcore.LayerMeta(**kw)
    return j, t


def _tril(rng, lead, n):
    a = np.tril(rng.standard_normal(lead + (n, n))).astype(np.float32)
    return a + 3.0 * np.eye(n, dtype=np.float32)


def test_precondition_matches_jax():
    """``G_d^-1 Gmat A_d^-1`` on dense, conv, grouped-conv (4 groups) and
    stacked (depth 3) layers, and an untracked leaf passed through:
    within 1e-5 of each leaf's max."""
    rng = np.random.default_rng(0)
    jmetas, tmetas = _metas_pair()
    inv, grads = {}, {}
    for name, m in jmetas.items():
        lead = (m.stacked,) if m.stacked else \
            ((m.groups,) if m.groups > 1 else ())
        inv[name] = {"a_chol": _tril(rng, lead, m.fan_in + m.has_bias),
                     "g_chol": _tril(rng, lead, m.out_features // m.groups)}
        if m.kind == "conv":
            kh, kw = m.kernel_size
            shape = (kh, kw, m.fan_in // (kh * kw), m.out_features)
        else:
            shape = ((m.stacked,) if m.stacked else ()) + (m.fan_in,
                                                           m.out_features)
        grads[name] = {"kernel": rng.standard_normal(shape).astype(
            np.float32)}
        if m.has_bias:
            grads[name]["bias"] = rng.standard_normal(
                ((m.stacked,) if m.stacked else ()) + (m.out_features,)
            ).astype(np.float32)
    grads["bn"] = {"scale": rng.standard_normal(4).astype(np.float32),
                   "bias": rng.standard_normal(4).astype(np.float32)}
    want = joptim.precondition(jmetas, jax.tree_util.tree_map(
        jnp.asarray, inv), jax.tree_util.tree_map(jnp.asarray, grads))
    got = toptim.precondition(
        tmetas, tmodels.state_from_jax(inv, "cpu"),
        tmodels.state_dict_from_jax({"params": grads}))
    ref = tmodels.state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, want)})
    assert sorted(got) == sorted(ref)
    for key, w in ref.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                   atol=1e-5 * w.abs().max().item(),
                                   err_msg=key)


def test_precondition_refuses_split_factors():
    """JAX's ``ValueError`` for factors with extra block axes."""
    _, tmetas = _metas_pair()
    m = tmetas["fc"]
    inv = {"fc": {"a_chol": torch.eye(8)[None].repeat(3, 1, 1),
                  "g_chol": torch.eye(5)}}
    grads = {"fc.weight": torch.ones(5, 7), "fc.bias": torch.ones(5)}
    with pytest.raises(ValueError, match="posterior-only"):
        toptim.precondition({"fc": m}, inv, grads)
    inv = {"fc": {"a_chol": torch.eye(8), "g_chol": torch.eye(5),
                  "a_bias_chol": torch.eye(1)}}
    with pytest.raises(ValueError, match="posterior-only"):
        toptim.precondition({"fc": m}, inv, grads)


def test_kfac_train_step_matches_jax():
    """``make_kfac_train_step(mc_fisher=False, invert_every=3)`` for 7
    steps on the BN net (SGD with momentum; re-inversions at steps 0, 3 and
    6): params and BatchNorm statistics within 1e-4 of each leaf's max,
    every loss within 1e-4 relative."""
    jm, jv, tm = _pair()
    x, y = _data(7 * 8, seed=3)
    batches = [(x[i:i + 8], y[i:i + 8]) for i in range(0, len(x), 8)]
    kw = dict(damping=0.5, invert_every=3, mc_fisher=False)
    tx = optax.sgd(0.05, momentum=0.9)
    jstep, jinit = joptim.make_kfac_train_step(
        jm, jest.KFAC(jm, jv, use_pallas=False), tx, **kw)
    params, stats = jv["params"], jv["batch_stats"]
    factors, inv = jinit(jv, jnp.asarray(x[:8]), jnp.asarray(y[:8]),
                         jax.random.PRNGKey(0))
    opt_state, count, jlosses = tx.init(params), jnp.zeros((), jnp.int32), []
    for xb, yb in batches:
        params, opt_state, factors, inv, stats, count, loss = jstep(
            params, opt_state, factors, inv, stats, count, jnp.asarray(xb),
            jnp.asarray(yb), jax.random.PRNGKey(1))
        jlosses.append(float(loss))

    opt = torch.optim.SGD(tm.parameters(), lr=0.05, momentum=0.9)
    tstep, tinit = toptim.make_kfac_train_step(
        tm, port_est.KFAC(tm), opt, **kw)

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(
            a.transpose(0, 3, 1, 2)))
    tfactors, tinv = tinit(nchw(x[:8]), torch.from_numpy(y[:8]).long())
    tcount, tlosses = 0, []
    for xb, yb in batches:
        tfactors, tinv, tcount, loss = tstep(
            tfactors, tinv, tcount, nchw(xb), torch.from_numpy(yb).long())
        tlosses.append(float(loss))
    assert tcount == int(count) == 7
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    _assert_variables_close(
        tmodels.variables_to_jax(tm),
        {"params": params, "batch_stats": stats}, 1e-4, "kfac step")
    for name in jv["params"]:
        if name in factors:
            for k in ("a", "g"):
                w = np.asarray(factors[name][k])
                np.testing.assert_allclose(
                    tfactors[name][k].numpy(), w,
                    atol=1e-4 * np.abs(w).max(), err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", ["mobilenet_v2", "efficientnet_b0",
                                  "regnet_y_400mf", "shufflenet_v2_x0_5",
                                  "mnasnet0_5", "resnet18"])
def test_capture_leaves_batchnorm_statistics_alone(name):
    """An estimator's capture forward (train mode, batch statistics)
    leaves every BatchNorm running statistic as it was, as JAX discards
    the capture's statistics, also where the BatchNorm sits in a
    ``Sequential`` (the zoo's conv-BN blocks); a plain train-mode forward
    moves them all. The KFAC optimizer's step relies on this: its model
    updates its statistics once per step, in the loss forward."""
    tm = tmodels.build(name, 10, device="cpu")
    tmodels.load_jax_variables(tm, tmodels.seeded_variables(tm, 0))
    before = {k: v.clone() for k, v in tm.named_buffers()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    port_est.KFAC(tm).update(x, labels=torch.zeros(2, dtype=torch.long))
    assert all(torch.equal(v, before[k]) for k, v in tm.named_buffers())
    tm.train()
    tm(x)
    assert all(not torch.equal(v, before[k])
               for k, v in tm.named_buffers()), name


class _Recorded:
    """Mixin: a loader that records the labels of every batch it yields."""

    def __iter__(self):
        for x, y in super().__iter__():
            self.seen.append(np.array(y))
            yield x, y


class _JRec(_Recorded, jloaders.ArrayLoader):
    seen = None


class _TRec(_Recorded, tloaders.ArrayLoader):
    seen = None


def test_kfac_train_takes_jaxs_first_batch_and_batch_order():
    """``train(optimizer='kfac')`` on the digits (2 epochs, batch 128): the
    loader draws one permutation for the first batch, as JAX's
    ``next(iter(train_data))`` does, so every batch after it comes in
    JAX's order (the batches' labels equal, in order); the history is
    finite."""
    x, y, _, _ = tloaders._idx_dataset(FIXTURE, tloaders.MNIST_DIR)
    argv = ["--platform", "cpu", "--epochs", "2", "--lr", "0.01",
            "--opt_damping", "1.0"]
    jm, jv, tm = _lenet_pair()
    jl, tl = _JRec(x, y, 128, shuffle=True), _TRec(x, y, 128, shuffle=True)
    jl.seen, tl.seen = [], []
    jtraining.train(jm, jv, jl, jconfig.parse_args(argv), optimizer="kfac")
    _, hist = ttraining.train(tm, tl, tconfig.parse_args(argv),
                              optimizer="kfac")
    assert len(tl.seen) == len(jl.seen) == 1 + 2 * 4
    for got, want in zip(tl.seen, jl.seen):
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(hist["loss"]).all()


# -- SWAG -----------------------------------------------------------------

def _iterates(jv, n, seed):
    """``n`` JAX-layout parameter trees near ``jv``'s."""
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a)).astype(np.float32), jv["params"])
        for _ in range(n)]


@pytest.fixture(scope="module")
def swag_pair():
    """JAX's and the port's SWAG over 5 iterates of the BN net with a ring
    buffer of 3 (it wraps twice)."""
    jm, jv, tm = _pair()
    j = jswag.SWAG(jm, jv, max_rank=3)
    t = tswag.SWAG(tm, max_rank=3)
    for it in _iterates(jv, 5, 7):
        j.collect(jax.tree_util.tree_map(jnp.asarray, it))
        t.collect(tmodels.state_dict_from_jax({"params": it}))
    return dict(jm=jm, jv=jv, tm=tm, j=j, t=t)


def test_swag_moments_and_ring_buffer_match_jax(swag_pair):
    """Mean, second moment and the [3, ...] deviation buffer within 1e-6
    of each leaf's max; the count equal."""
    j, t = swag_pair["j"], swag_pair["t"]
    got = t.jax_state()
    assert int(got["n"]) == j.n == 5
    for part in ("mean", "sq_mean", "dev"):
        _assert_variables_close({"params": got[part]},
                                {"params": j.state[part]}, 1e-6, part)
    assert got["dev"]["c1"]["kernel"].shape == (3, 3, 3, 3, 8)


def _jax_swag_noise(j, rng, num):
    """JAX's standard-normal draws of ``ensemble_params(rng, num)``
    (swag.py:117-125, vmapped over ``split(rng, num)``), as the port's
    ``noise``."""
    leaves, treedef = jax.tree_util.tree_flatten(j.mean)
    k = jax.tree_util.tree_leaves(j.dev)[0].shape[0]
    out = []
    for key in jax.random.split(rng, num):
        r1, r2 = jax.random.split(key)
        z2 = jax.random.normal(r2, (k,), jnp.float32)
        z1 = [jax.random.normal(kk, leaf.shape, jnp.float32)
              for kk, leaf in zip(jax.random.split(r1, len(leaves)), leaves)]
        z1 = jax.tree_util.tree_map(
            np.asarray, jax.tree_util.tree_unflatten(treedef, z1))
        out.append({"z1": tmodels.state_dict_from_jax({"params": z1}),
                    "z2": torch.from_numpy(np.array(z2))})
    return out


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_swag_samples_match_jax_with_the_same_draws(swag_pair, scale):
    """``ensemble_params`` with JAX's draws: every sampled leaf within
    1e-6 of its max."""
    j, t, tm = swag_pair["j"], swag_pair["t"], swag_pair["tm"]
    j.invert(0.0, scale)
    t.invert(0.0, scale)
    rng = jax.random.PRNGKey(3)
    want = j.ensemble_params(rng, 4)
    got = t.ensemble_params(4, noise=_jax_swag_noise(j, rng, 4))
    for s, params in enumerate(got):
        _assert_variables_close(
            tmodels.variables_to_jax(tm, params),
            {"params": jax.tree_util.tree_map(lambda a: a[s], want)},
            1e-6, f"sample {s}")


def test_swag_state_files_load_in_both_packages(swag_pair, tmp_path):
    """A state file of either package loads in the other with the same
    numbers (a file write is exact)."""
    j, t, tm = swag_pair["j"], swag_pair["t"], swag_pair["tm"]
    jckpt.save_pytree(str(tmp_path / "j.npz"), j.state)
    back = tswag.SWAG(tm).load_jax_state(tckpt.load_pytree(
        str(tmp_path / "j.npz")))
    tckpt.save_pytree(str(tmp_path / "t.npz"), t.jax_state())
    jback = jswag.SWAG(swag_pair["jm"], swag_pair["jv"])
    jback.state = jckpt.load_pytree(str(tmp_path / "t.npz"))
    assert back.n == jback.n == 5 and back.mean_params is not None
    for part in ("mean", "sq_mean", "dev"):
        _assert_variables_close({"params": back.jax_state()[part]},
                                {"params": j.state[part]}, 0.0, part)
        _assert_variables_close({"params": jback.state[part]},
                                {"params": t.jax_state()[part]}, 0.0, part)


def test_update_batch_stats_matches_jax(swag_pair):
    """BatchNorm statistics re-estimated at the SWA mean over 3 batches,
    2 passes: within 1e-5 of each leaf's max."""
    jm, jv, t = swag_pair["jm"], swag_pair["jv"], swag_pair["t"]
    tm = _pair()[2]
    x, y = _data(48, seed=5)
    want = jswag.update_batch_stats(jm, swag_pair["j"].mean,
                                    jv["batch_stats"],
                                    jloaders.ArrayLoader(x, y, 16), passes=2)
    tswag.update_batch_stats(
        tm, t.mean, [(torch.from_numpy(np.ascontiguousarray(
            xb.transpose(0, 3, 1, 2))), yb)
            for xb, yb in tloaders.ArrayLoader(x, y, 16)], passes=2)
    _assert_variables_close(
        {"batch_stats": tmodels.variables_to_jax(tm)["batch_stats"]},
        {"batch_stats": want}, 1e-5, "batch_stats")


def test_training_swag_cli_then_evaluate_swag(tmp_path):
    """``training --swag`` for 4 epochs (the SWA window is the last,
    int(0.75 * 4) = 3) writes the checkpoint and the state file, which
    JAX's ``SWAG`` loads; ``evaluate --estimator swag --fgsm`` samples the
    SWAG posterior (its first row, epsilon 0, is the plain BNN eval)."""
    base = DIGITS + ["--root_dir", str(tmp_path), "--results_dir",
                     str(tmp_path)]
    ttraining.main(base + ["--epochs", "4", "--lr", "0.01", "--swag",
                           "--swag_rank", "5"])
    state = jckpt.load_pytree(str(tmp_path / "weights" /
                                  "lenet5_mnist_swag.npz"))
    assert int(state["n"]) == 1
    assert state["dev"]["conv1"]["kernel"].shape == (1, 5, 5, 1, 6)
    stats, bnn = tevaluate.main(base + ["--estimator", "swag", "--fgsm",
                                        "--norm", "1", "--scale", "1",
                                        "--samples", "2"])
    assert len(bnn["acc"]) == 19 and np.isfinite(bnn["nll"]).all()
    assert bnn["acc"][0] > 50.0 and stats["acc"][0] > 50.0


def test_hyper_and_factors_refuse_swag(tmp_path):
    """JAX's errors: ``factors --estimator swag`` is an unknown
    estimator; ``hyper`` finds no damping to tune on a SWAG."""
    from curvature_tpu_torch.pipelines import factors as tfactors
    from curvature_tpu_torch.pipelines import hyper as thyper
    base = DIGITS + ["--root_dir", str(tmp_path), "--results_dir",
                     str(tmp_path), "--estimator", "swag"]
    with pytest.raises(ValueError, match="unknown estimator"):
        tfactors.main(base)
    swag = tswag.SWAG(tmodels.lenet5(10, device="cpu"))
    swag.collect(swag.model)
    tckpt.save_pytree(str(tmp_path / "weights" / "lenet5_mnist_swag.npz"),
                      swag.jax_state())
    with pytest.raises(ValueError, match="no damping to tune"):
        thyper.main(base + ["--calls", "2"])


def test_config_fields_unchanged():
    """The flags this slice reads exist in both packages' Config."""
    t, j = tconfig.Config(), jconfig.Config()
    for f in ("swag", "swag_rank", "bn_update", "opt_damping", "l2",
              "momentum", "loss1d", "loss2d", "summary"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
