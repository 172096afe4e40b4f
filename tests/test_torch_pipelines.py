"""The pipeline slice against the JAX package: config, npz checkpoints,
loaders, LeNet-5 with the bundled weights, the per-layer A-factor routes,
``compute_factors``/``update_batches``, factor files swapped between the
packages, FGSM, and the flags that reach their modules.

Every case runs LeNet-5 on the bundled digits (4 batches of 128, the
port's copies of the JAX package's assets) or shapes alone. Both packages
get the same numpy inputs; MC labels are drawn from a seeded numpy
generator and injected into both (``jax.random`` and torch streams never
agree), as are the posterior samples' standard-normal draws (JAX's key
schedule rebuilt). Tolerances are relative to the max of the JAX value.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.data import loaders as jloaders
from curvature_tpu.estimators import capture as jcapture
from curvature_tpu.eval import attacks as jattacks
from curvature_tpu.eval import evaluate as jeval
from curvature_tpu.ops.pallas.patch_gram import select_patch_gram
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import factors as jfactors
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.data import loaders as tloaders
from curvature_tpu_torch.estimators import capture as tcapture
from curvature_tpu_torch.estimators import efb as tefb
from curvature_tpu_torch.eval import attacks as tattacks
from curvature_tpu_torch.eval import evaluate as teval
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import factors as tfactors
from curvature_tpu_torch.utils import checkpoint as tckpt
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

FIXTURE = tloaders.FIXTURE_DIR
#: 512 training digits in 4 batches: one update_batches chunk of 3 and a
#: ragged tail of 1
ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
        "--data_dir", FIXTURE, "--batch_size", "128", "--scan_chunk", "3",
        "--mc_samples", "2"]
NORM, SCALE, SAMPLES = 1.0, 5e4, 3


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _cfgs(argv):
    return tconfig.parse_args(argv), jconfig.parse_args(argv)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# -- config, checkpoints, paths -------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ARGV,
    ["--model", "resnet18", "--data", "synthetic", "--estimator", "efb",
     "--norm", "0.5", "--scale", "2", "--samples", "5", "--ood",
     "--precision", "bfloat16", "--layers", "fc,layer4.*", "--seed", "3"],
    ["--estimator", "inf", "--rank", "20", "--prefix", "p_", "--suffix",
     "_s", "--root_dir", "/r", "--token_subsample", "0.25", "--fgsm",
     "--epsilon", "0.1", "--stats", "--sample_chunk", "4"],
])
def test_parse_args_matches_jax(argv):
    t, j = _cfgs(argv)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_artefact_paths_match_jax(tmp_path):
    argv = ARGV + ["--root_dir", str(tmp_path / "r"), "--results_dir",
                   str(tmp_path / "out"), "--prefix", "a_", "--suffix", "_b",
                   "--estimator", "efb"]
    t, j = _cfgs(argv)
    for est, rank in ((None, ""), ("kfac", ""), ("diag", ""), (None, "100")):
        assert tckpt.factors_path(t, est, rank) == \
            jckpt.factors_path(j, est, rank)
    assert tckpt.results_paths(t) == jckpt.results_paths(j)
    assert tckpt.results_paths(t, "sub") == jckpt.results_paths(j, "sub")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_round_trip_is_bit_identical(tmp_path, writer):
    """A file written by either package loads in the other with the same
    keys, dtypes and bits (the port writes tensors)."""
    rng = np.random.default_rng(0)
    tree = {"conv1": {"a": rng.standard_normal((5, 5)).astype(np.float32),
                      "g": rng.standard_normal((3, 3)).astype(np.float32)},
            "fc": rng.standard_normal((4, 7)).astype(np.float32),
            "nest": {"deep": {"idx": np.arange(6, dtype=np.int32),
                              "f64": rng.standard_normal(3)}}}
    path = str(tmp_path / "f")
    if writer == "jax":
        jckpt.save_pytree(path, tree)
        loaded = tckpt.load_pytree(path)
    else:
        tckpt.save_pytree(path, {
            k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if k == "conv1" else v) for k, v in tree.items()})
        loaded = jckpt.load_pytree(path)
    want, got = dict(_leaves(tree)), dict(_leaves(loaded))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        assert got[k].tobytes() == w.tobytes(), k


# -- loaders ------------------------------------------------------------------

@pytest.mark.parametrize("splits", ["train", ("val", "test"), "test"])
def test_digit_loaders_match_jax(splits):
    """The same split, order and labels; the images to one float32 ulp
    (JAX's native decoder multiplies by 1/255f, the port divides by 255,
    the numpy branch of JAX's decode)."""
    t = tloaders.mnist(FIXTURE, 100, splits=splits)
    j = jloaders.mnist(FIXTURE, 100, splits=splits)
    if isinstance(splits, str):              # one loader, not a list
        t, j = [t], [j]
    assert len(t) == len(j)
    for tl, jl in zip(t, j):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 0
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(ty, jy)
            assert tx.shape == jx.shape and tx.dtype == jx.dtype
            np.testing.assert_array_max_ulp(tx, jx, maxulp=1)


def test_split_and_synthetic_data_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((90, 4)), rng.integers(0, 10, 90)
    for sizes in ([30, 60], [500, 500], [5000, 5000]):
        for (tx, ty), (jx, jy) in zip(tloaders._val_test_split(x, y, sizes),
                                      jloaders._val_test_split(x, y, sizes)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    t, j = _cfgs(["--data", "synthetic", "--batch_size", "100"])
    for splits in ("train", "test"):
        tb = list(tcommon.build_data(t, splits))
        jb = list(jcommon.build_data(j, splits))
        assert len(tb) == len(jb)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    (ti, to), (ji, jo) = (tcommon.build_ood_data(t), jcommon.build_ood_data(j))
    for a, b in ((ti, ji), (to, jo)):
        for (tx, ty), (jx, jy) in zip(a, b):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


# -- LeNet-5 and the routes --------------------------------------------

@pytest.fixture(scope="module")
def lenet():
    t, j = _cfgs(ARGV)
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    test = list(tcommon.build_data(t, splits="test"))
    return dict(t=t, j=j, tm=tm, jm=jm, jv=jv, test=test)


def test_bundled_lenet5_logits_match_jax(lenet):
    """The bundled weights through the loaders' NHWC batches, moved to
    NCHW on the device as the pipelines do, against JAX ``apply`` on the
    NHWC batch: 1e-5; and the test split's accuracy well above chance."""
    correct = total = 0
    with torch.no_grad():
        for x, y in lenet["test"]:
            got = lenet["tm"](tcommon.nchw(tcommon.device_batch(x, "cpu")))
            want, _ = lenet["jm"].apply(lenet["jv"], jnp.asarray(x),
                                        train=False)
            _close(got, want, 1e-5, "logits")
            correct += int((got.argmax(1).numpy() == y).sum())
            total += len(y)
    assert correct / total > 0.5


def _jax_routes(jm, jv, x_shape, dtype):
    """JAX's route of each tracked layer (kfac.py:385-400): the
    correlation gate, then ``select_patch_gram`` under ``use_pallas``, on
    the layer inputs' shapes from an abstract capture (no FLOPs)."""
    je = jest.KFAC(jm, jv, use_pallas=True)
    acts = jax.eval_shape(
        lambda x: jcapture.collect(jm, je.metas, jv, x,
                                   labels=jnp.zeros((1, x_shape[0]),
                                                    jnp.int32),
                                   need_param_grads=False).acts,
        jax.ShapeDtypeStruct(x_shape, jnp.float32))
    itemsize = jnp.dtype(dtype).itemsize
    out = {}
    for name, meta in je.metas.items():
        shape = acts[name].shape
        route = "patches"
        if je._corr_gram_ok(meta, np.empty(shape, np.float32)):
            route = "corr"
        elif (meta.kind == "conv" and je.token_subsample >= 1.0
              and not isinstance(meta.padding, str)):
            route = select_patch_gram(shape[-1], meta.kernel_size,
                                      meta.strides, shape[1], shape[2],
                                      shape[0], itemsize) or "patches"
        out[name] = route
    return out


@pytest.mark.parametrize("arch", ["resnet18", "lenet5"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_table_matches_jax(arch, dtype):
    """Each layer's A-factor route at the pipeline's shapes (B=32,
    ResNet-18 CIFAR at 32², LeNet-5 at 28²), as ``chip_smoke.py`` expects
    its launches: f32 ResNet-18 eight tiled layers and one v2, bf16 one
    v2, LeNet-5 none."""
    data = "synthetic" if arch == "resnet18" else "mnist"
    t, j = _cfgs(["--platform", "cpu", "--model", arch, "--data", data,
                  "--data_dir", FIXTURE])
    tm = tcommon.build_model(t)
    jm, jv = jcommon.build_model(j)
    h, w, c = tcommon.input_shape(data)
    te = port_est.KFAC(tm, use_kernels=True)
    x = torch.zeros((32, c, h, w))
    acts = tcapture.collect(tm, te.metas, x, labels=torch.zeros(
        (1, 32), dtype=torch.long), need_param_grads=False).acts
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    got = {name: te.a_route(meta, acts[name].shape, itemsize)
           for name, meta in te.metas.items()}
    want = _jax_routes(jm, jv, (32, h, w, c), getattr(jnp, dtype))
    assert got == want
    counts = {r: list(got.values()).count(r) for r in ("tiled", "v2")}
    expect = {("resnet18", "float32"): {"tiled": 8, "v2": 1},
              ("resnet18", "bfloat16"): {"tiled": 0, "v2": 1}}
    assert counts == expect.get((arch, dtype), {"tiled": 0, "v2": 0})


# -- compute_factors and update_batches ------------------------------------

class Labels:
    """Seeded numpy MC labels in place of the port's draws, recorded in
    order."""

    def __init__(self):
        self.rng = np.random.default_rng(7)
        self.drawn = []

    def __call__(self, logits, num_samples, generator=None):
        y = self.rng.integers(0, logits.shape[-1],
                              (num_samples, logits.shape[0]))
        self.drawn.append(y)
        return torch.from_numpy(y)


@pytest.fixture(scope="module")
def factors(lenet):
    """The port's compute_factors for kfac, diag and efb with injected
    labels, and the JAX estimators updated batch by batch with the same
    batches and labels."""
    out = {}
    jkfac = None
    for name in ("kfac", "diag", "efb"):
        t, _ = _cfgs(ARGV + ["--estimator", name])
        labels = Labels()
        chunks = []
        update_batches = port_est.Estimator.update_batches

        def spy(est, xs, *a, **k):
            chunks.append(xs.shape[0])
            return update_batches(est, xs, *a, **k)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tcapture, "sample_labels", labels)
            mp.setattr(port_est.Estimator, "update_batches", spy)
            if name == "efb":
                je = jest.EFB(lenet["jm"], lenet["jv"], jkfac.state)
                mp.setattr(tefb, "kfac_eigenvectors", lambda *a, **k:
                           tmodels.state_from_jax(je.eigvecs, "cpu"))
            else:
                je = (jest.KFAC(lenet["jm"], lenet["jv"], use_pallas=False)
                      if name == "kfac" else
                      jest.Diagonal(lenet["jm"], lenet["jv"]))
            te = tfactors.compute_factors(
                lenet["tm"], tcommon.build_data(t, "train"), t,
                kfac_state=None if jkfac is None else jkfac.state)
        batches = list(tcommon.build_data(t, "train"))
        # one full chunk of --scan_chunk 3 batches, then the ragged tail
        assert chunks == [3]
        assert len(labels.drawn) == len(batches) == te.num_updates == 4
        for (x, _), y in zip(batches, labels.drawn):
            je.update(jnp.asarray(x), labels=jnp.asarray(y))
        if name == "kfac":
            jkfac = je
        out[name] = (te, je)
    return out


@pytest.mark.parametrize("name", ["kfac", "diag", "efb"])
def test_compute_factors_match_jax(factors, name):
    """rel 1e-5 per leaf (EFB: its lambdas in JAX's eigenbasis, which is
    injected, and its free diagonal)."""
    te, je = factors[name]
    want = dict(_leaves(je.state))
    got = dict(_leaves(te.state))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)
    if name == "efb":
        for k, w in _leaves(je.diags):
            _close(dict(_leaves(te.diags))[k], w, 1e-5, k)


def test_update_batches_equals_update_calls(lenet):
    """``update_batches`` over T stacked batches and T ``update`` calls,
    each drawing its MC labels from a generator seeded alike, give the same
    bits: the steps draw from the one generator in the same order."""
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.random((3, 8, 1, 28, 28), dtype=np.float32))
    a = port_est.KFAC(lenet["tm"])
    b = port_est.KFAC(lenet["tm"])
    gen_a = torch.Generator().manual_seed(5)
    gen_b = torch.Generator().manual_seed(5)
    a.update_batches(xs, gen_a, num_samples=2)
    for x in xs:
        b.update(x, generator=gen_b, num_samples=2)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    for (k, ga), (_, gb) in zip(_leaves(a.state), _leaves(b.state)):
        assert torch.equal(ga, gb), k


# -- factor files swapped between the packages ---------------------------

def _jax_noise(je, seed, samples):
    """The standard-normal draws of JAX's ``ensemble_params(PRNGKey(seed),
    samples)``: one key per sample, then one per layer in meta order."""
    out = []
    for key in jax.random.split(jax.random.PRNGKey(seed), samples):
        noise = {}
        for name, meta in je.metas.items():
            key, k = jax.random.split(key)
            noise[name] = np.array(jax.random.normal(
                k, (meta.mat_cols, meta.out_features), jnp.float32))
        out.append(noise)
    return out


@pytest.fixture(scope="module")
def swapped(lenet, tmp_path_factory):
    """KFAC factors written by the JAX CLI, and by the port's CLI from the
    same directory; each loaded by the other package's ``load_estimator``
    and inverted at blitz's damping."""
    root = str(tmp_path_factory.mktemp("factors"))
    argv = ARGV + ["--root_dir", root, "--results_dir", root,
                   "--mc_samples", "1", "--estimator", "kfac", "--norm",
                   str(NORM), "--scale", str(SCALE)]
    jfactors.main(argv)
    t, j = _cfgs(argv)
    te = tevaluate.load_estimator(t, lenet["tm"])
    tevaluate.invert_from_config(t, te, "")
    jm, jv = lenet["jm"], lenet["jv"]
    je = jevaluate.load_estimator(j, jm, jv)
    jevaluate.invert_from_config(j, je, "")
    # the port's CLI over the same flags, read back by JAX
    proot = str(tmp_path_factory.mktemp("port_factors"))
    pargv = [a if a != root else proot for a in argv]
    tfactors.main(pargv)
    pj = jevaluate.load_estimator(jconfig.parse_args(pargv), jm, jv)
    # JAX's inverse in the port, for the samples' parity
    fed = tevaluate.load_estimator(t, lenet["tm"])
    fed.inv_state = tmodels.state_from_jax(je.inv_state, "cpu")
    return dict(te=te, je=je, pj=pj, fed=fed, root=root, proot=proot, t=t,
                j=j)


def test_jax_factor_file_loads_in_the_port(lenet, swapped):
    """The file's arrays as the port's state, bit for bit; the damped
    inverse Choleskys within 5e-4 of JAX's (the factors being identical,
    all of it is the two f32 inversions: at blitz's scale 5e4 the damped
    factors are worse conditioned than at tests/test_torch_kfac.py's 50,
    1.0e-4 measured at conv2); the NN predictions within 1e-5; BNN
    predictions of 3 samples with JAX's draws and JAX's inverse within
    1e-5."""
    te, je = swapped["te"], swapped["je"]
    for k, w in _leaves(jckpt.load_pytree(jckpt.factors_path(swapped["j"]))):
        assert np.array_equal(dict(_leaves(te.state))[k].numpy(), w), k
    for k, w in _leaves(je.inv_state):
        _close(dict(_leaves(te.inv_state))[k], w, 5e-4, k)
    te = swapped["fed"]
    jm, jv, test = lenet["jm"], lenet["jv"], lenet["test"]
    nchw = [(tcommon.nchw(tcommon.device_batch(x, "cpu")), y)
            for x, y in test]
    want, _ = jeval.eval_nn(jm, jv, test)
    got, _ = teval.eval_nn(lenet["tm"], nchw)
    _close(got, want, 1e-5, "nn predictions")
    want, labels, _ = jeval.eval_bnn(jm, jv, je, test, SAMPLES,
                                     jax.random.PRNGKey(5))
    ens = te.ensemble_params(SAMPLES, noise=_jax_noise(je, 5, SAMPLES))
    got, got_labels, _ = teval.eval_bnn(lenet["tm"], te, nchw, SAMPLES,
                                        ensemble_params=ens)
    np.testing.assert_array_equal(got_labels, labels)
    _close(got, want, 1e-5, "bnn predictions")


def test_port_factor_file_loads_in_jax(swapped):
    """The port's CLI, run on the same flags, writes a file that JAX's
    ``load_estimator`` reads: the same layers and shapes as JAX's own file,
    finite, and its G factors' traces within 20% (the MC labels differ)."""
    j_own = swapped["je"].state
    j_port = swapped["pj"].state
    assert sorted(j_port) == sorted(j_own)
    for name in j_own:
        for k in ("a", "g"):
            assert np.shape(j_port[name][k]) == np.shape(j_own[name][k])
            assert np.isfinite(np.asarray(j_port[name][k])).all()
        # the A factors see no labels: the same batches give the same A
        _close(j_port[name]["a"], j_own[name]["a"], 1e-5, name)
        tr = [float(jnp.trace(s[name]["g"])) for s in (j_port, j_own)]
        assert abs(tr[0] - tr[1]) <= 0.2 * tr[1], name


@pytest.mark.parametrize("epsilon", [0.0, 0.1, 0.3])
def test_fgsm_matches_jax(lenet, swapped, epsilon):
    """FGSM on the test split: NN predictions within 1e-4 where the input
    gradient's sign is the same (a sign flips only where the gradient
    rounds to either side of 0: at most 0.1% of the pixels), the NN
    metrics within 1e-3; BNN with JAX's draws and inverse the same."""
    jm, jv, test = lenet["jm"], lenet["jv"], lenet["test"][:2]
    nchw = [(tcommon.nchw(tcommon.device_batch(x, "cpu")), y)
            for x, y in test]
    x, y = test[0]
    want = np.asarray(jattacks.fgsm(jm, jv, x, y, epsilon))
    got = tattacks.fgsm(lenet["tm"], nchw[0][0], torch.from_numpy(y),
                        epsilon).permute(0, 2, 3, 1).numpy()
    assert np.mean(np.abs(got - want) > 1e-6) <= 1e-3
    wp, _, ws = jattacks.eval_fgsm(jm, jv, test, epsilon)
    gp, _, gs = tattacks.eval_fgsm(lenet["tm"], nchw, epsilon)
    _close(gp, wp, 1e-4, "nn adversarial predictions")
    for k in ws:
        assert abs(gs[k] - ws[k]) <= 1e-3 * max(abs(ws[k]), 1.0), k
    te, je = swapped["fed"], swapped["je"]
    jens = je.ensemble_params(jax.random.PRNGKey(5), SAMPLES)
    tens = te.ensemble_params(SAMPLES, noise=_jax_noise(je, 5, SAMPLES))
    wp, _, _ = jattacks.eval_fgsm_bnn(jm, jv, je, test, SAMPLES, epsilon,
                                      ensemble_params=jens)
    gp, _, _ = tattacks.eval_fgsm_bnn(lenet["tm"], te, nchw, SAMPLES,
                                      epsilon, ensemble_params=tens)
    _close(gp, wp, 1e-4, "bnn adversarial predictions")


def test_evaluate_cli_writes_jax_keys(lenet, swapped, capsys):
    """The port's evaluate CLI on the JAX-written factors: the plain test
    prints JAX's summary line; ``--fgsm`` writes the sweep under JAX's
    artefact path and keys; ``--ood`` on MNIST needs KMNIST's files."""
    argv = ARGV + ["--root_dir", swapped["root"], "--results_dir",
                   swapped["root"], "--estimator", "kfac", "--norm",
                   str(NORM), "--scale", str(SCALE), "--samples",
                   str(SAMPLES)]
    preds, labels = tevaluate.main(argv)
    assert preds.shape == (256, 10)
    assert "NN : accuracy" in capsys.readouterr().out
    stats, bnn_stats = tevaluate.main(argv + ["--fgsm"])
    assert len(stats["eps"]) == len(tevaluate.FGSM_STEPS) == 19
    path = jckpt.results_paths(swapped["j"])[0] + "_fgsm.npz"
    with np.load(path, allow_pickle=True) as f:
        assert sorted(f.files) == ["bnn_stats", "stats"]
        assert f["stats"].item()["acc"] == stats["acc"]
    with pytest.raises(FileNotFoundError, match="KMNIST"):
        tevaluate.main(argv + ["--ood"])


# -- the flags reach their modules ----------------------------------------

@pytest.mark.parametrize("flags", [
    ["--loss2d"], ["--estimator", "swag"], ["--bn_update"], ["--swag"],
    ["--loss1d"]])
def test_ported_flags_reach_their_module(flags, tmp_path, monkeypatch):
    """The flags of the training slice parse and reach the function that
    serves them (``loss_landscape.loss1d``/``loss2d``, training's SWAG,
    evaluate's SWAG estimator and its BatchNorm re-estimate), here stubbed
    where the work itself is tested elsewhere
    (tests/test_torch_training.py, tests/test_torch_landscape.py)."""
    from curvature_tpu_torch.estimators import swag as tswag
    from curvature_tpu_torch.pipelines import loss_landscape as tll
    from curvature_tpu_torch.pipelines import training as ttraining
    base = ["--platform", "cpu", "--root_dir", str(tmp_path),
            "--results_dir", str(tmp_path)]
    digits = ["--model", "lenet5", "--data", "mnist", "--data_dir", FIXTURE]
    seen = []
    tconfig.setup(base + flags)
    if flags[0] in ("--loss1d", "--loss2d"):
        fn = flags[0][2:]
        monkeypatch.setattr(tll, fn, lambda *a, **k: seen.append(fn))
        tll.main(digits + base + flags)
    elif flags == ["--swag"]:
        def train(model, *a, swag=None, **k):
            swag.collect(model)
            seen.append(type(swag).__name__)
            return model, {}
        monkeypatch.setattr(ttraining, "train", train)
        ttraining.main(digits + base + flags)
        assert os.path.exists(tmp_path / "weights" / "lenet5_mnist_swag.npz")
    else:
        # a ResNet-18's SWAG state (BatchNorm: --bn_update has work)
        argv = base + ["--model", "resnet18", "--data", "synthetic",
                       "--estimator", "swag", "--ood", "--norm", "1",
                       "--scale", "1"]
        cfg = tconfig.parse_args(argv)
        swag = tswag.SWAG(tcommon.build_model(cfg))
        swag.collect(swag.model)
        tckpt.save_pytree(str(tmp_path / "weights" /
                              "resnet18_synthetic_swag.npz"),
                          swag.jax_state())
        monkeypatch.setattr(tevaluate, "out_of_domain",
                            lambda cfg, model, est, *a: seen.append(
                                type(est).__name__))
        monkeypatch.setattr(tevaluate, "update_batch_stats",
                            lambda *a, **k: seen.append("bn_update"))
        tevaluate.main(argv + flags[2:] if flags[0] == "--estimator"
                       else argv + flags)
    want = {"--loss1d": ["loss1d"], "--loss2d": ["loss2d"],
            "--swag": ["SWAG"], "--estimator": ["SWAG"],
            "--bn_update": ["bn_update", "SWAG"]}[flags[0]]
    assert seen == want


def test_unported_models_data_and_formats_raise(tmp_path):
    """A JAX orbax checkpoint directory is refused (reading one needs
    orbax, a JAX library; the port's sharded checkpoint is
    tests/test_torch_model_parallel.py's). The image-folder loaders are
    ported (tests/test_torch_images.py). The MoE GPT-2 is ported: it
    builds, with JAX's metas (tests/test_torch_moe.py). The fidelity diagnostics (item 8) are
    ported (tests/test_torch_matfree.py, the CLI chains below). The
    classic zoo, the vision transformers, CIFAR-10 and torch ``.pth``
    checkpoints are ported (tests/test_torch_zoo_classic.py,
    test_torch_zoo_transformers.py, test_torch_data.py,
    test_torch_torch_convert.py)."""
    moe = tmodels.build("gpt2_moe_tiny", 10, device="cpu", max_len=8)
    jmoe = jmodels.build("gpt2_moe_tiny", 10, max_len=8)
    jmoe.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    assert list(moe.metas) == list(jmoe.metas)
    assert [(m.stacked, m.moe) for m in moe.metas.values()] == \
        [(m.stacked, m.moe) for m in jmoe.metas.values()]
    t, _ = _cfgs(ARGV + ["--root_dir", str(tmp_path)])
    (tmp_path / "o").mkdir()
    (tmp_path / "o" / "_METADATA").touch()
    with pytest.raises(NotImplementedError, match="orbax"):
        tckpt.load_pytree_sharded(str(tmp_path / "o"))
    for flags in (["--fidelity", "2"], ["--spectrum", "3"],
                  ["--estimator", "subspace"]):
        assert tconfig.setup(["--platform", "cpu"] + flags)


def test_checkpoint_shape_mismatch_names_the_layer(tmp_path):
    (tmp_path / "weights").mkdir()
    bad = tckpt.load_pytree(os.path.join(
        os.path.dirname(tmodels.__file__), "assets", "lenet5_mnist.npz"))
    bad["params"]["fc1"]["kernel"] = np.zeros((256, 120), np.float32)
    tckpt.save_pytree(str(tmp_path / "weights" / "lenet5_mnist.npz"), bad)
    t, _ = _cfgs(ARGV + ["--root_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="fc1.kernel"):
        tcommon.build_model(t)


def test_cli_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tconfig.setup([])


# -- eval options, telemetry --------------------------------------------------

def test_bnn_stats_and_sample_chunk(lenet, swapped):
    """``stats`` gives JAX's running statistics for the same ensemble
    (1e-4: accuracy and ECE in percent, NLL and entropy); ``sample_chunk``
    draws the same ensemble a chunk at a time from one generator, so the
    mean predictions equal the unchunked ones (to the summation order)."""
    jm, jv, test = lenet["jm"], lenet["jv"], lenet["test"][:2]
    nchw = [(tcommon.nchw(tcommon.device_batch(x, "cpu")), y)
            for x, y in test]
    te, je = swapped["fed"], swapped["je"]
    _, _, want = jeval.eval_bnn(jm, jv, je, test, SAMPLES,
                                jax.random.PRNGKey(5), stats=True)
    ens = te.ensemble_params(SAMPLES, noise=_jax_noise(je, 5, SAMPLES))
    _, _, got = teval.eval_bnn(lenet["tm"], te, nchw, SAMPLES,
                               ensemble_params=ens, stats=True)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-4, k)
    full, labels, _ = teval.eval_bnn(
        lenet["tm"], te, nchw, SAMPLES,
        generator=torch.Generator().manual_seed(1))
    chunked, chunk_labels, _ = teval.eval_bnn(
        lenet["tm"], te, nchw, SAMPLES, sample_chunk=2,
        generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(chunk_labels, labels)
    _close(chunked, full, 1e-6, "chunked mean predictions")


def test_verbose_progress_and_telemetry(tmp_path, capsys):
    """``--verbose`` prints a plain progress line per batch with host RAM
    (from /proc/meminfo, psutil's definition) and device memory (0 on the
    CPU); ``setup`` seeds torch too."""
    from curvature_tpu_torch.utils import monitor
    tfactors.main(ARGV + ["--root_dir", str(tmp_path), "--estimator",
                          "diag", "--verbose"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Epoch [1/1]")]
    assert len(lines) == 4 and "RAM" in lines[-1] and "0.00GB" in lines[-1]
    assert 0.0 < monitor.ram() < 100.0
    assert monitor.device_memory_gb("cpu") == 0.0
    tconfig.setup(["--platform", "cpu", "--seed", "11"])
    a = torch.rand(3)
    monitor.seed_all_rng(11)
    assert torch.equal(a, torch.rand(3))


# -- the exact-curvature CLIs (ROADMAP Queue 1 item 8) -----------------------

def test_subspace_cli_chain(tmp_path):
    """``factors --estimator subspace --rank 12`` on the digits (two
    update_batches folds and a ragged tail, the MC draws unused) ->
    ``evaluate --estimator subspace --fgsm`` -> ``hyper --estimator
    subspace`` (the evidence by gradient ascent and a 3-candidate random
    search), JAX's pipeline order; the file carries its omega and reloads
    bit for bit."""
    from curvature_tpu_torch.pipelines import hyper as thyper
    argv = ARGV + ["--root_dir", str(tmp_path), "--results_dir",
                   str(tmp_path), "--estimator", "subspace", "--rank", "12",
                   "--seed", "0"]
    est = tfactors.main(argv)
    assert isinstance(est, port_est.Subspace) and est.rank == 12
    assert est.num_updates == 4
    t = tconfig.parse_args(argv)
    path = tckpt.factors_path(t) + ".npz"
    assert os.path.exists(path)
    loaded = tevaluate.load_estimator(t, tcommon.build_model(t))
    assert loaded.rank == 12
    for n, v in est.state.items():
        for key in ("omega", "sketch"):
            assert torch.equal(loaded.state[n][key], v[key]), (n, key)
    # outside its 12 directions the posterior is the prior alone: norm 1e4
    # keeps those weights' standard deviation at 0.01
    stats, bnn = tevaluate.main(argv + ["--norm", "1e4", "--scale", "1",
                                        "--fgsm", "--samples", "3"])
    assert np.isfinite(bnn["nll"]).all() and bnn["acc"][0] > 50.0
    out = thyper.main(argv + ["--objective", "marglik", "--optimizer",
                              "grad", "--calls", "5"])
    assert np.isfinite(out["best_cost"])
    out = thyper.main(argv + ["--optimizer", "random", "--calls", "3",
                              "--samples", "2"])
    assert np.isfinite(out["best_cost"])


def test_jax_subspace_factor_file_through_the_port_cli(tmp_path):
    """JAX's ``factors --estimator subspace`` writes the file; the port's
    ``evaluate`` loader reads it (omega and sketch) and gives JAX's
    logdet and eigenvalues: 1e-5 relative, 1e-4 of max."""
    argv = ARGV + ["--root_dir", str(tmp_path), "--results_dir",
                   str(tmp_path), "--estimator", "subspace", "--rank", "8",
                   "--seed", "0"]
    t, j = _cfgs(argv)
    je = jfactors.run(j)
    te = tevaluate.load_estimator(t, tcommon.build_model(t))
    assert te.rank == 8 and list(te.metas) == list(je.metas)
    want = je.logdet_precision(NORM, SCALE)
    assert abs(te.logdet_precision(NORM, SCALE) - want) <= 1e-5 * abs(want)
    _close(te.eigenvalues(), je.eigenvalues(), 1e-4, "lam")


def test_fidelity_and_spectrum_cli(tmp_path, capsys):
    """``factors --estimator kfac --fidelity 2 --spectrum 3`` writes JAX's
    npz layouts (``{layer}/{key}`` with the ``__joint__`` row; ``ritz``
    and ``weights``), the same keys as JAX's run of the same flags, and
    prints the table; the Ritz values descend and the weights sum to 1."""
    argv = ARGV + ["--root_dir", str(tmp_path / "port"), "--estimator",
                   "kfac", "--fidelity", "2", "--spectrum", "3"]
    tfactors.main(argv)
    out = capsys.readouterr().out
    assert "structural err" in out and "__joint__" in out
    t, _ = _cfgs(argv)
    jargv = ARGV + ["--root_dir", str(tmp_path / "jax"), "--estimator",
                    "kfac", "--fidelity", "2", "--spectrum", "3"]
    _, j = _cfgs(jargv)
    jfactors.run(j)
    for suffix in ("_fidelity.npz", "_spectrum.npz"):
        with np.load(tckpt.factors_path(t) + suffix) as got, \
                np.load(jckpt.factors_path(j) + suffix) as want:
            assert sorted(got.files) == sorted(want.files), suffix
            for k in got.files:
                assert got[k].shape == want[k].shape, k
                assert np.isfinite(got[k]).all(), k
            if suffix == "_spectrum.npz":
                assert (np.diff(got["ritz"]) <= 0).all()
                assert abs(got["weights"].sum() - 1.0) < 1e-4
            else:
                layers = {k.split("/")[0] for k in got.files}
                assert layers == {"conv1", "conv2", "fc1", "fc2", "fc3",
                                  "__joint__"}
                assert got["__joint__/alpha"] > 0
