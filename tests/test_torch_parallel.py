"""The port's data and sample axes on ``torch.distributed``, against one
process and against JAX's sharded factors.

The counterpart of tests/test_sharding.py (its 12 cases), plus the cases
GSPMD gives JAX for free and ranks do not: a BatchNorm network (train-mode
statistics couple the examples, so each rank must normalize over the whole
batch, forward and backward), a ragged batch (30 rows on 4 data ranks run
whole on every rank), KFAC's ``fused_g``/``stack_grams`` and the Block
estimator, and labels drawn inside the update. One 4-rank gloo job on the CPU (tests/torch_dist_worker.py)
runs every case on meshes ``data:4``, ``sample:2,data:2`` and
``sample:4``; this process runs the same cases without a mesh, and JAX
runs its sharded update on 4 of the conftest's 8 CPU devices. Every case
is held to both, at JAX's bar: rtol 1e-5, atol 1e-6. EFB takes JAX's
one-process KFAC factors and eigenvectors, INF's sample JAX's standard
normals (the test writes them for the ranks, which import no JAX), and
the labels drawn inside the update are injected into JAX's update as the
draws one process makes. Every rank must hold the same results (the
factor state stays replicated). The mesh errors run here, in one process.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import nn as jnn
from curvature_tpu import parallel as jparallel
from curvature_tpu.models import mlp as jmlp
from curvature_tpu_torch import estimators, parallel
from curvature_tpu_torch.utils.config import Config
from tests import torch_dist_worker as W

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_mlp):
    """(each rank's results, one process's, JAX's inputs to the EFB and
    INF cases): the ranks run while this process computes those inputs,
    writes them for the ranks and runs the same cases without a mesh."""
    out = str(tmp_path_factory.mktemp("sharding"))
    procs = W.start("sharding", 4, out)
    try:
        W.save_inputs(out, _jax_inputs(*jax_mlp))
        given = W.wait_inputs(out)
        single = W.run_cases(lambda: given)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return W.finish(procs, "sharding", out), single, given


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _hold(ranks, single, prefix):
    """Rank 0's results under ``prefix`` equal one process's; returns
    their keys."""
    keys = [k for k in single if k == prefix or k.startswith(prefix + "/")]
    assert keys, prefix
    for k in keys:
        _close(ranks[0][k], single[k], k)
    return keys


# -- JAX's sharded update on the same inputs and weights ----------------------
def _jax_model(module, port_model, x_shape):
    from curvature_tpu_torch import models
    jm = jnn.Model(module) if not isinstance(module, jnn.Model) else module
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                   jnp.zeros(x_shape, jnp.float32)))
    variables = models.variables_to_jax(port_model)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables)


def _jax_sharded(jm, jv, cls, x, labels, axes, **kw):
    """JAX's factor state after one update with the batch over ``data``
    (and the draws over ``sample``) on 4 CPU devices."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    est = cls(jm, jv, **kw)
    mesh = jparallel.make_mesh(axes, devices=jax.devices()[:4])
    rep = NamedSharding(mesh, P())
    lbl = P("sample", "data") if "sample" in axes else P(None, "data")
    step = jax.jit(est._step, in_shardings=(
        rep, rep, NamedSharding(mesh, P("data")), NamedSharding(mesh, lbl)),
        out_shardings=rep)
    with mesh:
        state = step(est.init_state(), jv, jnp.asarray(x),
                     jnp.asarray(labels))
    return jax.tree_util.tree_map(np.asarray, state)


def _hold_jax(ranks, prefix, jstate):
    for name, v in jstate.items():
        if isinstance(v, dict):
            for k, leaf in v.items():
                _close(ranks[0][f"{prefix}/{name}/{k}"], leaf,
                       f"{prefix}/{name}/{k} vs JAX")
        else:
            _close(ranks[0][f"{prefix}/{name}"], v, f"{prefix}/{name} vs JAX")


def _jax_mesh4():
    return jparallel.make_mesh({"data": 4}, devices=jax.devices()[:4])


def _jax_meshed(jm, jv, cls, x, labels, *args):
    """JAX's state after one update through ``use_mesh`` on ``data:4``
    (its ``_dispatch``: a batch that does not divide runs unsharded)."""
    est = cls(jm, jv, *args).use_mesh(_jax_mesh4())
    est.update(jnp.asarray(x), labels=jnp.asarray(labels))
    return jax.tree_util.tree_map(np.asarray, est.state)


def _jax_noise(shapes, seed):
    """JAX's standard normals of ``PRNGKey(seed)`` for ``shapes`` (one key
    per layer split off in order, as JAX's ``sample`` draws them)."""
    rng, noise = jax.random.PRNGKey(seed), {}
    for name, shape in shapes.items():
        rng, key = jax.random.split(rng)
        noise[name] = np.asarray(jax.random.normal(key, shape, jnp.float32))
    return noise


def _flat_np(prefix, tree):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_np(f"{prefix}/{k}", v))
        return out
    return {prefix: np.asarray(tree)}


def _jax_inputs(jm, jv):
    """What the EFB and INF cases take from JAX, flat for the ranks:
    JAX's one-process KFAC factors on the MLP batch (``kfac/...``), EFB's
    eigenvectors of them (``eigvecs/...``), and the standard normals of
    key 5 (``noise/...``) at the noise shapes of INF rank 10, bucket 4
    built from JAX's one-process Diagonal, KFAC and EFB states."""
    from curvature_tpu_torch import estimators as port_est
    x, labels, _, _ = W.mlp_inputs()
    xj, lj = jnp.asarray(x), jnp.asarray(labels)
    kfac = jest.KFAC(jm, jv)
    kfac.update(xj, labels=lj)
    diag = jest.Diagonal(jm, jv)
    diag.update(xj, labels=lj)
    efb = jest.EFB(jm, jv, kfac.state)
    efb.update(xj, labels=lj)
    efb.update(xj + 1, labels=jnp.asarray(labels[::-1].copy()))
    arrays = {**_flat_np("kfac", kfac.state),
              **_flat_np("eigvecs", efb.eigvecs)}
    port = W.unflat(arrays)

    def tensors(tree):
        return jax.tree_util.tree_map(
            lambda v: torch.from_numpy(np.array(v)), tree)
    inf = port_est.INF(W.mlp(), tensors(diag.state), port["kfac"],
                       tensors(efb.state), eigvecs=port["eigvecs"])
    inf.update(rank=10, bucket=4)
    arrays.update(_flat_np("noise", _jax_noise(inf.noise_shapes(), 5)))
    return arrays


def _port_draws(model, x, num_samples, seed):
    """The labels one process's update draws with
    ``torch.Generator().manual_seed(seed)``: categorical draws from the
    whole batch's train-mode logits (estimators/capture.py)."""
    from curvature_tpu_torch.estimators import sample_labels
    from curvature_tpu_torch.nn.core import Context
    model.train()
    with torch.no_grad():
        logits = model(x, Context())
    return sample_labels(logits, num_samples,
                         torch.Generator().manual_seed(seed)).numpy()


@pytest.fixture(scope="module")
def jax_mlp():
    return _jax_model(jmlp([16], 4), W.mlp(), (32, 8))


@pytest.fixture(scope="module")
def jax_bn():
    x, _ = W.bn_inputs()
    module = jnn.Sequential([
        jnn.Conv(8, 3, padding=1, name="c1"), jnn.BatchNorm(name="bn1"),
        jnn.ReLU(), jnn.Conv(8, 3, strides=2, padding=1, name="c2"),
        jnn.BatchNorm(name="bn2"), jnn.ReLU(), jnn.Flatten(),
        jnn.Dense(10, name="fc")])
    return _jax_model(module, W.bn_net(), x.shape)


@pytest.fixture(scope="module")
def jax_efb(runs, jax_mlp):
    """JAX's EFB on ``data:4`` from the KFAC factors the ranks take (so
    the same eigenvectors), through the two updates the ranks make."""
    jm, jv = jax_mlp
    kfac = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                  runs[2]["kfac"])
    x, labels, _, _ = W.mlp_inputs()
    est = jest.EFB(jm, jv, kfac).use_mesh(_jax_mesh4())
    est.update(jnp.asarray(x), labels=jnp.asarray(labels))
    est.update(jnp.asarray(x + 1), labels=jnp.asarray(labels[::-1].copy()))
    return est


# -- the cases of tests/test_sharding.py --------------------------------------
def test_sharded_kfac_matches_single_and_jax(ranks, single, jax_mlp):
    _hold(ranks, single, "kfac")
    x, labels, _, _ = W.mlp_inputs()
    _hold_jax(ranks, "kfac", _jax_sharded(*jax_mlp, jest.KFAC, x, labels,
                                          {"data": 4}))


def test_sharded_diagonal_matches_single_and_jax(ranks, single, jax_mlp):
    _hold(ranks, single, "diag")
    x, labels, _, _ = W.mlp_inputs()
    _hold_jax(ranks, "diag", _jax_sharded(*jax_mlp, jest.Diagonal, x, labels,
                                          {"data": 4}))


def test_2d_mesh_data_and_sample(ranks, single, jax_mlp):
    """Batch over 'data', the 4 injected draws over 'sample': KFAC's G
    and Diagonal's squared gradients."""
    _hold(ranks, single, "kfac_sd")
    _hold(ranks, single, "diag_sd")
    x, _, labels4, _ = W.mlp_inputs()
    for prefix, cls in (("kfac_sd", jest.KFAC), ("diag_sd", jest.Diagonal)):
        _hold_jax(ranks, prefix, _jax_sharded(
            *jax_mlp, cls, x, labels4, {"sample": 2, "data": 2}))


def test_sharded_efb_matches_single_device(ranks, single, jax_efb):
    """The lambdas and the free diagonal, against one process and JAX's
    EFB through ``use_mesh``."""
    _hold(ranks, single, "efb")
    _hold(ranks, single, "efb_diags")
    _hold_jax(ranks, "efb", jax.tree_util.tree_map(np.asarray, jax_efb.state))
    _hold_jax(ranks, "efb_diags", jax.tree_util.tree_map(np.asarray,
                                                         jax_efb.diags))


def test_sharded_inf_invert_sample_matches_single_device(ranks, single,
                                                          jax_mlp, jax_efb):
    """INF built from the meshed diag/KFAC/EFB states, inverted and
    sampled with the same standard normals: against one process, and
    against JAX's INF from its sharded states with invert and sample run
    as mesh programs (tests/test_sharding.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    keys = _hold(ranks, single, "inf_sample")
    assert all(np.isfinite(ranks[0][k]).all() for k in keys)
    jm, jv = jax_mlp
    x, labels, _, _ = W.mlp_inputs()

    def sharded(cls):
        return jax.tree_util.tree_map(jnp.asarray, _jax_sharded(
            jm, jv, cls, x, labels, {"data": 4}))
    inf = jest.INF(jm, jv, sharded(jest.Diagonal), sharded(jest.KFAC),
                   jax_efb.state, eigvecs=jax_efb.eigvecs)
    inf.update(rank=10, bucket=4)
    rep = NamedSharding(_jax_mesh4(), P())
    inf._jit_invert = jax.jit(inf.invert_state, in_shardings=(rep, rep, rep),
                              out_shardings=rep)
    inf._jit_sample = jax.jit(inf.sample_state, in_shardings=(rep, rep),
                              out_shardings=rep)
    inf.invert(add=W.ADD, multiply=W.MULTIPLY)
    _hold_jax(ranks, "inf_sample", jax.tree_util.tree_map(
        np.asarray, inf.sample(jax.random.PRNGKey(5))))


def test_sharded_grouped_kfac_matches_single_and_jax(ranks, single):
    from tests.test_torch_grouped import _JGroupedNet
    _hold(ranks, single, "grouped")
    x, labels = W.grouped_inputs()
    jm, jv = _jax_model(_JGroupedNet(), W.grouped_net(), x.shape)
    _hold_jax(ranks, "grouped", _jax_sharded(jm, jv, jest.KFAC, x, labels,
                                             {"data": 4}))


def test_batched_hyper_evaluator_on_mesh(ranks, single):
    _hold(ranks, single, "hyper_cost")


def test_swag_predictor_on_mesh(ranks, single):
    """SWAG's 8 members over the predictor's 4 sample ranks."""
    _hold(ranks, single, "swag_mean")


def test_logdet_and_marglik_tune_with_replicated_state(ranks, single):
    from curvature_tpu_torch.eval.marglik import marglik_gradient_tune
    _hold(ranks, single, "kfac_logdet")
    est = estimators.KFAC(W.mlp(), use_kernels=False)
    for name in est.state:
        for k in ("a", "g"):
            est.state[name][k] = torch.from_numpy(
                ranks[0][f"kfac/{name}/{k}"])
    assert est.logdet_precision(0.5, 2.0) == pytest.approx(
        float(single["kfac_logdet"]), rel=RTOL)
    assert np.isfinite(marglik_gradient_tune(est, 10.0, steps=30)
                       ["log_marglik"])


def test_training_step_on_mesh_matches_single_device(ranks, single):
    """Two SGD steps of the BatchNorm net (its running statistics too)
    and of the MLP, a ragged batch, and two KFAC-optimizer steps."""
    for prefix in ("train_bn", "train_mlp", "kfac_step"):
        _hold(ranks, single, prefix)
    assert np.isfinite(ranks[0]["train_mlp/ragged_loss"])


def test_loss_landscape_eval_on_mesh_matches_single_device(ranks, single):
    _hold(ranks, single, "landscape_loss")
    _hold(ranks, single, "landscape_acc")


def test_alternate_predictives_on_mesh(ranks, single):
    for prefix in ("eval_nn", "eval_bnn", "closed_form", "linearized"):
        _hold(ranks, single, prefix)


# -- the cases ranks must build themselves ------------------------------------
def test_batchnorm_model_matches_single_and_jax(ranks, single, jax_bn):
    """Train-mode BatchNorm normalizes over the whole batch on every
    rank: KFAC's and Diagonal's factors equal one process's and JAX's."""
    _hold(ranks, single, "bn_kfac")
    _hold(ranks, single, "bn_diag")
    x, labels = W.bn_inputs()
    for prefix, cls in (("bn_kfac", jest.KFAC), ("bn_diag", jest.Diagonal)):
        _hold_jax(ranks, prefix, _jax_sharded(*jax_bn, cls, x, labels,
                                              {"data": 4}))


def test_drawn_labels_match_single_process(ranks, single, jax_mlp, jax_bn):
    """Labels drawn inside the update (4 over ``sample:2,data:2``; 2 on
    the BatchNorm net over ``data:4``) are one process's draws: the
    factors equal one process's, and JAX's sharded update's with those
    draws injected."""
    _hold(ranks, single, "drawn_kfac_sd")
    _hold(ranks, single, "drawn_bn_diag")
    x, _, _, _ = W.mlp_inputs()
    drawn = _port_draws(W.mlp(), torch.from_numpy(x), 4, 7)
    _hold_jax(ranks, "drawn_kfac_sd", _jax_sharded(
        *jax_mlp, jest.KFAC, x, drawn, {"sample": 2, "data": 2}))
    bx, _ = W.bn_inputs()
    drawn = _port_draws(W.bn_net(), W.nchw(bx), 2, 8)
    _hold_jax(ranks, "drawn_bn_diag", _jax_sharded(
        *jax_bn, jest.Diagonal, bx, drawn, {"data": 4}))


def test_ragged_batch_runs_whole_on_every_rank(ranks, single, jax_mlp):
    """30 rows on 4 data ranks: every rank runs the whole batch, as JAX's
    ``_dispatch`` falls back to the unsharded program."""
    x, labels, _, _ = W.mlp_inputs()
    for prefix, cls in (("ragged_kfac", jest.KFAC),
                        ("ragged_diag", jest.Diagonal)):
        _hold(ranks, single, prefix)
        _hold_jax(ranks, prefix, _jax_meshed(*jax_mlp, cls, x[:30],
                                             labels[:, :30]))


@pytest.mark.parametrize("prefix", ["block", "kfac_fused"])
def test_block_and_kfac_options_on_mesh(ranks, single, jax_mlp, prefix):
    """BlockDiagonal, and KFAC with ``fused_g`` and ``stack_grams``."""
    _hold(ranks, single, prefix)
    x, labels, _, _ = W.mlp_inputs()
    cls, kw = ((jest.BlockDiagonal, {}) if prefix == "block" else
               (jest.KFAC, {"fused_g": True, "stack_grams": True}))
    _hold_jax(ranks, prefix, _jax_sharded(*jax_mlp, cls, x, labels,
                                          {"data": 4}, **kw))


def test_every_rank_holds_the_same_results(ranks):
    for r in range(1, 4):
        assert set(ranks[r]) == set(ranks[0])
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)


# -- errors -------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["data", ":2", "data:2,", "data:x"])
def test_bad_spec_raises(spec):
    with pytest.raises(ValueError):
        parallel.mesh_from_spec(spec)


def test_size_mismatch_raises():
    with pytest.raises(ValueError, match="!= 1 ranks"):
        parallel.make_mesh({"data": 2})


def test_unused_and_absent_axes_raise():
    est = estimators.Diagonal(W.mlp())
    with pytest.raises(ValueError, match="not used by any sharding rule"):
        est.use_mesh(parallel.make_mesh({"data": 1, "foo": 1}))
    with pytest.raises(ValueError, match="has no axis"):
        est.use_mesh(parallel.make_mesh({"data": 1}), sample_axis="sample")
    with pytest.raises(ValueError, match="has no axis"):
        est.use_mesh(parallel.make_mesh({"sample": 1}))


@pytest.mark.parametrize("axis", ["model", "tensor", "seq", "expert"])
def test_later_axes_raise_not_implemented(axis):
    """The model, tensor, seq and expert axes are ported (this test's name
    is from when they raised): a size-1 axis is exactly the single path
    (no block, no collective), in use_mesh and in the CLIs' --mesh; an
    unknown axis still raises."""
    x, labels, _, _ = W.mlp_inputs()
    a = estimators.KFAC(W.mlp(), use_kernels=False)
    b = estimators.KFAC(W.mlp(), use_kernels=False).use_mesh(
        parallel.make_mesh({axis: 1, "data": 1}), tensor_min_out=1)
    for e in (a, b):
        e.update(torch.from_numpy(x), labels=labels)
    assert b.gathered_state() is b.state
    for name in a.state:
        for k in ("a", "g"):
            assert torch.equal(a.state[name][k], b.state[name][k])
    cfg = Config(platform="cpu", mesh=f"{axis}:1,data:1")
    assert parallel.build_mesh(cfg).shape == {axis: 1, "data": 1}
    with pytest.raises(ValueError, match="not used"):
        parallel.build_mesh(dataclasses.replace(cfg, mesh="data:1,foo:1"))


def test_world_of_one_mesh_is_the_single_path():
    """A one-rank mesh without a process group: the update is exactly one
    process's (no collective runs)."""
    x, labels, _, _ = W.mlp_inputs()
    a = estimators.KFAC(W.mlp(), use_kernels=False)
    b = estimators.KFAC(W.mlp(), use_kernels=False).use_mesh(
        parallel.make_mesh())
    for e in (a, b):
        e.update(torch.from_numpy(x), labels=labels)
    for name in a.state:
        for k in ("a", "g"):
            assert torch.equal(a.state[name][k], b.state[name][k])
