"""The causal-LM pipeline: ``factors`` -> ``evaluate`` on ``--data tokens``
in the port against the JAX CLIs, on ``gpt2_tiny`` with depth-stacked
blocks (``--seq_len 16 --batch_size 32 --scan_blocks``, JAX
tests/test_lm_pipeline.py's configuration) on the CPU.

Both packages read one JAX-layout weights file from ``<root>/weights``, so
they run the same network. The token data is identical in both; the
factor files swap between the packages (JAX's keys, stacked ``[depth,
...]`` leaves); the deterministic per-token predictions agree (1e-5 of
max); with a vocabulary of 8,192 or more ``evaluate --ood`` takes the
per-token statistics route.
"""
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu.eval import evaluate as jeval
from curvature_tpu.pipelines import common as jcommon
from curvature_tpu.pipelines import evaluate as jevaluate
from curvature_tpu.pipelines import factors as jfactors
from curvature_tpu.utils import checkpoint as jckpt
from curvature_tpu.utils import config as jconfig
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch.pipelines import common as tcommon
from curvature_tpu_torch.pipelines import evaluate as tevaluate
from curvature_tpu_torch.pipelines import factors as tfactors
from curvature_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

ARGV = ["--platform", "cpu", "--model", "gpt2_tiny", "--data", "tokens",
        "--seq_len", "16", "--batch_size", "32", "--scan_blocks",
        "--mc_samples", "2", "--samples", "3", "--rank", "16"]
DAMPING = ["--norm", "1", "--scale", "10"]


def _close(got, want, rel, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _with_weights(root, extra=()):
    """A root whose ``weights/gpt2_tiny_tokens.npz`` holds seeded
    JAX-layout variables of the scanned model."""
    argv = ARGV + list(extra) + ["--root_dir", root, "--results_dir", root]
    cfg = tconfig.parse_args(argv)
    model = tcommon.build_model(cfg)
    os.makedirs(os.path.join(root, "weights"), exist_ok=True)
    jckpt.save_pytree(os.path.join(root, "weights",
                                   "gpt2_tiny_tokens.npz"),
                      tmodels.seeded_variables(model, 3))
    return argv


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The port's diag/kfac/efb/inf factor files, and JAX's kfac file, on
    the same weights and data."""
    proot = str(tmp_path_factory.mktemp("port"))
    pargv = _with_weights(proot)
    for est in ("diag", "kfac", "efb", "inf"):
        tfactors.main(pargv + ["--estimator", est])
    jroot = str(tmp_path_factory.mktemp("jax"))
    jargv = _with_weights(jroot)
    jfactors.main(jargv + ["--estimator", "kfac"])
    return dict(pargv=pargv, jargv=jargv)


def test_token_data_and_loss_match_jax():
    t, j = tconfig.parse_args(ARGV), jconfig.parse_args(ARGV)
    assert tcommon.loss_kind(t) == jcommon.loss_kind(j) == "lm"
    for splits in ("train", "test"):
        for (tx, ty), (jx, jy) in zip(tcommon.build_data(t, splits),
                                      jcommon.build_data(j, splits)):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    (_, tood), (_, jood) = tcommon.build_ood_data(t), \
        jcommon.build_ood_data(j)
    for (tx, ty), (jx, jy) in zip(tood, jood):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_factor_files_have_jax_keys_and_shapes(roots):
    """The port's kfac file holds JAX's keys with stacked [depth, ...]
    leaves; every file is finite."""
    t, j = (tconfig.parse_args(roots["pargv"] + ["--estimator", "kfac"]),
            jconfig.parse_args(roots["jargv"] + ["--estimator", "kfac"]))
    got = dict(_leaves(jckpt.load_pytree(jckpt.factors_path(t))))
    want = dict(_leaves(jckpt.load_pytree(jckpt.factors_path(j))))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
    assert got["h.mlp.c_fc/a"].shape == (2, 65, 65)
    for est in ("diag", "efb"):
        state = jckpt.load_pytree(jckpt.factors_path(
            tconfig.parse_args(roots["pargv"] + ["--estimator", est])))
        assert all(np.isfinite(v).all() for _, v in _leaves(state))


def test_jax_evaluate_reads_the_port_files(roots):
    """JAX's ``load_estimator`` takes the port's kfac, efb and inf files
    and inverts and samples them finite."""
    for est in ("kfac", "efb", "inf"):
        j = jconfig.parse_args(roots["pargv"] + ["--estimator", est]
                               + DAMPING)
        jm, jv = jcommon.build_model(j)
        je = jevaluate.load_estimator(j, jm, jv)
        jevaluate.invert_from_config(j, je, "")
        sample = je.sample(jax.random.PRNGKey(0))
        assert all(bool(jnp.isfinite(v).all()) for v in sample.values())


def test_port_evaluate_ood_on_the_jax_file(roots, capsys):
    """The port's ``evaluate --ood`` on JAX's kfac file: per-token
    predictions [256 * 16, 256], the NN ones within 1e-5 of JAX's
    ``eval_nn`` on the same weights."""
    argv = roots["jargv"] + ["--estimator", "kfac", "--ood"] + DAMPING
    preds, bnn, labels = tevaluate.main(argv)
    assert preds.shape == bnn.shape == (256 * 16, 256)
    assert labels.shape == (256 * 16,)
    np.testing.assert_allclose(bnn.sum(1), 1.0, atol=1e-4)
    assert "OOD AUROC" in capsys.readouterr().out
    j = jconfig.parse_args(argv)
    jm, jv = jcommon.build_model(j)
    want, wl = jeval.eval_nn(jm, jv, jcommon.build_data(j, "test"))
    np.testing.assert_array_equal(labels, wl)
    _close(preds, want, 1e-5, "nn predictions")


def test_vocab_scale_evaluate_takes_the_stats_route(tmp_path):
    """``--vocab 8192 --layers 'h.*'``: kfac factors, then ``evaluate
    --ood`` writes the per-token STATS_COLUMNS (``*_stats.npz``)."""
    root = str(tmp_path)
    argv = ARGV + ["--root_dir", root, "--results_dir", root, "--vocab",
                   "8192", "--seq_len", "8", "--layers", "h.*",
                   "--estimator", "kfac"]
    est = tfactors.main(argv)
    assert sorted(est.state) == ["h.attn.c_attn", "h.attn.c_proj",
                                 "h.mlp.c_fc", "h.mlp.c_proj"]
    nn_s, bnn_s, labels = tevaluate.main(argv + ["--ood"] + DAMPING)
    assert nn_s.shape == bnn_s.shape == (256 * 8, 4)
    assert np.isfinite(bnn_s).all() and labels.shape == (256 * 8,)
    (path,) = glob.glob(os.path.join(root, "**", "*_stats.npz"),
                        recursive=True)
    with np.load(path) as f:
        assert list(f["stats_columns"]) == list(jeval.STATS_COLUMNS)
        np.testing.assert_array_equal(f["nn_stats"], nn_s)
        assert f["ood_bnn_stats"].shape == (256 * 8, 4)


def test_moe_tokens_chain(tmp_path):
    """``gpt2_moe_tiny --data tokens``: ``factors --estimator kfac`` writes
    the per-expert ``[E, F, F]`` factors under JAX's keys and shapes (JAX's
    CLI writes the same config's file), ``hyper --objective marglik
    --optimizer grad`` tunes the damping on it, and ``evaluate --ood``
    gives per-token predictions."""
    from curvature_tpu_torch.pipelines import hyper as thyper
    argv = ["--platform", "cpu", "--model", "gpt2_moe_tiny", "--data",
            "tokens", "--seq_len", "16", "--batch_size", "32",
            "--mc_samples", "1", "--samples", "2", "--estimator", "kfac"]
    proot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    pargv = argv + ["--root_dir", proot, "--results_dir", proot]
    jargv = argv + ["--root_dir", jroot, "--results_dir", jroot]
    est = tfactors.main(pargv)
    assert est.metas["h.0.moe.fc1"].moe
    jfactors.main(jargv)
    got = dict(_leaves(jckpt.load_pytree(jckpt.factors_path(
        tconfig.parse_args(pargv)))))
    want = dict(_leaves(jckpt.load_pytree(jckpt.factors_path(
        jconfig.parse_args(jargv)))))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.isfinite(got[k]).all(), k
    assert got["h.0.moe.fc1/a"].shape == (4, 64, 64)
    assert got["h.1.moe.fc2/g"].shape == (4, 64, 64)
    res = thyper.main(pargv + ["--objective", "marglik", "--optimizer",
                               "grad"])
    assert np.isfinite(res["best_cost"])
    assert np.isfinite(np.asarray(res["best_x"], np.float64)).all()
    preds, bnn, labels = tevaluate.main(pargv + ["--ood"] + DAMPING)
    assert preds.shape == bnn.shape == (256 * 16, 256)
    assert labels.shape == (256 * 16,)
    np.testing.assert_allclose(bnn.sum(1), 1.0, atol=1e-4)
