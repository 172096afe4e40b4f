"""The port's pipeline CLIs on two ranks: ``--mesh data:2`` and
``--parallel`` write what one process writes.

The counterpart of tests/test_parallel_cli.py's six tests, on LeNet-5
and the bundled digits (the sixth, the model axis, on the scanned GPT-2
tiny's ``factors --mesh model:2,data:1``): ``factors`` diag, kfac and efb (EFB fed the one
process's KFAC file on both sides, as JAX's fixture does: eigh's basis
inside near-degenerate eigenspaces turns with the last bits of its
input), ``inf``, ``evaluate``, ``hyper --optimizer random``, then
``training`` and ``loss_landscape --loss1d`` with ``--parallel``. This
process runs the chain once without a mesh while one 2-rank gloo job
(tests/torch_dist_worker.py ``job_cli``) runs it with the mesh. The
bars are JAX's (1e-5; the INF reconstruction 1e-4, the training loss
history 1e-4). Each CLI's ``--mesh {axis}:1,data:1`` and the axis
errors run here.
"""
import os

import numpy as np
import pytest
import torch

from curvature_tpu_torch.pipelines import (
    evaluate, factors, hyper, loss_landscape, training)
from curvature_tpu_torch.utils.checkpoint import load_pytree
from tests import torch_dist_worker as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run while this process runs the single chain; they wait
    for its KFAC file before their EFB step."""
    base = tmp_path_factory.mktemp("cli")
    single_root = str(base / "single")
    os.makedirs(base / "mesh")
    procs = W.start("cli", 2, str(base / "mesh"))
    try:
        chain = W.run_cli(single_root)
        next(chain)
        (base / W.KFAC_DONE).touch()
        single = next(chain)
        W.run_lm_cli(str(base / "lm"))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = W.finish(procs, "cli", str(base / "mesh"))
    return single_root, str(base / "mesh" / "workspace"), single, ranks


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _files_close(a, b, rtol=1e-5, atol=1e-6):
    la, lb = dict(_leaves(load_pytree(a))), dict(_leaves(load_pytree(b)))
    assert set(la) == set(lb), (a, b)
    for k in la:
        np.testing.assert_allclose(lb[k], la[k], rtol=rtol, atol=atol,
                                   err_msg=f"{os.path.basename(a)}: {k}")


def _factors(root, name):
    return os.path.join(root, "factors", f"lenet5_mnist_{name}.npz")


def test_factors_cli_mesh_equals_single(runs):
    single, mesh, _, _ = runs
    for est in ("diag", "efb"):
        _files_close(_factors(single, est), _factors(mesh, est))
    # the mesh run's own KFAC file, before the single run's replaced it
    _files_close(_factors(single, "kfac"), _factors(mesh, "kfac_meshorig"))


def test_factors_cli_inf_mesh_equals_single(runs):
    """INF's low-rank build from mesh-written inputs: the posterior-
    defining ``lam`` and ``corr`` (eigh's sign freedom leaves the raw
    eigenvector columns free)."""
    single, mesh, _, _ = runs
    s = load_pytree(_factors(single, "inf20")[:-4])
    m = load_pytree(_factors(mesh, "inf20")[:-4])
    for name in s:
        for k in ("lam", "corr"):
            np.testing.assert_allclose(m[name][k], s[name][k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}/{k}")


def test_evaluate_cli_mesh_equals_single(runs):
    _, _, single, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["eval_predictions"],
                                   single["eval_predictions"], rtol=1e-5,
                                   atol=1e-6)


def test_hyper_cli_mesh_equals_single(runs):
    """The same candidates and ensembles: the same costs, the same best;
    rank 0 wrote the stats file, every rank returned the same rows."""
    single_root, mesh_root, single, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["hyper_cost"], single["hyper_cost"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r["hyper_best_x"],
                                      single["hyper_best_x"])
    path = os.path.join("lenet5", "data", "kfac", "random",
                        "lenet5_mnist_hyperopt_stats.npy")
    s = np.load(os.path.join(single_root, path), allow_pickle=True).item()
    m = np.load(os.path.join(mesh_root, path), allow_pickle=True).item()
    np.testing.assert_allclose(m["cost"], s["cost"], rtol=1e-5, atol=1e-6)


def test_training_and_loss_cli_parallel(runs):
    """``--parallel`` training reproduces the single loss history and its
    checkpoint; the 1-D landscape matches."""
    single_root, mesh_root, single, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["train_loss"], single["train_loss"],
                                   rtol=1e-4)
        for k in ("loss1d_train_loss", "loss1d_val_loss"):
            np.testing.assert_allclose(r[k], single[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    weights = os.path.join("weights", "lenet5_mnist.npz")
    _files_close(os.path.join(single_root, weights),
                 os.path.join(mesh_root, weights), rtol=1e-4)


CLIS = {"factors": factors, "evaluate": evaluate, "hyper": hyper,
        "training": training, "loss_landscape": loss_landscape}


#: the axis each CLI runs end to end on (every CLI parses all four)
CLI_AXIS = {"factors": "model", "evaluate": "tensor", "hyper": "seq",
            "training": "expert", "loss_landscape": "model"}
CLI_FLAGS = {"factors": ["--estimator", "diag"], "evaluate": [],
             "hyper": ["--estimator", "kfac", "--optimizer", "random",
                       "--calls", "2"],
             "training": ["--epochs", "1", "--lr", "1e-2"],
             "loss_landscape": ["--loss1d"]}


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_mesh_axes_are_checked_in_every_cli(cli, runs, tmp_path):
    """Each CLI accepts ``--mesh {axis}:1,data:1`` for the model, tensor,
    seq and expert axes (one run end to end, on a copy of the single
    run's files); an unknown axis and a size that is not the world's (one
    process here) raise ``ValueError`` before any work."""
    import shutil
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.parallel.mesh import build_mesh
    from curvature_tpu_torch.utils.config import setup
    root = str(tmp_path / "root")
    shutil.copytree(runs[0], root)
    main = CLIS[cli].main
    base = ["--platform", "cpu"]
    for axis in ("model", "tensor", "seq", "expert"):
        cfg = setup(base + ["--mesh", f"{axis}:1,data:1"])
        assert build_mesh(cfg).shape == {axis: 1, "data": 1}
    main(W.CLI_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                       "--results_dir", root, "--mesh",
                       f"{CLI_AXIS[cli]}:1,data:1"] + CLI_FLAGS[cli])
    with pytest.raises(ValueError, match="not used"):
        main(base + ["--mesh", "data:1,rows:1"])
    with pytest.raises(ValueError, match="!= 1 ranks"):
        main(base + ["--mesh", "data:2"])


def test_factors_cli_model_axis_equals_single(runs):
    """``factors --mesh model:2,data:1`` on two ranks (the scanned GPT-2
    tiny: each rank holds its half of the stack's depths, its factors'
    blocks gathered before rank 0 writes) writes one process's file."""
    single_root, mesh_root, _, _ = runs
    name = os.path.join("factors", "gpt2_tiny_tokens_kfac.npz")
    _files_close(os.path.join(os.path.dirname(single_root), "lm", name),
                 os.path.join(os.path.dirname(mesh_root), "lm", name))
