"""The port's model, tensor and seq axes on ``torch.distributed``, against
one process and against JAX.

The counterpart of tests/test_model_parallel.py's 12 cases (the expert
axis is in tests/test_torch_moe.py). One 4-rank gloo job on the CPU
(tests/torch_dist_worker.py ``job_mesh_axes``) runs every case on meshes
``model:2,data:2`` (a depth-sharded ScanBlocks ViT: KFAC, EFB's carry,
Diagonal, the ensemble, ``update_batches`` and the sharded checkpoint),
``tensor:2,data:2`` (a column-parallel MLP: KFAC and Diagonal),
``model:2,tensor:2,data:1`` (both on the ViT; JAX's combined case runs on
8 devices), ``seq:2,data:2`` (the GPT-2 token dim with given, drawn and
ragged labels, Diagonal and the Subspace sketch; LeNet-5's image rows)
and ``sample:2,data:2`` (the Subspace sketch).
This process runs the same cases without a mesh while the ranks run, and
JAX runs one process's update on the same numpy inputs and weights. Every
rank's ``gathered_state()`` is held to one port process at JAX's bar
(rtol 1e-5, atol 1e-6; draws rtol 1e-4, atol 1e-5), one port process to
JAX at the same bar scaled by each leaf's largest magnitude, and each
rank's blocks to 1/size of the whole leaf.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu import models as jmodels
from curvature_tpu.models.vit import vit as jvit
from curvature_tpu_torch import estimators, models, parallel
from curvature_tpu_torch.utils import checkpoint
from tests import torch_dist_worker as W

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DRAW_RTOL, DRAW_ATOL = 1e-4, 1e-5
PREFIX = "encoder.layers"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, one process's, the job's directory)."""
    out = str(tmp_path_factory.mktemp("mesh_axes"))
    procs = W.start("mesh_axes", 4, out)
    try:
        single = W.run_mesh_axes()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return W.finish(procs, "mesh_axes", out), single, out


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def single(runs):
    return runs[1]


def _hold(ranks, single, prefix, rtol=RTOL, atol=ATOL):
    """Every rank's gathered results under ``prefix`` equal one
    process's."""
    keys = [k for k in single if k.startswith(prefix + "/")]
    assert keys, prefix
    for r in ranks:
        for k in keys:
            np.testing.assert_allclose(r[k], single[k], rtol=rtol,
                                       atol=atol, err_msg=k)


def _shape(ranks, rank, key):
    return tuple(ranks[rank][f"shape/{key}"])


def _hold_jax(single, prefix, jstate):
    """One port process's state equals JAX's one process: rtol 1e-5 and
    atol 1e-6 of the leaf's largest magnitude (two programs' f32 sums
    differ in their order; LeNet-5's fc1 A holds entries near 13)."""
    for name, v in jstate.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        for k, leaf in leaves:
            key = f"{prefix}/{name}" + (f"/{k}" if k else "")
            want = np.asarray(leaf)
            np.testing.assert_allclose(
                single[key], want, rtol=RTOL,
                atol=ATOL * max(1.0, float(np.abs(want).max())),
                err_msg=f"{key} vs JAX")


def _jax(jm, port_model, x, labels, cls=jest.KFAC, **kw):
    """JAX's one-process state after one update, with the port model's
    weights."""
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = jax.tree_util.tree_map(
        jnp.asarray, models.variables_to_jax(port_model))
    est = cls(jm, variables, **kw)
    est.update(jnp.asarray(x), labels=jnp.asarray(labels))
    return jax.tree_util.tree_map(np.asarray, est.state)


def _jax_vit():
    return jvit(image_size=16, patch_size=8, dim=16, depth=4, heads=2,
                mlp_dim=32, num_classes=5, scan_blocks=True)


# -- model axis: depth-sharded ScanBlocks --------------------------------------
def test_depth_sharded_scan_kfac_matches_single_device(ranks, single):
    _hold(ranks, single, "vit_kfac")
    x, labels = W.vit_inputs()
    _hold_jax(single, "vit_kfac", _jax(_jax_vit(), W.scan_vit(), x, labels))
    # the stacked state lives as each rank's depth block; the rest whole
    assert _shape(ranks, 0, f"vit_kfac/{PREFIX}.mlp.0/g") == (2, 32, 32)
    assert _shape(ranks, 0, f"vit_kfac/{PREFIX}.mlp.0/a") == (2, 17, 17)
    assert _shape(ranks, 3, "vit_kfac/heads.head/g") == (5, 5)
    assert single[f"vit_kfac/{PREFIX}.mlp.0/g"].shape == (4, 32, 32)
    # invert and sample on the blocks equal one process's draw
    _hold(ranks, single, "vit_kfac_sample", DRAW_RTOL, DRAW_ATOL)


def test_depth_sharded_efb_carry(ranks, single):
    """EFB's carry (state, diags, eigenvectors) takes the depth rule; its
    factors equal one process's, its draws too."""
    for prefix in ("vit_efb", "vit_efb_diags"):
        _hold(ranks, single, prefix)
    _hold(ranks, single, "vit_efb_sample", DRAW_RTOL, DRAW_ATOL)
    assert _shape(ranks, 1, f"vit_efb/{PREFIX}.mlp.0") == (2, 32, 17)
    assert _shape(ranks, 1, f"vit_efb_diags/{PREFIX}.mlp.0") == (2, 32, 17)
    assert _shape(ranks, 1, "vit_efb/heads.head") == (5, 17)
    _hold(ranks, single, "vit_diag")
    x, labels = W.vit_inputs()
    _hold_jax(single, "vit_diag", _jax(_jax_vit(), W.scan_vit(), x, labels,
                                       jest.Diagonal))


def test_depth_sharded_block_and_inf(ranks, single):
    """BlockDiagonal and INF take the base stacked rule (JAX adds nothing
    for them): each rank builds its depth block of the state; INF's
    padded index sets are the largest over the stack's ranks, so the
    gathered state and the draws equal one process's."""
    _hold(ranks, single, "vit_block")
    x, labels = W.vit_inputs()
    _hold_jax(single, "vit_block", _jax(
        _jax_vit(), W.scan_vit(), x, labels, jest.BlockDiagonal,
        layer_filter=f"{PREFIX}.mlp.3"))
    _hold(ranks, single, "vit_inf")
    _hold(ranks, single, "vit_inf_sample", DRAW_RTOL, DRAW_ATOL)
    assert _shape(ranks, 0, f"vit_block/{PREFIX}.mlp.3") == (2, 528, 528)
    lam = [k for k in ranks[0] if k.startswith(f"shape/vit_inf/{PREFIX}.")
           and k.endswith("/lam")]
    assert lam and all(ranks[0][k][0] == 2 for k in lam)
    assert single[f"vit_inf/{PREFIX}.mlp.0/lam"].shape[0] == 4


def test_jax_weights_load_into_a_placed_model(ranks):
    """``models.load_jax_variables`` on a model split over the mesh takes
    each rank's blocks of the whole weights (``nn.placement
    .take_blocks``)."""
    for r in ranks:
        assert bool(r["vit_load_blocks_equal"])


def test_ensemble_params_from_depth_sharded_state(ranks, single):
    """The ensemble's posterior parameters, each rank's blocks gathered,
    equal one process's."""
    _hold(ranks, single, "vit_ens0", DRAW_RTOL, DRAW_ATOL)
    _hold(ranks, single, "vit_ens1", DRAW_RTOL, DRAW_ATOL)


def test_update_batches_with_model_axis(ranks, single):
    """Stacked batches with labels drawn in the update compose with the
    depth-sharded state."""
    _hold(ranks, single, "vit_batches")
    assert _shape(ranks, 2, f"vit_batches/{PREFIX}.mlp.3/g") == (2, 16, 16)


def test_sharded_state_checkpoint_roundtrip(ranks, single, runs):
    """The depth-sharded state writes its blocks and index without a
    gather; a load on the mesh gives each rank its own blocks bitwise, a
    load without one the whole state (the ranks' gathered state,
    bitwise). An orbax directory is refused."""
    _, _, out = runs
    for r in ranks:
        assert bool(r["ckpt_blocks_equal"])
    whole = W.flat("vit_kfac", checkpoint.load_pytree_sharded(
        f"{out}/ckpt"))
    for k, v in whole.items():
        np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)
    import os
    orbax = os.path.join(out, "orbax")
    os.makedirs(orbax)
    open(os.path.join(orbax, "_METADATA"), "w").close()
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.load_pytree_sharded(orbax)


# -- tensor axis: column parallelism --------------------------------------------
def test_tensor_parallel_kfac_matches_single_device(ranks, single):
    """G's row block from the whole output gradient, also through the
    fused Gram tap (``fused_g``, the rows of its [out, out] Gram) beside
    ``stack_grams``."""
    _hold(ranks, single, "mlp_kfac")
    _hold(ranks, single, "mlp_kfac_sample", DRAW_RTOL, DRAW_ATOL)
    _hold(ranks, single, "mlp_fused")
    _hold(ranks, single, "mlp_fused_sample", DRAW_RTOL, DRAW_ATOL)
    assert _shape(ranks, 1, "mlp_fused/fc1/g") == (16, 32)
    x, labels = W.wide_inputs()
    _hold_jax(single, "mlp_kfac", _jax(jmodels.mlp([32], 4),
                                       W.wide_mlp(), x, labels))
    # G's rows over 'tensor'; A (the input Gram) whole
    for name, out in (("fc1", 32), ("fc2", 4)):
        assert _shape(ranks, 0, f"mlp_kfac/{name}/g") == (out // 2, out)
        assert single[f"mlp_kfac/{name}/a"].shape == _shape(
            ranks, 0, f"mlp_kfac/{name}/a")


def test_tensor_parallel_diagonal_matches_single_device(ranks, single):
    _hold(ranks, single, "mlp_diag")
    _hold(ranks, single, "mlp_diag_sample", DRAW_RTOL, DRAW_ATOL)
    x, labels = W.wide_inputs()
    _hold_jax(single, "mlp_diag", _jax(jmodels.mlp([32], 4), W.wide_mlp(),
                                       x, labels, jest.Diagonal))
    assert _shape(ranks, 0, "mlp_diag/fc1") == (16, 9)
    assert _shape(ranks, 0, "mlp_diag/fc2") == (2, 33)


def test_combined_model_tensor_data_mesh(ranks, single):
    """Depth-sharded stacks whose wide Dense layers are column-parallel
    too (tensor_min_out=16): G [depth/2, out/2, out]."""
    _hold(ranks, single, "vit_both")
    _hold(ranks, single, "vit_both_sample", DRAW_RTOL, DRAW_ATOL)
    x, labels = W.vit_inputs()
    _hold_jax(single, "vit_both", _jax(_jax_vit(), W.scan_vit(), x, labels))
    assert _shape(ranks, 0, f"vit_both/{PREFIX}.mlp.0/g") == (2, 16, 32)
    assert _shape(ranks, 0, f"vit_both/{PREFIX}.mlp.0/a") == (2, 17, 17)
    assert _shape(ranks, 0, "vit_both/heads.head/g") == (5, 5)


# -- seq axis ------------------------------------------------------------------
def test_seq_sharded_lm_factors_match_single_device(ranks, single):
    """The [B, T] token dim over 'seq' with given labels (and JAX's),
    labels drawn in the update (one process's draws), and 7 tokens,
    which drop only the seq split (the ``noseq`` dispatch)."""
    for prefix in ("gpt_given", "gpt_drawn", "gpt_ragged", "gpt_diag"):
        _hold(ranks, single, prefix)
    _hold(ranks, single, "gpt_given_sample", DRAW_RTOL, DRAW_ATOL)
    for r in ranks:
        assert bool(r["gpt_ragged_dispatch"])
    toks, labels = W.gpt_inputs()
    jm = jmodels.gpt2_custom(vocab=32, dim=16, depth=2, heads=2, max_len=8)
    _hold_jax(single, "gpt_given",
              _jax(jm, W.tiny_gpt(), toks, labels, loss="lm"))
    _hold_jax(single, "gpt_ragged", _jax(jm, W.tiny_gpt(), toks[:, :7],
                                         labels[:, :, :7], loss="lm"))
    _hold_jax(single, "gpt_diag", _jax(jm, W.tiny_gpt(), toks, labels,
                                       jest.Diagonal, loss="lm"))
    # the drawn labels: one process's draws from the whole batch's logits
    # (the ranks draw the same), injected into JAX's update
    from curvature_tpu_torch.estimators import sample_labels
    from curvature_tpu_torch.nn.core import Context
    model = W.tiny_gpt().train()
    with torch.no_grad():
        logits = model(torch.from_numpy(toks), Context())
    draws = sample_labels(logits, 2, torch.Generator().manual_seed(3))
    _hold_jax(single, "gpt_drawn", _jax(jm, W.tiny_gpt(), toks,
                                        draws.numpy(), loss="lm"))


def test_seq_sharded_conv_spatial_partitioning(ranks, single):
    """LeNet-5 on 'seq': each rank's conv Grams over its block of output
    rows (the input rows they read, padded at the image's edges)."""
    _hold(ranks, single, "lenet_kfac")
    x, labels = W.lenet_inputs()
    _hold_jax(single, "lenet_kfac",
              _jax(jmodels.lenet5(10), W.lenet(), x, labels))


def test_subspace_on_seq_and_data_replicates_its_state(ranks, single):
    """The Subspace sketch on seq:2,data:2 and on sample:2,data:2: every
    rank's observation block summed over the ranks equals one process's
    sketch (the sample ranks repeat theirs: nothing is drawn); the state
    stays whole on every rank."""
    _hold(ranks, single, "gpt_subspace")
    assert _shape(ranks, 0, "gpt_subspace/lm_head/sketch") == (4, 32, 16)
    _hold(ranks, single, "mlp_subspace")
    assert _shape(ranks, 3, "mlp_subspace/fc1/sketch") == (4, 32, 9)


def test_every_rank_holds_the_same_gathered_state(ranks):
    for r in range(1, 4):
        for k, v in ranks[0].items():
            if not k.startswith("shape/"):
                np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)


# -- errors --------------------------------------------------------------------
def test_explicit_missing_axis_raises():
    mesh = parallel.make_mesh({"data": 1})
    with pytest.raises(ValueError, match="has no axis"):
        estimators.KFAC(W.wide_mlp()).use_mesh(mesh, model_axis="model")


def test_unrecognized_mesh_axis_raises():
    """A typo'd axis would idle its ranks: use_mesh rejects axes no
    sharding rule uses; naming it explicitly makes it legitimate."""
    mesh = parallel.make_mesh({"modle": 1, "data": 1})
    with pytest.raises(ValueError, match="not used by any sharding rule"):
        estimators.KFAC(W.wide_mlp()).use_mesh(mesh)
    est = estimators.KFAC(W.wide_mlp()).use_mesh(mesh, model_axis="modle")
    assert est.mesh is mesh
