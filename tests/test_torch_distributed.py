"""Real multi-process execution of the port: two ranks joined through
``torch.distributed`` over localhost.

The counterpart of tests/test_distributed.py and its worker: the ranks
start from ``torch.distributed.run``'s environment (``parallel.
initialize``), build the global mesh, take their rows
(``process_batch_slice``), assemble the global batch and labels
(``host_local_to_global``) and run one Diagonal update on the batch split
over them; the result equals one process's and JAX's on the same inputs.
The backend rule and the single-process no-op run here.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu.models import mlp as jmlp
from curvature_tpu_torch import estimators, models, parallel
from curvature_tpu_torch.parallel import distributed as D
from tests import torch_dist_worker as W

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.launch("distributed", 2,
                    str(tmp_path_factory.mktemp("distributed")))


def test_two_process_sharded_update(ranks):
    x, labels, m = W.dist_inputs()
    est = estimators.Diagonal(m)
    est.update(torch.from_numpy(x), labels=labels)
    jm = jmlp([7], 4)
    jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv = jax.tree_util.tree_map(jnp.asarray, models.variables_to_jax(m))
    jest_ = jest.Diagonal(jm, jv)
    jest_.update(jnp.asarray(x), labels=jnp.asarray(labels))
    for r in ranks:
        assert int(r["world"]) == 2
        for name in est.state:
            got = r[f"diag/{name}"]
            np.testing.assert_allclose(got, est.state[name].numpy(),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got, np.asarray(jest_.state[name]),
                                       rtol=1e-5, atol=1e-6)


def test_process_batch_slice_and_host_local_to_global(ranks):
    x, labels, _ = W.dist_inputs()
    for rank, r in enumerate(ranks):
        assert r["slice"].tolist() == [8 * rank, 8 * rank + 8]
        np.testing.assert_array_equal(r["x"], x)
        np.testing.assert_array_equal(r["labels"], labels)


def test_initialize_is_a_no_op_for_a_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize(device="cpu") is None
    assert not dist.is_initialized()
    assert D.process_batch_slice(16) == slice(0, 16)
    assert parallel.global_mesh().shape == {"data": 1}


def test_backend_rule(monkeypatch):
    """gloo for CPU tensors; on the card NCCL when every local rank has a
    GPU of its own, gloo when ranks share one."""
    assert D.pick_backend(torch.device("cpu"), 4)[0] == "gloo"
    cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert D.pick_backend(cuda, 1)[0] == "nccl"
    assert D.pick_backend(cuda, 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D.pick_backend(cuda, 4)[0] == "nccl"


def test_initialize_on_the_card_needs_a_gpu():
    """Without ``device="cpu"`` the collectives' device is the card, and
    a machine without one raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.initialize("localhost:1", 1, 0)
