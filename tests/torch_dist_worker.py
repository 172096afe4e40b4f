"""One rank of a multi-process ``torch.distributed`` job on the CPU, for
the port's parallel tests; it imports no JAX.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dist_worker.py <job> <out_dir>

The rank starts its process group from that environment
(``parallel.initialize``, gloo on the CPU), runs ``JOBS[job](out_dir)``
and writes what the job returns to ``<out_dir>/rank<r>.npz``. The model
and input builders are shared with the tests, which hold the ranks'
results to one process's and to JAX's on the same numpy-seeded inputs.
"""
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from curvature_tpu_torch import estimators, models, nn  # noqa: E402
from curvature_tpu_torch import parallel  # noqa: E402

#: damping of the INF, predictive and hyper cases
ADD, MULTIPLY = 1.0, 10.0


# -- models and inputs (numpy-seeded, identical in every process) -------------
def mlp():
    """JAX ``models.mlp([16], 4)`` on 8 features, weights from seed 0."""
    m = models.mlp((16,), 4, in_features=8, device="cpu")
    return models.load_jax_variables(m, models.seeded_variables(m, 0))


def mlp_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 32))
    labels4 = rng.integers(0, 4, size=(4, 32))
    y = rng.integers(0, 4, size=32)
    return x, labels, labels4, y


def _named_bn(features, name):
    bn = nn.BatchNorm(features)
    bn.name = name
    return bn


def bn_net():
    """conv -> BN -> ReLU -> strided conv -> BN -> ReLU -> fc on 16x16x3:
    a narrow BatchNorm network, whose train-mode statistics couple the
    examples of a batch."""
    m = nn.Sequential([
        nn.Conv(3, 8, 3, padding=1, name="c1"), _named_bn(8, "bn1"),
        nn.ReLU(), nn.Conv(8, 8, 3, 2, padding=1, name="c2"),
        _named_bn(8, "bn2"), nn.ReLU(), nn.Flatten(),
        nn.Dense(8 * 8 * 8, 10, name="fc")])
    return models.load_jax_variables(m, models.seeded_variables(m, 1))


def bn_inputs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)   # NHWC
    labels = rng.integers(0, 10, size=(2, 16))
    return x, labels


def grouped_net():
    """JAX tests' ``_GroupedNet``: conv -> grouped conv g=4 -> depthwise
    s2 -> fc on 6x6x3."""
    m = nn.Sequential([
        nn.Conv(3, 8, 3, padding=1, name="c1"), nn.ReLU(),
        nn.Conv(8, 8, 3, padding=1, groups=4, name="c2"), nn.ReLU(),
        nn.Conv(8, 8, 3, 2, padding=1, groups=8, name="dw"), nn.ReLU(),
        nn.Flatten(), nn.Dense(72, 5, name="fc")])
    return models.load_jax_variables(m, models.seeded_variables(m, 2))


def grouped_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 6, 6, 3)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 16))
    return x, labels


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def flat(prefix, tree):
    """A nested dict of tensors as ``{prefix/key/...: array}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(f"{prefix}/{k}", v))
        return out
    return {prefix: np.asarray(torch.as_tensor(tree).detach().cpu())}


def run_cases(inputs, mesh4=None, mesh_sd=None, mesh_s4=None):
    """Every case of tests/test_torch_parallel.py: with meshes the
    distributed run, without them one process. ``inputs()`` returns what
    the EFB and INF cases take from JAX (:func:`wait_inputs`). Returns
    ``{key: array}``."""
    out = {}
    x, labels, labels4, y = mlp_inputs()
    xt = torch.from_numpy(x)
    kw = {"use_kernels": False}

    def est(cls, model, mesh, *args, **kwargs):
        e = cls(model, *args, **kwargs)
        return e.use_mesh(mesh) if mesh is not None else e

    m = mlp()
    kfac = est(estimators.KFAC, m, mesh4, **kw)
    kfac.update(xt, labels=labels)
    out.update(flat("kfac", kfac.state))
    diag = est(estimators.Diagonal, m, mesh4)
    diag.update(xt, labels=labels)
    out.update(flat("diag", diag.state))
    block = est(estimators.BlockDiagonal, m, mesh4)
    block.update(xt, labels=labels)
    out.update(flat("block", block.state))
    fused = est(estimators.KFAC, m, mesh4, fused_g=True, stack_grams=True,
                **kw)
    fused.update(xt, labels=labels)
    out.update(flat("kfac_fused", fused.state))
    # sample + data: 4 draws over 2 sample ranks, the batch over 2
    sd = est(estimators.KFAC, m, mesh_sd, **kw)
    sd.update(xt, labels=labels4)
    out.update(flat("kfac_sd", sd.state))
    dsd = est(estimators.Diagonal, m, mesh_sd)
    dsd.update(xt, labels=labels4)
    out.update(flat("diag_sd", dsd.state))
    # labels drawn inside the update: one process's draws from the whole
    # batch's logits, each rank keeping its (sample, data) block
    drawn = est(estimators.KFAC, m, mesh_sd, **kw)
    drawn.update(xt, generator=torch.Generator().manual_seed(7),
                 num_samples=4)
    out.update(flat("drawn_kfac_sd", drawn.state))
    # EFB from JAX's one-process KFAC factors and its eigenvectors (eigh
    # picks its basis freely inside near-degenerate eigenspaces): the
    # eigenbasis is the same on every rank and in JAX, the comparison
    # tests the sharded update itself
    given = inputs()
    efb = est(estimators.EFB, m, mesh4, given["kfac"])
    efb.eigvecs = given["eigvecs"]
    efb.update(xt, labels=labels)
    efb.update(xt + 1, labels=labels[::-1].copy())
    out.update(flat("efb", efb.state))
    out.update(flat("efb_diags", efb.diags))
    # INF assembled, inverted and sampled from the meshed factors, with
    # JAX's standard normals of key 5
    inf = estimators.INF(m, diag.state, kfac.state, efb.state,
                         eigvecs=efb.eigvecs)
    inf.update(rank=10, bucket=4)
    inf.invert(ADD, MULTIPLY)
    out.update(flat("inf_sample", inf.sample(noise=given["noise"])))
    out["kfac_logdet"] = np.asarray(kfac.logdet_precision(0.5, 2.0))
    # ragged: 30 rows over 4 data ranks run whole on every rank
    for name, cls, extra in (("ragged_kfac", estimators.KFAC, kw),
                             ("ragged_diag", estimators.Diagonal, {})):
        e = est(cls, m, mesh4, **extra)
        e.update(xt[:30], labels=labels[:, :30])
        out.update(flat(name, e.state))
    # grouped and depthwise convs
    gx, glabels = grouped_inputs()
    g = est(estimators.KFAC, grouped_net(), mesh4, **kw)
    g.update(nchw(gx), labels=glabels)
    out.update(flat("grouped", g.state))
    # train-mode BatchNorm: the capture normalizes over the whole batch
    bx, blabels = bn_inputs()
    bnm = bn_net()
    for name, cls, extra in (("bn_kfac", estimators.KFAC, kw),
                             ("bn_diag", estimators.Diagonal, {})):
        e = est(cls, bnm, mesh4, **extra)
        e.update(nchw(bx), labels=blabels)
        out.update(flat(name, e.state))
    e = est(estimators.Diagonal, bnm, mesh4)
    e.update(nchw(bx), generator=torch.Generator().manual_seed(8),
             num_samples=2)
    out.update(flat("drawn_bn_diag", e.state))
    out.update(_eval_cases(m, kfac, x, y, mesh4))
    out.update(_training_cases(mesh4))
    out.update(_swag_case(m, x, mesh_s4))
    return out


def _eval_cases(m, kfac, x, y, mesh):
    from curvature_tpu_torch.eval import (
        eval_bnn, eval_bnn_closed_form, eval_bnn_linearized, eval_nn)
    from curvature_tpu_torch.pipelines.hyper import make_batched_evaluator
    from curvature_tpu_torch.pipelines.loss_landscape import (
        evaluate_points, random_direction)
    from curvature_tpu_torch.utils.config import Config
    out = {}
    batches = [(torch.from_numpy(x), y), (torch.from_numpy(x) + 1, y)]
    kfac.invert(ADD, MULTIPLY)
    ens = kfac.ensemble_params(4, generator=torch.Generator().manual_seed(0))
    out["eval_nn"] = eval_nn(m, batches, mesh=mesh)[0]
    out["eval_bnn"] = eval_bnn(m, kfac, batches, 4, ensemble_params=ens,
                               mesh=mesh)[0]
    out["closed_form"] = eval_bnn_closed_form(
        m, kfac, batches, 4, ensemble_params=ens, method="probit",
        mesh=mesh)[0]
    out["linearized"] = eval_bnn_linearized(
        m, kfac, batches, 4, ensemble_params=ens, method="mc", mesh=mesh)[0]
    cfg = Config(samples=3, pre_scale=1)
    evaluate = make_batched_evaluator(cfg, m, kfac, batches, mesh=mesh)
    rows = evaluate([1.0, 10.0, 0.1], [1.0, 5.0, 50.0],
                    torch.Generator().manual_seed(6))
    out["hyper_cost"] = np.asarray([r["cost"] for r in rows])
    direction = random_direction(
        {k: p.detach() for k, p in m.named_parameters()},
        torch.Generator().manual_seed(5))
    coords = np.linspace(-0.5, 0.5, 5)[:, None]
    yt = torch.from_numpy(y).long()
    loss, acc = evaluate_points(m, [direction], coords,
                                [(torch.from_numpy(x), yt)], chunk=4,
                                mesh=mesh)
    out["landscape_loss"], out["landscape_acc"] = loss, acc
    return out


def _training_cases(mesh):
    """One SGD step (momentum 0.9) of the BatchNorm net and the MLP on
    the global batch, a ragged batch, and two KFAC-optimizer steps."""
    from curvature_tpu_torch import optim
    from curvature_tpu_torch.pipelines.training import make_train_step
    out = {}
    bx, blabels = bn_inputs()
    x, _, _, y = mlp_inputs()
    for name, model, xs, ys in (
            ("train_bn", bn_net(), nchw(bx), blabels[0]),
            ("train_mlp", mlp(), torch.from_numpy(x), y)):
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        step = make_train_step(model, opt, mesh)
        model.train()
        yt = torch.from_numpy(ys).long()
        out[f"{name}/loss"] = np.asarray([float(step(xs, yt))
                                          for _ in range(2)])
        out.update(flat(name, {k: v.detach() for k, v in
                               model.state_dict().items()}))
        if name == "train_mlp":
            out[f"{name}/ragged_loss"] = np.asarray(
                float(step(xs[:30], yt[:30])))
    model = bn_net()
    opt = torch.optim.SGD(model.parameters(), lr=0.05)
    est = estimators.KFAC(model, use_kernels=False)
    kstep, kinit = optim.make_kfac_train_step(model, est, opt, damping=0.1,
                                              mc_fisher=False, mesh=mesh)
    xs, yt = nchw(bx), torch.from_numpy(blabels[0]).long()
    factors, inv = kinit(xs, yt)
    count, losses = 0, []
    for _ in range(2):
        factors, inv, count, loss = kstep(factors, inv, count, xs, yt)
        losses.append(float(loss))
    out["kfac_step/loss"] = np.asarray(losses)
    out.update(flat("kfac_step", {k: v.detach() for k, v in
                                  model.state_dict().items()}))
    return out


def _swag_case(m, x, mesh):
    """SWAG's ensemble on the predictor's sample axis."""
    from curvature_tpu_torch.estimators.swag import SWAG
    from curvature_tpu_torch.eval import BayesianPredictor
    sw = SWAG(m)
    base = {k: p.detach() for k, p in m.named_parameters()}
    for i in range(3):
        sw.collect({k: v + 0.01 * i for k, v in base.items()})
    sw.invert(multiply=1.0)
    pred = BayesianPredictor(m, sw, samples=8,
                             generator=torch.Generator().manual_seed(0),
                             mesh=mesh)
    return {"swag_mean": pred(torch.from_numpy(x[:8])).mean}


#: the file of JAX's inputs to the EFB and INF cases, beside the ranks'
#: results
INPUTS = "jax_inputs.npz"


def unflat(arrays):
    """``{group/layer[/leaf]: array}`` as ``{group: {layer: tensor or
    {leaf: tensor}}}`` (:func:`flat`'s inverse for one or two levels)."""
    out = {}
    for key, v in arrays.items():
        group, rest = key.split("/", 1)
        t = torch.from_numpy(np.array(v))
        if group == "noise":
            out.setdefault(group, {})[rest] = t
        else:
            layer, leaf = rest.rsplit("/", 1)
            out.setdefault(group, {}).setdefault(layer, {})[leaf] = t
    return out


def save_inputs(out_dir: str, arrays):
    """Write :data:`INPUTS` whole (a rank never reads half a file)."""
    tmp = os.path.join(out_dir, "jax_inputs.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(out_dir, INPUTS))


def wait_inputs(out_dir: str, timeout: float = 200.0):
    """:data:`INPUTS` once the test has written it, :func:`unflat`-ed."""
    import time
    path = os.path.join(out_dir, INPUTS)
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)
    with np.load(path) as f:
        return unflat(dict(f))


# -- launching ----------------------------------------------------------------
def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(job: str, world: int, out_dir: str, timeout: float = 240.0):
    """Run ``job`` on ``world`` ranks with ``torch.distributed.run``'s
    environment; returns each rank's results. A rank that fails, or a job
    that outlives ``timeout`` seconds, fails the caller with every rank's
    output (the hung ranks are killed)."""
    return finish(start(job, world, out_dir), job, out_dir, timeout)


def start(job: str, world: int, out_dir: str):
    """Start ``job``'s ranks; returns their processes (:func:`finish`)."""
    import subprocess
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, out_dir],
        cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]


def finish(procs, job: str, out_dir: str, timeout: float = 240.0):
    """Wait for the ranks of :func:`start`; as :func:`launch`."""
    import subprocess
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"job {job!r} hung past {timeout} s:\n"
                             + "\n".join(outputs))
    for r, (p, o) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} of job {job!r} failed:\n{o}"
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


# -- jobs ---------------------------------------------------------------------
def job_sharding(out_dir):
    return run_cases(lambda: wait_inputs(out_dir),
                     parallel.make_mesh({"data": 4}),
                     parallel.make_mesh({"sample": 2, "data": 2}),
                     parallel.make_mesh({"sample": 4}))


def dist_inputs():
    """JAX tests/distributed_worker.py's inputs: 16 rows of 5 features,
    [2, 16] labels, an MLP [7] -> 4."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 16))
    m = models.mlp((7,), 4, in_features=5, device="cpu")
    return x, labels, models.load_jax_variables(
        m, models.seeded_variables(m, 0))


def job_distributed(out_dir):
    """initialize (already up: a no-op), global_mesh,
    process_batch_slice and host_local_to_global, then one Diagonal
    update on the global batch split over the ranks."""
    from curvature_tpu_torch.parallel import distributed as D
    assert D.initialize() == "gloo"
    world = torch.distributed.get_world_size()
    mesh = parallel.global_mesh()
    assert mesh.shape == {"data": world}, mesh
    x_full, labels_full, m = dist_inputs()
    sl = parallel.process_batch_slice(16)
    shard = parallel.host_local_to_global(x_full[sl], mesh)
    assert torch.equal(shard, torch.from_numpy(x_full[sl]))
    xg = parallel.host_local_to_global(x_full[sl], mesh, gather=True)
    lg = parallel.host_local_to_global(labels_full[:, sl], mesh,
                                       spec=(None, "data"), gather=True)
    assert xg.shape == (16, 5) and lg.shape == (2, 16)
    est = estimators.Diagonal(m).use_mesh(mesh)
    est.update(xg, labels=lg)
    out = flat("diag", est.state)
    out.update(slice=np.asarray([sl.start, sl.stop]), x=xg.numpy(),
               labels=lg.numpy(), world=np.asarray(world))
    return out


#: LeNet-5 on the bundled digits: 4 batches of 128, one update_batches
#: chunk of 3 and a ragged tail of 1
CLI_ARGV = ["--platform", "cpu", "--model", "lenet5", "--data", "mnist",
            "--batch_size", "128", "--scan_chunk", "3", "--mc_samples", "2",
            "--samples", "3", "--seed", "0"]


def run_cli(root: str, mesh_flags=()):
    """The CLI chain of tests/test_torch_parallel_cli.py under ``root``:
    factors diag/kfac/efb/inf, evaluate, hyper, training and
    loss_landscape, with ``mesh_flags`` (``--mesh data:2``) on each and
    ``--parallel`` on the last two. EFB reads ``<root>/factors/
    lenet5_mnist_kfac.npz``; the caller may replace it first (the mesh run
    reads the single run's, as JAX's fixture does). Returns the results
    the functions return."""
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.pipelines import (
        evaluate, factors, hyper, loss_landscape, training)
    base = CLI_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                       "--results_dir", root] + list(mesh_flags)
    out = {}
    for name in ("diag", "kfac"):
        factors.main(base + ["--estimator", name])
    yield "kfac_written"
    factors.main(base + ["--estimator", "efb"])
    factors.main(base + ["--estimator", "inf", "--rank", "20"])
    out["eval_predictions"] = evaluate.main(base)[0]
    res = hyper.main(base + ["--estimator", "kfac", "--optimizer", "random",
                             "--calls", "3"])
    out["hyper_cost"] = np.asarray(res["stats"]["cost"])
    out["hyper_best_x"] = np.asarray(res["best_x"])
    par = ["--parallel"] if mesh_flags else []
    base = [a for a in base if a not in mesh_flags]
    _, hist = training.main(base + par + ["--epochs", "1", "--lr", "1e-2"])
    out["train_loss"] = np.asarray(hist["loss"])
    res = loss_landscape.main(base + par + ["--loss1d"])
    out["loss1d_train_loss"] = np.asarray(res["train_loss"])
    out["loss1d_val_loss"] = np.asarray(res["val_loss"])
    yield out


#: the scanned GPT-2 tiny whose ``factors`` run splits over ``model``
LM_ARGV = ["--platform", "cpu", "--model", "gpt2_tiny", "--data", "tokens",
           "--seq_len", "16", "--batch_size", "32", "--scan_blocks",
           "--estimator", "kfac", "--mc_samples", "1"]


def run_lm_cli(root: str, mesh_flags=()):
    """``factors`` on the scanned GPT-2 tiny under ``root``, with
    ``mesh_flags`` (``--mesh model:2,data:1``)."""
    from curvature_tpu_torch.pipelines import factors
    factors.main(LM_ARGV + ["--root_dir", root, "--results_dir", root]
                 + list(mesh_flags))


#: written beside the single run's root once its KFAC file is whole
KFAC_DONE = "single_kfac.done"


def job_cli(out_dir):
    """The CLI chain with ``--mesh data:2`` under ``<out_dir>/workspace``, EFB
    fed the single run's KFAC file (``<out_dir>/../single``; the test runs
    that chain meanwhile and writes ``<out_dir>/../KFAC_DONE`` after its
    KFAC step)."""
    import shutil
    import time
    root = os.path.join(out_dir, "workspace")
    base = os.path.dirname(out_dir)
    single = os.path.join(base, "single")
    world = torch.distributed.get_world_size()
    chain = run_cli(root, ["--mesh", f"data:{world}"])
    next(chain)
    mine = os.path.join(root, "factors", "lenet5_mnist_kfac.npz")
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(base, KFAC_DONE)):
        if time.perf_counter() - t0 > 200:
            raise TimeoutError("the single run's KFAC file never came")
        time.sleep(0.05)
    if torch.distributed.get_rank() == 0:
        shutil.copy(mine, mine.replace(".npz", "_meshorig.npz"))
        shutil.copy(os.path.join(single, "factors",
                                 "lenet5_mnist_kfac.npz"), mine)
    torch.distributed.barrier()
    out = next(chain)
    run_lm_cli(os.path.join(out_dir, "lm"),
               ["--mesh", f"model:{world},data:1"])
    return out


# -- the model, tensor, seq and expert axes (tests/test_torch_model_parallel.py)
def scan_vit():
    """JAX tests/test_model_parallel.py's ``scan_vit`` (16x16 images,
    patch 8, dim 16, depth 4, 2 heads, mlp 32, 5 classes) with seeded
    weights."""
    m = vit_plain()
    return models.load_jax_variables(m, models.seeded_variables(m, 3))


def vit_plain():
    """:func:`scan_vit`'s model before its weights are loaded."""
    from curvature_tpu_torch.models.vit import vit
    return vit(image_size=16, patch_size=8, dim=16, depth=4, heads=2,
               mlp_dim=32, num_classes=5, scan_blocks=True, device="cpu")


def vit_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)   # NHWC
    labels = rng.integers(0, 5, size=(2, 8))
    return x, labels


def wide_mlp():
    """JAX's ``wide_mlp``: ``models.mlp([32], 4)`` on 8 features."""
    m = models.mlp((32,), 4, in_features=8, device="cpu")
    return models.load_jax_variables(m, models.seeded_variables(m, 4))


def wide_inputs():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 16))
    return x, labels


def tiny_gpt():
    """JAX's seq case: ``gpt2_custom(vocab=32, dim=16, depth=2, heads=2,
    max_len=8)``."""
    m = models.gpt2_custom(32, 16, 2, 2, 8, device="cpu")
    return models.load_jax_variables(m, models.seeded_variables(m, 5))


def gpt_inputs():
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 32, size=(4, 8))
    labels = rng.integers(0, 32, size=(2, 4, 8))
    return toks, labels


def lenet():
    m = models.lenet5(num_classes=10, image_size=32, device="cpu")
    return models.load_jax_variables(m, models.seeded_variables(m, 6))


def lenet_inputs():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 32, 32, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=(2, 4))
    return x, labels


def moe_net(experts=4):
    """tests/test_torch_moe.py's net: inp -> relu -> MoE -> head."""
    m = nn.Sequential([
        nn.Dense(8, 16, name="inp"), nn.ReLU(),
        nn.MoE(16, 16, experts, name="moe"), nn.Dense(16, 5, name="head")])
    return models.load_jax_variables(m, models.seeded_variables(m, 0))


def moe_inputs(batch=16):
    """test_torch_moe's ``_build(experts=4)`` inputs (seed 0 + 1)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((batch, 8)).astype(np.float32)
    labels = rng.integers(0, 5, (2, batch)).astype(np.int32)
    return x, labels


def normals(shapes, seed):
    """Seeded standard normals for ``noise_shapes()`` (nested dicts)."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))
    return {n: draw(s) for n, s in shapes.items()}


def gather_sample(est, sample):
    """A sample's blocks gathered into the whole draw (rows of a
    column-parallel layer, the depth or experts of a stacked one)."""
    from curvature_tpu_torch.parallel.mesh import all_gather
    if est.mesh is None:
        return sample
    ax, out = est._mesh_axes, {}
    for name, t in sample.items():
        m = est.metas[name]
        if m.stacked and t.shape[0] != m.stacked:
            t = all_gather(t, est.mesh.group(
                ax["expert"] if m.moe else ax["model"]), 0)
        if t.shape[-2] != m.out_features:
            t = all_gather(t, est.mesh.group(ax["tensor"]), -2)
        out[name] = t
    return out


def shapes(prefix, tree):
    """Each leaf's shape, as ``{prefix/key/...: shape}``."""
    return {k: np.asarray(v.shape) for k, v in flat(prefix, tree).items()}


def run_mesh_axes(out_dir=None, meshes=None):
    """Every case of tests/test_torch_model_parallel.py: with ``meshes``
    (``{case: Mesh}``) the distributed run, each rank returning its
    gathered states and draws and its blocks' shapes (``shape/...``);
    without them one process. Returns ``{key: array}``."""
    from curvature_tpu_torch.nn.placement import gather_blocks
    from curvature_tpu_torch.utils import checkpoint
    meshes = meshes or {}
    out = {}
    kw = {"use_kernels": False}

    def meshed(est, case, **opts):
        mesh = meshes.get(case)
        return est.use_mesh(mesh, **opts) if mesh is not None else est

    def record(prefix, est, attr="state"):
        out.update(flat(prefix, est.gathered_state(attr)))
        if est.mesh is not None:
            out.update(shapes(f"shape/{prefix}", getattr(est, attr)))

    def lifecycle(prefix, est, seed):
        est.invert(add=1.0, multiply=10.0)
        draw = est.sample(noise=normals(est.noise_shapes(), seed))
        out.update(flat(f"{prefix}_sample", gather_sample(est, draw)))

    # depth-sharded ScanBlocks ViT: KFAC, EFB's carry, the ensemble,
    # update_batches and the sharded checkpoint
    x, labels = vit_inputs()
    xt = nchw(x)
    kfac = meshed(estimators.KFAC(scan_vit(), **kw), "model")
    kfac.update(xt, labels=labels)
    record("vit_kfac", kfac)
    lifecycle("vit_kfac", kfac, 7)
    ens = kfac.ensemble_params(2, noise=[normals(kfac.noise_shapes(), s)
                                         for s in (8, 9)])
    for i, p in enumerate(ens):
        p = gather_blocks(kfac.model, p)
        for key in ("encoder.layers.mlp.0.weight", "heads.head.weight",
                    "encoder.layers.self_attention.in_proj.bias"):
            out[f"vit_ens{i}/{key}"] = p[key].detach().numpy()
    one = estimators.KFAC(scan_vit(), **kw)
    one.update(xt, labels=labels)
    efb = meshed(estimators.EFB(scan_vit(), one.state), "model")
    efb.update(xt, labels=labels)
    record("vit_efb", efb)
    record("vit_efb_diags", efb, "diags")
    efb.invert(add=1.0, multiply=10.0)
    draw = efb.sample(noise=normals(efb.noise_shapes(), 10))
    out.update(flat("vit_efb_sample", gather_sample(efb, draw)))
    diag = meshed(estimators.Diagonal(scan_vit()), "model")
    diag.update(xt, labels=labels)
    record("vit_diag", diag)
    # BlockDiagonal and INF take the base stacked rule
    block = meshed(estimators.BlockDiagonal(
        scan_vit(), layer_filter="encoder.layers.mlp.3"), "model")
    block.update(xt, labels=labels)
    record("vit_block", block)
    efb1 = estimators.EFB(scan_vit(), one.state)
    efb1.update(xt, labels=labels)
    inf = meshed(estimators.INF(scan_vit(), efb1.diags, one.state,
                                efb1.state, eigvecs=efb1.eigvecs), "model")
    inf.update(rank=8, bucket=4)
    record("vit_inf", inf)
    lifecycle("vit_inf", inf, 15)
    if kfac.mesh is not None:
        # JAX weights loaded into a placed model land as its blocks
        before = {k: v.clone() for k, v in kfac.model.state_dict().items()}
        models.load_jax_variables(kfac.model, models.seeded_variables(
            vit_plain(), 3))
        out["vit_load_blocks_equal"] = np.asarray(all(
            torch.equal(v, before[k])
            for k, v in kfac.model.state_dict().items()))
    batches = meshed(estimators.KFAC(scan_vit(), **kw), "model")
    batches.update_batches(torch.stack([xt, xt + 0.5]),
                           generator=torch.Generator().manual_seed(10),
                           num_samples=2)
    record("vit_batches", batches)
    if kfac.mesh is not None:
        path = os.path.join(out_dir, "ckpt")
        checkpoint.save_pytree_sharded(path, kfac.state, kfac.state_plan(),
                                       kfac.mesh)
        back = checkpoint.load_pytree_sharded(path, kfac.mesh)
        same = all(np.array_equal(v, back_v) for v, back_v in zip(
            flat("s", kfac.state).values(), flat("s", back).values()))
        out["ckpt_blocks_equal"] = np.asarray(same)

    # column-parallel MLP: KFAC and Diagonal
    x, labels = wide_inputs()
    xt = torch.from_numpy(x)
    for prefix, cls, opts in (("mlp_kfac", estimators.KFAC, kw),
                              ("mlp_fused", estimators.KFAC,
                               dict(kw, fused_g=True, stack_grams=True)),
                              ("mlp_diag", estimators.Diagonal, {})):
        est = meshed(cls(wide_mlp(), **opts), "tensor", tensor_min_out=4)
        est.update(xt, labels=labels)
        record(prefix, est)
        lifecycle(prefix, est, 11)

    # model:2 x tensor:2 on the ViT
    x, labels = vit_inputs()
    both = meshed(estimators.KFAC(scan_vit(), **kw), "model_tensor",
                  tensor_min_out=16)
    both.update(nchw(x), labels=labels)
    record("vit_both", both)
    lifecycle("vit_both", both, 12)

    # seq on the LM: given labels, drawn labels, a ragged token count
    toks, labels = gpt_inputs()
    tt = torch.from_numpy(toks)
    given = meshed(estimators.KFAC(tiny_gpt(), loss="lm", **kw), "seq")
    given.update(tt, labels=labels)
    record("gpt_given", given)
    lifecycle("gpt_given", given, 13)
    drawn = meshed(estimators.KFAC(tiny_gpt(), loss="lm", **kw), "seq")
    drawn.update(tt, generator=torch.Generator().manual_seed(3),
                 num_samples=2)
    record("gpt_drawn", drawn)
    ragged = meshed(estimators.KFAC(tiny_gpt(), loss="lm", **kw), "seq")
    if ragged.mesh is not None:
        out["gpt_ragged_dispatch"] = np.asarray(
            ragged._dispatch(4, 2, tokens=7) == "noseq")
    ragged.update(tt[:, :7], labels=labels[:, :, :7])
    record("gpt_ragged", ragged)
    gdiag = meshed(estimators.Diagonal(tiny_gpt(), loss="lm"), "seq")
    gdiag.update(tt, labels=labels)
    record("gpt_diag", gdiag)
    sub = meshed(estimators.Subspace(tiny_gpt(), rank=4, loss="lm"), "seq")
    sub.update(tt, labels=labels)
    record("gpt_subspace", sub)

    # the Subspace on sample:2,data:2: draws split nothing, rows do
    x, labels = wide_inputs()
    sub = meshed(estimators.Subspace(wide_mlp(), rank=4), "sample")
    sub.update(torch.from_numpy(x), labels=labels)
    record("mlp_subspace", sub)

    # seq on LeNet-5: the image rows
    x, labels = lenet_inputs()
    img = meshed(estimators.KFAC(lenet(), **kw), "seq")
    img.update(nchw(x), labels=labels)
    record("lenet_kfac", img)

    return out


def run_expert(meshes=None):
    """tests/test_torch_moe.py's expert-parallel case: KFAC on the MoE net
    on ``meshes["expert"]`` (or one process)."""
    out = {}
    x, labels = moe_inputs()
    moe = estimators.KFAC(moe_net(), use_kernels=False)
    if meshes:
        moe.use_mesh(meshes["expert"])
        out.update(shapes("shape/moe_kfac", moe.state))
    moe.update(torch.from_numpy(x), labels=labels)
    out.update(flat("moe_kfac", moe.gathered_state()))
    moe.invert(add=1.0, multiply=10.0)
    draw = moe.sample(noise=normals(moe.noise_shapes(), 14))
    out.update(flat("moe_kfac_sample", gather_sample(moe, draw)))
    return out


#: the meshes of the mesh-axes job, on 4 ranks
MESH_AXES = {"model": {"model": 2, "data": 2},
             "tensor": {"tensor": 2, "data": 2},
             "model_tensor": {"model": 2, "tensor": 2, "data": 1},
             "seq": {"seq": 2, "data": 2},
             "sample": {"sample": 2, "data": 2}}


def job_mesh_axes(out_dir):
    return run_mesh_axes(out_dir, {case: parallel.make_mesh(axes)
                                   for case, axes in MESH_AXES.items()})


def job_expert(out_dir):
    return run_expert({"expert": parallel.make_mesh({"expert": 2,
                                                     "data": 2})})


JOBS = {"sharding": job_sharding, "distributed": job_distributed,
        "cli": job_cli, "mesh_axes": job_mesh_axes, "expert": job_expert}


def main():
    job, out_dir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    backend = parallel.initialize(device="cpu")
    assert backend == "gloo", backend
    results = JOBS[job](out_dir)
    rank = torch.distributed.get_rank()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in results.items()})
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
