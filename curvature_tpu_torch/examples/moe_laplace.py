"""Laplace over a Switch-style mixture-of-experts GPT-2, in one script.

Port of ``examples/moe_laplace.py``:

  1. a Switch GPT-2 (top-1-routed two-layer experts, ``nn.MoE``) with
     seeded weights on a synthetic token stream (numpy seed 0);
  2. KFAC per-token Fisher with per-expert Kronecker factors ([E, F, F] A
     and [E, O, O] G per expert layer), through the estimators' stacked
     branches unchanged;
  3. the experts' routed shares at ``h.0``, read off the captured
     mask-routed activation stream;
  4. damping tuned by gradient ascent on the Laplace evidence;
  5. a per-token Bayesian predictive against the MAP one;
  6. the same update on an ``expert:2`` mesh (expert parallelism): the
     script starts two ranks of itself (gloo, on the script's device),
     each holding half of the experts' weights and factors, and holds the
     gathered ``h.0.moe.fc1`` A factor to this process's (rtol 1e-5, atol
     1e-6, JAX :93-108).

    python -m curvature_tpu_torch.examples.moe_laplace [--platform cpu]
"""
import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.func import functional_call

from curvature_tpu_torch import estimators, models, parallel
from curvature_tpu_torch.eval.marglik import marglik_gradient_tune
from curvature_tpu_torch.nn import Context
from curvature_tpu_torch.utils.device import resolve_device

VOCAB = 64
BATCH = 8
#: the expert-sharded step's layer, ranks and bar (JAX :103-105)
EP_LAYER, EP_RANKS, EP_RTOL, EP_ATOL = "h.0.moe.fc1", 2, 1e-5, 1e-6


def build(args, device):
    """The seeded Switch GPT-2 and the token batches [batches, B, T]."""
    model = models.gpt2_moe_tiny(num_classes=VOCAB, experts=args.experts,
                                 max_len=args.seq_len, device=device)
    models.load_jax_variables(model, models.seeded_variables(model, 1))
    model.eval()
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(
        0, VOCAB, (args.batches, BATCH, args.seq_len)), device=device)
    return model, toks


def expert_update(model, toks, mesh=None):
    """KFAC on the first batch with its tokens as labels; on ``mesh`` its
    expert blocks. Returns the estimator."""
    est = estimators.KFAC(model, loss="lm")
    if mesh is not None:
        est.use_mesh(mesh)
    est.update(toks[0], labels=toks[0][None])
    return est


def expert_rank(args, device, out_dir):
    """One rank of step 6 (``--expert_rank``): writes its gathered A
    factor and the shape of its block."""
    parallel.initialize(device="cpu" if device.type == "cpu" else None)
    mesh = parallel.make_mesh({"expert": EP_RANKS, "data": 1})
    model, toks = build(args, device)
    est = expert_update(model, toks, mesh)
    block = tuple(est.state[EP_LAYER]["a"].shape)
    a = est.gathered_state()[EP_LAYER]["a"]
    rank = torch.distributed.get_rank()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), a=a.cpu().numpy(),
             block=np.asarray(block))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def expert_parallel(args, device, single_a):
    """Step 6: two ranks of this script on ``expert:2``; returns the
    largest difference of their gathered A factor from ``single_a``,
    relative to its largest entry, and the ranks' block shape. A rank
    that fails, or a factor off the bar, raises."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(EP_RANKS),
                   LOCAL_WORLD_SIZE=str(EP_RANKS))
        argv = [sys.executable, "-m", __spec__.name if __spec__ else
                "curvature_tpu_torch.examples.moe_laplace",
                "--expert_rank", out, "--experts", str(args.experts),
                "--seq_len", str(args.seq_len), "--batches",
                str(args.batches)] + (["--platform", "cpu"]
                                      if device.type == "cpu" else [])
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        procs = [subprocess.Popen(argv, cwd=root, env=dict(
            env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(EP_RANKS)]
        logs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"expert rank {r} failed:\n{log}")
        got = [np.load(os.path.join(out, f"rank{r}.npz"))
               for r in range(EP_RANKS)]
    want = single_a.cpu().numpy()
    for g in got:
        np.testing.assert_allclose(g["a"], want, rtol=EP_RTOL,
                                   atol=EP_ATOL)
    err = max(float(np.abs(g["a"] - want).max()) for g in got) \
        / float(np.abs(want).max())
    return err, tuple(int(v) for v in got[0]["block"])


def routed_shares(model, tokens, layer="h.0.moe.fc1"):
    """Each expert's share of the tokens, from the routes the expert
    layer ``layer`` records (its rows per expert over the tokens)."""
    ctx = Context(track=[layer], probes=False)
    with torch.no_grad():
        model(tokens, ctx)
    r = ctx.routes[layer]
    counts = np.diff(np.asarray(r.offsets))
    return counts / r.num_tokens


@torch.no_grad()
def token_nll(model, tokens, params=None):
    """Per-token next-token probabilities of ``tokens[:, 1:]`` under the
    model (or under ``params``), [B, T-1]."""
    logits = (model(tokens) if params is None
              else functional_call(model, params, (tokens,)))
    p = torch.softmax(logits[:, :-1].float(), -1)
    return p.gather(-1, tokens[:, 1:, None].long())[..., 0]


def main(argv=None):
    """Returns {"a_shape", "shares", "log_marglik", "map_nll",
    "bnn_nll"}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="")
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--seq_len", type=int, default=32)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--expert_rank", metavar="DIR", default="",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    if args.expert_rank:
        return expert_rank(args, device, args.expert_rank)

    model, toks = build(args, device)
    gen = torch.Generator(device=device).manual_seed(2)

    # -- per-expert factors ---------------------------------------------------
    est = estimators.KFAC(model, loss="lm")
    est.update_batches(toks, generator=gen, num_samples=2)
    a = est.state["h.0.moe.fc1"]["a"]
    print(f"h.0.moe.fc1 per-expert A factors: {tuple(a.shape)} "
          f"(E={args.experts} experts)")

    # -- routing utilization from the captured masked stream -----------------
    shares = routed_shares(model, toks[0])
    print("h.0 expert utilization:",
          " ".join(f"e{i}={f:.2f}" for i, f in enumerate(shares)),
          f"(balanced = {1 / args.experts:.2f})")

    # -- evidence-tuned damping, posterior predictive ------------------------
    tuned = marglik_gradient_tune(est, 10.0, steps=60)
    est.invert(add=tuned["norms"], multiply=tuned["scales"])
    print(f"evidence-tuned damping add={tuned['norms'][0]:.4f} "
          f"multiply={tuned['scales'][0]:.4f} "
          f"(log marglik {tuned['log_marglik']:.1f})")

    x = toks[0]
    map_nll = -float(torch.log(token_nll(model, x)).mean())
    acc = torch.zeros(x.shape[0], x.shape[1] - 1, dtype=torch.float64,
                      device=device)
    for _ in range(args.samples):
        acc += token_nll(model, x, est.posterior_params(generator=gen))
    bnn_nll = -float(torch.log(acc / args.samples + 1e-12).mean())
    print(f"per-token NLL: MAP {map_nll:.4f} | "
          f"BNN({args.samples} samples) {bnn_nll:.4f}")

    # -- expert parallelism ----------------------------------------------------
    single_a = expert_update(build(args, device)[0], toks).state[
        EP_LAYER]["a"]
    ep_err, block = expert_parallel(args, device, single_a)
    print(f"expert-sharded factors on expert:{EP_RANKS}: {EP_LAYER} A "
          f"block {block} per rank, gathered {tuple(single_a.shape)} "
          f"{ep_err:.2e} of max off one process (bar rtol {EP_RTOL}, atol "
          f"{EP_ATOL})")
    print("done")
    return {"a_shape": tuple(a.shape), "shares": shares,
            "log_marglik": tuned["log_marglik"], "map_nll": map_nll,
            "bnn_nll": bnn_nll, "ep_err": ep_err, "ep_block": block}


if __name__ == "__main__":
    main()
