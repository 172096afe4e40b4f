"""Laplace over a Switch-style mixture-of-experts GPT-2, in one script.

Port of ``examples/moe_laplace.py``, its steps 1-5:

  1. a Switch GPT-2 (top-1-routed two-layer experts, ``nn.MoE``) with
     seeded weights on a synthetic token stream (numpy seed 0);
  2. KFAC per-token Fisher with per-expert Kronecker factors ([E, F, F] A
     and [E, O, O] G per expert layer), through the estimators' stacked
     branches unchanged;
  3. the experts' routed shares at ``h.0``, read off the captured
     mask-routed activation stream;
  4. damping tuned by gradient ascent on the Laplace evidence;
  5. a per-token Bayesian predictive against the MAP one.

JAX's step 6, the same update under an ``expert``-sharded mesh, waits for
the port's expert axis (ROADMAP Queue 1 item 10b); the script says so
where the step would run.

    python -m curvature_tpu_torch.examples.moe_laplace [--platform cpu]
"""
import argparse

import numpy as np
import torch
from torch.func import functional_call

from curvature_tpu_torch import estimators, models
from curvature_tpu_torch.eval.marglik import marglik_gradient_tune
from curvature_tpu_torch.nn import Context
from curvature_tpu_torch.utils.device import resolve_device

VOCAB = 64
BATCH = 8


def routed_shares(model, tokens, layer="h.0.moe.fc1"):
    """Each expert's share of the tokens, from the ``[E, ..., F]`` masked
    stream the expert layer ``layer`` records (a routed token's row is
    non-zero in its expert's slice only)."""
    ctx = Context(track=[layer], probes=False)
    with torch.no_grad():
        model(tokens, ctx)
    xm = ctx.acts[layer]
    routed = (xm != 0).any(-1).reshape(xm.shape[0], -1)
    return routed.float().mean(-1).cpu().numpy()


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
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    model = models.gpt2_moe_tiny(num_classes=VOCAB, experts=args.experts,
                                 max_len=args.seq_len, device=device)
    models.load_jax_variables(model, models.seeded_variables(model, 1))
    model.eval()
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(
        0, VOCAB, (args.batches, BATCH, args.seq_len)), device=device)
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
    print("expert-sharded factors: not run, the port's mesh has no expert "
          "axis yet (ROADMAP Queue 1 item 10b)")
    print("done")
    return {"a_shape": tuple(a.shape), "shares": shares,
            "log_marglik": tuned["log_marglik"], "map_nll": map_nll,
            "bnn_nll": bnn_nll}


if __name__ == "__main__":
    main()
