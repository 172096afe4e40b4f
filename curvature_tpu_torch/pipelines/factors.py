"""Factor estimation pipeline (reference scripts/factors.py).

Port of ``curvature_tpu/pipelines/factors.py``: per batch one forward and
``--mc_samples`` Monte-Carlo label backwards, the factor Grams of each
update accumulated into the estimator's state, which is saved as an npz
that the JAX package loads as its own. Full chunks of ``--scan_chunk``
uniform batches go through ``update_batches``, the ragged tail through
``update``; the labels come from one ``torch.Generator`` seeded with
``--seed``. On the card the batches come through ``data.prefetch.
DevicePrefetcher``, ``max(--workers, 2)`` deep (JAX :88-96): pinned host
copies, ``non_blocking`` transfers on a side stream overlapping the
update; on the CPU each batch is wrapped as it comes.

    python -m curvature_tpu_torch.pipelines.factors --model lenet5 \\
        --data mnist --data_dir <dir holding MNIST/raw> --estimator kfac
"""
import os
import time
from typing import Optional

import torch

from curvature_tpu_torch import estimators
from curvature_tpu_torch.data.prefetch import DevicePrefetcher
from curvature_tpu_torch.models import state_from_jax
from curvature_tpu_torch.pipelines.common import (
    build_data, build_model, device_batch, layer_filter, loss_kind,
    model_input)
from curvature_tpu_torch.utils.checkpoint import (
    factors_path, load_pytree, save_pytree)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def compute_factors(model, data, cfg, kfac_state=None,
                    generator: Optional[torch.Generator] = None):
    """Run the Fisher estimation loop (reference compute_factors,
    factors.py:33-62) over NHWC batches ``data``; returns the estimator
    with ``num_updates`` set (the states are raw running sums)."""
    name = cfg.estimator.lower()
    subsample = float(getattr(cfg, "token_subsample", 1.0) or 1.0)
    if subsample < 1.0 and name != "kfac":
        raise ValueError(
            "--token_subsample applies to KFAC's conv A-factor Grams only; "
            f"--estimator {name} has no patch-Gram phase")
    device = _device(model)
    # --precision bfloat16: capture forwards/backwards in bf16, f32 factors
    kw = dict(layer_filter=layer_filter(cfg), loss=loss_kind(cfg),
              compute_dtype=(torch.bfloat16 if cfg.precision == "bfloat16"
                             else None))
    if name == "diag":
        est = estimators.Diagonal(model, **kw)
    elif name == "kfac":
        est = estimators.KFAC(model, token_subsample=subsample,
                              g_block_size=cfg.g_block_size,
                              attention_qkv_split=cfg.qkv_split,
                              attention_head_split=cfg.head_split, **kw)
    elif name == "block":
        est = estimators.BlockDiagonal(model, **kw)
    elif name == "efb":
        if kfac_state is None:
            kfac_state = load_pytree(factors_path(cfg, "kfac"))
        est = estimators.EFB(model, state_from_jax(kfac_state, device), **kw)
    elif name == "subspace":
        raise NotImplementedError(
            f"--estimator {name} is not ported yet (ROADMAP Queue 1 item 8)")
    else:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    chunk = max(getattr(cfg, "scan_chunk", 1), 1)
    num_updates = 0
    if device.type == "cuda":
        data = DevicePrefetcher(data, depth=max(getattr(cfg, "workers", 0),
                                                2), device=device)
    for epoch in range(cfg.epochs):
        buffer = []
        t0 = time.perf_counter()
        for i, (x, _) in enumerate(data):
            buffer.append(device_batch(x, device))
            if len(buffer) == chunk and chunk > 1 \
                    and all(b.shape == buffer[0].shape for b in buffer):
                est.update_batches(model_input(torch.stack(buffer)),
                                   generator,
                                   num_samples=cfg.mc_samples)
                num_updates += len(buffer)
                buffer = []
            elif len(buffer) >= chunk:
                for b in buffer:
                    est.update(model_input(b), generator=generator,
                               num_samples=cfg.mc_samples)
                num_updates += len(buffer)
                buffer = []
            if cfg.verbose:
                _progress(epoch, cfg.epochs, i + 1, len(data), t0, device)
        for b in buffer:        # ragged tail
            est.update(model_input(b), generator=generator,
                       num_samples=cfg.mc_samples)
            num_updates += 1
    est.num_updates = num_updates
    return est


def _progress(epoch, epochs, done, total, t0, device):
    """The reference's tqdm + RAM/VRAM postfix (factors.py:47-49), as a
    plain line."""
    from curvature_tpu_torch.utils.monitor import device_memory_gb, ram
    print(f"Epoch [{epoch + 1}/{epochs}] {done}/{total} batches, "
          f"{time.perf_counter() - t0:.1f} s | RAM {ram():.0f}% | device "
          f"{device_memory_gb(device):.2f}GB", flush=True)


def compute_inf(cfg, model):
    """Assemble INF from the saved diag/kfac/efb factors (reference
    compute_inf, factors.py:12-30) and build its low-rank state at
    ``--rank``; bucket 8 pads the index sets, as in JAX."""
    device = _device(model)
    factors = state_from_jax(load_pytree(factors_path(cfg, "kfac")), device)
    lambdas = state_from_jax(load_pytree(factors_path(cfg, "efb")), device)
    diags = state_from_jax(load_pytree(factors_path(cfg, "diag")), device)
    est = estimators.INF(model, diags, factors, lambdas,
                         layer_filter=layer_filter(cfg))
    est.update(cfg.rank, bucket=8)
    return est


def diagnose(est, x, cfg, norm: float = 1.0):
    raise NotImplementedError(
        "--fidelity/--spectrum need eval/fidelity.py and ops/matfree.py, "
        "not ported yet (ROADMAP Queue 1 item 8)")


def run(cfg):
    """Full pipeline: model -> data -> factors -> save (factors.py:65-129).
    Returns the estimator."""
    os.makedirs(os.path.join(cfg.root_dir, "factors"), exist_ok=True)
    model = build_model(cfg)
    if getattr(cfg, "fidelity", 0) or getattr(cfg, "spectrum", 0):
        diagnose(None, None, cfg)
    if cfg.estimator == "inf":
        est = compute_inf(cfg, model)
        save_pytree(factors_path(cfg, rank=str(cfg.rank)), est.state)
        return est
    est = compute_factors(model, build_data(cfg, splits="train"), cfg)
    save_pytree(factors_path(cfg), est.state)
    if cfg.estimator == "efb":
        # EFB computes the plain diagonal for free (reference
        # factors.py:126-127, README.rst:246)
        save_pytree(factors_path(cfg, "diag"), est.diags)
    return est


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
