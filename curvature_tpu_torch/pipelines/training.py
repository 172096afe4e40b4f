"""Model training (reference scripts/training.py): SGD or Adam with an
optional L2, a step-decayed learning rate, the KFAC natural-gradient
optimizer, SWAG collection, and a checkpoint under ``<root>/weights/``.

Port of ``curvature_tpu/pipelines/training.py`` on ``torch.optim``. The
learning rate follows JAX's ``optax.piecewise_constant_schedule(lr,
{int(0.5 T): 0.1, int(0.75 T): 0.1})`` over the T steps (:func:`lr_at`),
set on the optimizer before every step. SGD takes ``--l2`` as weight decay
on every parameter (optax ``add_decayed_weights`` then ``sgd``); Adam takes
none, as in JAX. A train step's forward runs the model in train mode, so
BatchNorm updates its running statistics as JAX merges the step's
``batch_stats``. The step losses stay on the device and reach the host
once an epoch. The checkpoint is the model's state in JAX's layout
(``models.variables_to_jax``), so both packages' ``build_model`` read
it; ``--swag`` writes the SWAG state next to it. ``--parallel``/``--mesh``
split every step over the ranks' data axis (``optim.loss_backward``:
BatchNorm synced, gradients summed), so each step is the single-process
step on the global batch and the parameters stay replicated; rank 0
writes the checkpoint.

    python -m curvature_tpu_torch.pipelines.training --model lenet5 \\
        --data mnist --data_dir <dir> --root_dir <root> --epochs 10 \\
        --lr 0.01
"""
import os
from typing import Dict

import numpy as np
import torch

from curvature_tpu_torch.eval import eval_nn, metrics
from curvature_tpu_torch.models import variables_to_jax
from curvature_tpu_torch.optim import loss_backward
from curvature_tpu_torch.parallel.mesh import build_mesh
from curvature_tpu_torch.pipelines.common import on_device
from curvature_tpu_torch.utils.checkpoint import save_pytree


def lr_at(step: int, lr: float, total_steps: int) -> float:
    """The learning rate of ``step`` (counted from 0 over the whole run):
    ``lr`` scaled by 0.1 from each boundary int(0.5 T) and int(0.75 T) on,
    in float32 as optax computes it. The boundaries are one dict's keys,
    so equal ones decay once (T = 1 or 2)."""
    v = np.float32(lr)
    for boundary, scale in sorted({int(total_steps * 0.5): 0.1,
                                   int(total_steps * 0.75): 0.1}.items()):
        if step >= boundary:
            v = np.float32(np.float32(scale) * v)
    return float(v)


def make_train_step(model, optimizer, mesh=None):
    """One SGD/Adam step on a batch: (x, y) -> the step's mean
    cross-entropy, a tensor on the device. With ``mesh`` the batch splits
    over its data axis (JAX ``make_train_step(mesh=)``, :17-50); a batch
    that does not divide runs whole on every rank."""
    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_backward(model, x, y, mesh)
        optimizer.step()
        return loss
    return step


def _labels(y, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(y), device=device).long()


def train(model, train_data, cfg, val_data=None, optimizer: str = "sgd",
          swag=None, mesh=None):
    """Train ``model`` in place on loader batches ``train_data`` (NHWC
    numpy); returns (model, history) with the per-epoch mean loss and,
    given ``val_data``, the validation accuracy.

    ``optimizer`` is ``"sgd"``, ``"adam"`` or ``"kfac"`` (SGD on KFAC-
    preconditioned gradients, ``optim.make_kfac_train_step``, its MC
    labels drawn from a generator seeded with ``cfg.seed``).
    ``swag``: an optional ``estimators.SWAG`` that collects one iterate at
    the end of every epoch in the SWA window (the last 25% of the epochs;
    every epoch when there are fewer than 4). ``mesh`` splits every step
    and the validation pass over its data axis."""
    device = next(model.parameters()).device
    steps_per_epoch = max(len(train_data), 1) \
        if hasattr(train_data, "__len__") else 100
    total_steps = cfg.epochs * steps_per_epoch
    params = list(model.parameters())
    if optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr)
    else:
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                              weight_decay=cfg.l2)
    if optimizer == "kfac":
        from curvature_tpu_torch import optim
        from curvature_tpu_torch.estimators import KFAC
        est = KFAC(model)
        kstep, kinit = optim.make_kfac_train_step(
            model, est, opt, damping=getattr(cfg, "opt_damping", 1e-2),
            mesh=mesh)
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        # one batch of the loader, as JAX takes it: on a shuffling loader
        # this draws one permutation, which every later epoch's order
        # follows
        x0, y0 = next(iter(on_device(train_data, device)))
        factors, inv = kinit(x0, _labels(y0, device), generator)
        count = 0

        def step(x, y):
            nonlocal factors, inv, count
            factors, inv, count, loss = kstep(factors, inv, count, x, y,
                                              generator)
            return loss
    else:
        step = make_train_step(model, opt, mesh)

    history: Dict[str, list] = {"loss": [], "val_acc": []}
    swa_start = int(cfg.epochs * 0.75) if cfg.epochs >= 4 else 0
    k = 0
    for epoch in range(cfg.epochs):
        model.train()
        losses = []
        for x, y in on_device(train_data, device):
            for group in opt.param_groups:
                group["lr"] = lr_at(k, cfg.lr, total_steps)
            losses.append(step(x, _labels(y, device)))
            k += 1
        history["loss"].append(float(np.mean(
            torch.stack(losses).cpu().numpy().astype(np.float64))))
        if swag is not None and epoch >= swa_start:
            swag.collect(model)
        if val_data is not None:
            probs, labels = eval_nn(model, on_device(val_data, device),
                                    mesh=mesh)
            history["val_acc"].append(float(metrics.accuracy(probs,
                                                             labels)))
    return model, history


def weights_path(cfg, suffix: str = "") -> str:
    """``<root>/weights/<model>_<data><suffix>.npz``."""
    return os.path.join(cfg.root_dir, "weights",
                        f"{cfg.model}_{cfg.data}{suffix}.npz")


def run(cfg):
    from curvature_tpu_torch.estimators.swag import SWAG
    from curvature_tpu_torch.pipelines.common import build_data, build_model
    model = build_model(cfg)
    splits = build_data(cfg, splits=("train", "val"))
    train_data, val_data = splits if isinstance(splits, list) \
        else (splits, None)
    swag = SWAG(model, max_rank=getattr(cfg, "swag_rank", 20)) \
        if getattr(cfg, "swag", False) else None
    opt = cfg.optimizer if cfg.optimizer in ("adam", "kfac") else "sgd"
    model, history = train(model, train_data, cfg, val_data, optimizer=opt,
                           swag=swag, mesh=build_mesh(cfg))
    save_pytree(weights_path(cfg), variables_to_jax(model))
    if swag is not None:
        save_pytree(weights_path(cfg, "_swag"), swag.jax_state())
    return model, history


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
