"""Loss-landscape evaluation (reference scripts/loss.py, Li et al. style).

Port of ``curvature_tpu/pipelines/loss_landscape.py``: filter-normalized
random directions (loss.py:121-167), 1-D line scans and 2-D surfaces
(loss.py:170-397), resumable (the coordinates already evaluated are
skipped; the result is saved after every chunk, in JAX's pickled ``.npy``
dict, so a scan half written by either package is finished by the other).

A chunk of perturbed parameter sets runs as one batched forward per data
batch: ``torch.func.vmap`` over ``functional_call`` with the model in
eval mode (BatchNorm on its running statistics), as JAX vmaps its chunk;
where vmap cannot take a layer, the chunk runs as a loop. A ragged last
chunk is padded to the chunk size, as in JAX. ``mesh`` (``--parallel``/
``--mesh``) splits each data batch over the mesh's data axis: each rank
sums its rows' losses and hits and the sums meet in an all-reduce (JAX
``make_chunked_eval(mesh=)``, :63-93); a batch that does not divide
runs whole on every rank.

The filter axis: JAX normalizes a direction per output filter over every
axis but the last, the output axis of its HWIO and ``[in, out]`` layouts.
Here a ``Conv`` weight's output axis is the first (OIHW) and a ``Dense``
weight's the second to last (``[(depth,) out, in]``); every other leaf
has the same layout in both packages and keeps JAX's rule
(:func:`filter_axes`). Directions are drawn from a ``torch.Generator``
(seeded with ``--seed`` by ``run``); ``loss1d`` and ``loss2d`` take given
``directions`` too. ``--plot`` draws ``_loss1d.pdf``/``_loss2d.pdf``
(``pipelines/plot.py``).

    python -m curvature_tpu_torch.pipelines.loss_landscape --model lenet5 \\
        --data mnist --data_dir <dir> --loss1d
"""
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from curvature_tpu_torch.estimators.capture import softmax_cross_entropy
from curvature_tpu_torch.nn import Conv, Dense
from curvature_tpu_torch.parallel.mesh import all_reduce, build_mesh
from curvature_tpu_torch.utils.checkpoint import write_once


def filter_axes(model) -> Dict[str, int]:
    """The output-filter axis of each parameter (state-dict key): 0 for a
    ``Conv`` weight, -2 for a ``Dense`` weight, -1 (JAX's) otherwise."""
    axes = {}
    for name, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            key = f"{name}.{pname}" if name else pname
            axes[key] = -1
            if pname == "weight" and isinstance(m, Conv):
                axes[key] = 0
            elif pname == "weight" and isinstance(m, Dense):
                axes[key] = -2
    return axes


def _filter_normalize(d: torch.Tensor, w: torch.Tensor, axis: int = 0
                      ) -> torch.Tensor:
    """Per-output-filter rescale of direction ``d`` to the norm of the
    weight's filter (loss.py:88-101); ``axis`` is the output axis, the
    sums run over every other."""
    axis = axis % d.ndim
    dims = tuple(i for i in range(d.ndim) if i != axis)
    dn = torch.sqrt(torch.sum(d * d, dim=dims, keepdim=True))
    wn = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
    return d * (wn / (dn + 1e-10))


def random_direction(params: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None,
                     norm: str = "filter", ignore: str = "biasbn",
                     axes: Optional[Dict[str, int]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A random direction (one standard-normal draw per parameter, in the
    dict's order), filter-normalized along ``axes`` (:func:`filter_axes`;
    the first axis where none is given), zero for 1-D parameters (biases
    and BatchNorm's: reference normalize_direction, loss.py:131-141)."""
    out = {}
    for key, w in params.items():
        d = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                        device=w.device)
        if w.ndim <= 1:
            if ignore == "biasbn":
                d = torch.zeros_like(w)
        elif norm == "filter":
            d = _filter_normalize(d, w, (axes or {}).get(key, 0))
        elif norm == "layer":
            d = d * (torch.linalg.norm(w) / (torch.linalg.norm(d) + 1e-10))
        elif norm == "weight":
            d = d * w
        out[key] = d
    return out


def perturb(params: Dict[str, torch.Tensor], directions: Sequence[Dict],
            steps: Sequence[float]) -> Dict[str, torch.Tensor]:
    """params + sum_i steps[i] * directions[i] (reference set_state,
    loss.py:68-86), a new dict."""
    out = dict(params)
    for d, s in zip(directions, steps):
        out = {k: p + s * d[k] for k, p in out.items()}
    return out


def make_chunked_eval(model, mesh=None):
    """(stacked params {key: [chunk, ...]}, x, y) -> per point (sum loss,
    number correct), two [chunk] tensors on the device; the model runs in
    eval mode. ``vmap`` over the chunk, else a loop over its points.
    Under ``mesh`` this rank's rows, the sums all-reduced."""
    def one(p, x, y):
        logits = functional_call(model, p, (x,))
        loss = softmax_cross_entropy(logits, y) * y.shape[0]
        return loss, (logits.argmax(-1) == y).sum()

    batched = vmap(one, in_dims=(0, None, None))
    state = {"vmap": True}

    def looped(stacked, x, y):
        size = next(iter(stacked.values())).shape[0]
        outs = [one({k: v[i] for k, v in stacked.items()}, x, y)
                for i in range(size)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    @torch.no_grad()
    def chunk_eval(stacked, x, y):
        rows = None if mesh is None else mesh.rows(x.shape[0])
        if rows is None:
            return local_eval(stacked, x, y)
        group = mesh.group("data")
        return tuple(all_reduce(t, group)
                     for t in local_eval(stacked, x[rows], y[rows]))

    def local_eval(stacked, x, y):
        # batched tensors answer layout queries for the contiguous format
        # only: the chunk runs in NCHW whatever the model's format
        stacked = {k: v.contiguous() for k, v in stacked.items()}
        x = x.contiguous()
        if state["vmap"]:
            try:
                return batched(stacked, x, y)
            except torch.cuda.OutOfMemoryError:
                raise
            except RuntimeError as e:
                state["vmap"] = False
                print(f"loss landscape: vmap cannot batch this model "
                      f"({str(e).splitlines()[0]}); the chunk runs as a "
                      "loop", flush=True)
        return looped(stacked, x, y)
    chunk_eval.state = state
    return chunk_eval


def make_point_evaluator(model, directions, chunk: int = 8, mesh=None):
    """One evaluator reused across every chunk of coordinates: each
    chunk's perturbed parameter sets (padded to ``chunk``) run over every
    batch; returns ``eval_coords(coords, batches)`` -> (mean losses,
    accuracies in %) per row of ``coords`` (one column per direction).
    ``eval_coords.points`` and ``.seconds`` count what it evaluated, and
    ``.state["vmap"]`` says whether the chunks ran through vmap."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    dirs = list(directions)
    chunk_eval = make_chunked_eval(model, mesh)

    def eval_coords(coords: np.ndarray, batches: List
                    ) -> Tuple[np.ndarray, np.ndarray]:
        n_points = len(coords)
        losses = np.zeros(n_points)
        accs = np.zeros(n_points)
        was_training = model.training
        model.eval()
        t0 = time.perf_counter()
        eval_coords.points += n_points
        try:
            for start in range(0, n_points, chunk):
                sel = coords[start:start + chunk]
                k = len(sel)
                if k < chunk:     # pad: the same chunk shape for the tail
                    sel = np.concatenate([sel, np.repeat(sel[-1:],
                                                         chunk - k, 0)])
                points = [perturb(params, dirs, [float(c) for c in row])
                          for row in sel]
                stacked = {key: torch.stack([p[key] for p in points])
                           for key in params}
                sums = [chunk_eval(stacked, x, y) for x, y in batches]
                loss_sum = np.zeros(chunk)
                correct_sum = np.zeros(chunk)
                total = 0
                for (l, c), (_, y) in zip(sums, batches):
                    loss_sum += l.cpu().numpy()
                    correct_sum += c.cpu().numpy()
                    total += len(y)
                losses[start:start + k] = loss_sum[:k] / total
                accs[start:start + k] = 100.0 * correct_sum[:k] / total
        finally:
            model.train(was_training)
            eval_coords.seconds += time.perf_counter() - t0
        return losses, accs

    eval_coords.points, eval_coords.seconds = 0, 0.0
    eval_coords.state = chunk_eval.state
    eval_coords.chunk = chunk
    return eval_coords


def _report(what: str, eval_coords):
    """Print the seconds per point of a scan that evaluated any."""
    n = eval_coords.points
    if n:
        how = "vmap" if eval_coords.state["vmap"] else "a loop"
        print(f"{what}: {n} points in {eval_coords.seconds:.3f} s, "
              f"{eval_coords.seconds / n:.5f} s per point (chunks of "
              f"{eval_coords.chunk} through {how})", flush=True)


def evaluate_points(model, directions, coords: np.ndarray, batches: List,
                    chunk: int = 8, mesh=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Loss and accuracy at each coordinate (rows of ``coords``, one
    column per direction)."""
    return make_point_evaluator(model, directions, chunk, mesh)(coords,
                                                                batches)


def _device_batches(batches, device) -> List:
    """A loader's batches (one pass) as (model input, int64 labels) on
    ``device``."""
    from curvature_tpu_torch.pipelines.common import on_device
    return [(x, torch.as_tensor(np.asarray(y), device=device).long())
            for x, y in on_device(batches, device)]


def _params(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach() for k, p in model.named_parameters()}


def loss1d(model, train_batches, val_batches=None,
           generator: Optional[torch.Generator] = None, xmin: float = -1.0,
           xmax: float = 1.0, steps: int = 51, path: str = "",
           chunk: int = 8, directions: Optional[Sequence[Dict]] = None,
           mesh=None) -> Dict:
    """1-D line scan along one filter-normalized direction (reference
    loss1d, loss.py:170-293), resumable via ``path``. ``train_batches``
    and ``val_batches`` are loaders (NHWC numpy batches), each read once;
    ``directions``, where given, is the one direction to scan."""
    device = next(model.parameters()).device
    n = steps
    result = _load_or_new(path, {
        "xcoordinates": np.linspace(xmin, xmax, steps),
        "train_loss": np.full(n, np.nan), "train_acc": np.full(n, np.nan),
        "val_loss": np.full(n, np.nan), "val_acc": np.full(n, np.nan),
    })
    if directions is None:
        directions = [random_direction(_params(model), generator,
                                       axes=filter_axes(model))]
    xs = result["xcoordinates"][:, None]
    eval_coords = make_point_evaluator(model, directions, chunk, mesh)

    def fill(split, batches):
        loss_key, acc_key = f"{split}_loss", f"{split}_acc"
        if result[loss_key] is None:
            result[loss_key] = np.full(n, np.nan)
            result[acc_key] = np.full(n, np.nan)
        # resume: only the missing coordinates, chunk by chunk (the
        # reference saves after every point, loss.py:237-239, 267)
        missing = np.where(~np.isfinite(result[loss_key]))[0]
        batches = _device_batches(batches, device)
        for start in range(0, len(missing), chunk):
            sel = missing[start:start + chunk]
            l, a = eval_coords(xs[sel], batches)
            result[loss_key][sel] = l
            result[acc_key][sel] = a
            _save(path, result)

    fill("train", train_batches)
    if val_batches is not None:
        fill("val", val_batches)
    _report("loss1d", eval_coords)
    return result


def loss2d(model, train_batches, generator: Optional[torch.Generator] = None,
           xmin: float = -1.0, xmax: float = 1.0, xsteps: int = 21,
           ymin: float = -1.0, ymax: float = 1.0, ysteps: int = 21,
           path: str = "", chunk: int = 8,
           directions: Optional[Sequence[Dict]] = None, mesh=None) -> Dict:
    """2-D surface over two random filter-normalized directions, ``dx``
    drawn before ``dy`` (reference loss2d, loss.py:296-397); resumable
    per row. ``directions``, where given, is (dx, dy)."""
    device = next(model.parameters()).device
    xs = np.linspace(xmin, xmax, xsteps)
    ys = np.linspace(ymin, ymax, ysteps)
    result = _load_or_new(path, {
        "xcoordinates": xs, "ycoordinates": ys,
        "loss": np.full((ysteps, xsteps), np.nan),
        "acc": np.full((ysteps, xsteps), np.nan),
    })
    if directions is None:
        axes = filter_axes(model)
        directions = [random_direction(_params(model), generator, axes=axes)
                      for _ in range(2)]
    batches = _device_batches(train_batches, device)
    eval_coords = make_point_evaluator(model, directions, chunk, mesh)
    for j, yv in enumerate(ys):
        if np.isfinite(result["loss"][j]).all():
            continue  # resume: skip evaluated rows (loss.py:359-364)
        coords = np.stack([xs, np.full_like(xs, yv)], axis=1)
        l, a = eval_coords(coords, batches)
        result["loss"][j] = l
        result["acc"][j] = a
        _save(path, result)
    _report("loss2d", eval_coords)
    return result


def _load_or_new(path: str, default: Dict) -> Dict:
    if path and os.path.exists(path):
        return dict(np.load(path, allow_pickle=True).item())
    return default


def _save(path: str, result: Dict):
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_once(np.save, path, result, allow_pickle=True)


def run(cfg):
    from curvature_tpu_torch.pipelines import plot
    from curvature_tpu_torch.pipelines.common import build_data, build_model
    from curvature_tpu_torch.utils.checkpoint import results_paths
    results_path, fig_path = results_paths(cfg)
    model = build_model(cfg)
    train = build_data(cfg, splits="train")
    generator = torch.Generator(device=next(model.parameters()).device
                                ).manual_seed(cfg.seed)
    # --parallel/--mesh: eval batches split over the data axis (reference
    # loss.py:423-424)
    mesh = build_mesh(cfg)
    if cfg.loss2d:
        res = loss2d(model, train, generator,
                     path=results_path + "_loss2d.npy", mesh=mesh)
        if cfg.plot:
            plot.plot_surfaces(res, fig_path + "_loss2d.pdf")
        return res
    val = build_data(cfg, splits="val")
    res = loss1d(model, train, val, generator,
                 path=results_path + "_loss1d.npy", mesh=mesh)
    if cfg.plot:
        plot.plot_loss1d(res, fig_path + "_loss1d.pdf")
    return res


def main(argv=None):
    from curvature_tpu_torch.utils.config import setup
    return run(setup(argv))


if __name__ == "__main__":
    main()
