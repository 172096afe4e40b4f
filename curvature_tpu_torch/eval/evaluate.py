"""Deterministic and Bayesian model evaluation.

Port of ``curvature_tpu/eval/evaluate.py`` (reference evaluate.py:94-170):
``make_forward_fn`` and ``make_ensemble_fn``, ``eval_nn``, ``eval_bnn``
(with its ``sample_chunk`` path and the ``stats`` running statistics),
``eval_nn_and_bnn`` and the sufficient-statistics evals. The model runs in
eval mode (running-statistics BN). As in JAX, a Bayesian eval runs each
data batch's whole ensemble as ONE batched forward: the members' parameter
dicts are stacked on a leading sample axis and ``torch.func.vmap`` maps
``torch.func.functional_call`` over it, giving ``[S, B, K]``.
``compute_dtype`` (``--precision bfloat16``) runs the forwards with every
float parameter and the input cast to it (BatchNorm's running statistics
stay f32); the softmax and every metric stay f32. Data batches are (NCHW
input, labels) pairs, or (token ids [B, T], next-token labels [B, T]): a
causal LM's [B, T, V] softmax is scored per token, flattened to [B*T, V]
with the labels to [B*T], as in JAX.

The route is decided before the call, by :func:`vmaps` from the model's
class and the input's shape. MaxViT's class sets ``vmap_ensemble =
False`` (on the card its vmapped forward raises a layout query that vmap
does not answer; ``models/maxvit.py``): its members always run in a
loop. An image model's ensemble runs under vmap while an image holds at
most ``vmap_max_pixels`` pixels (H*W; :data:`VMAP_MAX_PIXELS` unless its
class states another limit, None for none), and in a member loop above
it: on the H100, cuDNN runs a vmapped convolution as one grouped
convolution of S groups, which is faster than S convolutions while each
is small (ResNet-18 at 32², ResNet-50 up to 96²) and up to ~3x slower
once each fills the card (ResNet-50 at 224²; ``chip_smoke.py
--surface`` measures both sides and sweeps the sizes between). The
attention families (ViT, Swin, the token models) state no limit: their
vmapped forwards were faster at 224². Nothing catches a vmap failure to fall back. The loop runs each
member as the model is laid out (channels_last on the card). Under vmap
the stacked members, the shared parameters and the input enter in the
contiguous (NCHW) format, since a batched tensor answers layout queries
for that format only, and cuDNN's batch norm asks one after a
channels_last convolution (``nn/core.py``'s ``decompose_norm``).

At a vocabulary-sized output ``eval_nn_stats``/``eval_bnn_stats`` reduce
each batch on the device to four numbers per token (``STATS_COLUMNS``);
the Bayesian one accumulates the sample-mean softmax per batch, so no
[N, V] matrix reaches the host (JAX evaluate.py:237-300).

``mesh`` (a :class:`~curvature_tpu_torch.parallel.Mesh`) splits every
batch over its data axis: each rank runs its rows and an all-gather
returns the whole batch's probabilities in batch order, so every rank
holds the same predictions and metrics (JAX ``_mesh_dispatch``, :22-40).
A batch that does not divide the axis runs whole on every rank.
"""
import contextlib
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call, vmap

from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.parallel.mesh import gather_rows
from curvature_tpu_torch.utils import monitor
from curvature_tpu_torch.utils.casting import cast_floats, cast_input


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _batches(data, device):
    for x, y in data:
        yield torch.as_tensor(x, device=device), np.asarray(y).reshape(-1)


@contextlib.contextmanager
def eval_mode(model):
    """The model in eval mode for the block, its mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def _per_token_probs(logits: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """f32 softmax; a causal LM's [B, T, V] as per-token [B*T, V], after
    ``lead`` leading axes (the ensemble's sample axis) kept as they are."""
    p = torch.softmax(logits.float(), dim=-1)
    return p.flatten(-3, -2) if p.ndim > 2 + lead else p


class StackedEnsemble(NamedTuple):
    """An ensemble as one vmapped call takes it: ``shared`` holds the
    tensors every member has in common (one copy), ``stacked`` the others
    with the members on a leading axis of ``size``."""
    shared: Dict[str, torch.Tensor]
    stacked: Dict[str, torch.Tensor]
    size: int


def _strided_nchw(t: torch.Tensor) -> bool:
    """Whether ``t`` has the contiguous format's own strides. Not
    ``is_contiguous()``: a channels_last 1x1 kernel ``[O, I, 1, 1]`` is
    contiguous in both formats, yet its strides make cuDNN pick the
    channels_last layout for the convolution's output."""
    want, step = [], 1
    for n in reversed(t.shape):
        want.append(step)
        step *= n
    return tuple(reversed(want)) == t.stride()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    if t.ndim < 4 or _strided_nchw(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def nchw_rest(model, *given: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Copies in the contiguous format's strides of the model's own
    four-dimensional parameters that none of the ``given`` dicts replaces
    and that have other strides (a channels_last model's): the layout
    rule of the module docstring, for the weights a vmapped call takes
    from the model."""
    return {k: _nchw(v.detach()) for k, v in model.named_parameters()
            if v.ndim >= 4 and not _strided_nchw(v)
            and not any(k in g for g in given)}


def stack_ensemble(ensemble_params, model=None, compute_dtype=None
                   ) -> StackedEnsemble:
    """``ensemble_params`` as a :class:`StackedEnsemble`: a list of member
    dicts (state-dict keys, as ``Estimator.ensemble_params`` returns them;
    a key whose tensor is the same object in every member of two or more
    is shared), a dict of ``[S, ...]`` tensors, or a StackedEnsemble. With
    ``compute_dtype`` every float tensor is cast to it, and the ``model``'s
    other parameters join the shared ones cast (JAX casts the whole
    variable tree). Four-dimensional tensors are made contiguous (NCHW),
    the ``model``'s own that no member replaces included
    (:func:`nchw_rest`): the module docstring's layout rule, applied once
    per ensemble."""
    if isinstance(ensemble_params, StackedEnsemble):
        shared, stacked = ensemble_params.shared, ensemble_params.stacked
        size = ensemble_params.size
    elif isinstance(ensemble_params, dict):
        shared, stacked = {}, dict(ensemble_params)
        size = next(iter(stacked.values())).shape[0]
    else:
        members = list(ensemble_params)
        if not members:
            raise ValueError("an ensemble needs at least one member")
        shared, stacked = {}, {}
        for k, v in members[0].items():
            if len(members) > 1 and all(m[k] is v for m in members[1:]):
                shared[k] = v
            else:
                stacked[k] = torch.stack([m[k] for m in members])
        size = len(members)
    if compute_dtype is not None:
        own = {} if model is None else {
            k: v for k, v in model.named_parameters()
            if k not in shared and k not in stacked}
        shared = cast_floats(dict(own, **shared), compute_dtype)
        stacked = cast_floats(stacked, compute_dtype)
    shared = {k: _nchw(v) for k, v in shared.items()}
    if model is not None:
        shared.update(nchw_rest(model, shared, stacked))
    return StackedEnsemble(shared, {k: _nchw(v) for k, v in stacked.items()},
                           size)


def member_list(ensemble_params, model=None, compute_dtype=None
                ) -> List[Dict[str, torch.Tensor]]:
    """``ensemble_params`` (as :func:`stack_ensemble` takes it) as a list
    of member dicts, a stacked one's members as views; with
    ``compute_dtype`` each member and the ``model``'s other parameters
    cast to it."""
    if isinstance(ensemble_params, (dict, StackedEnsemble)):
        shared, stacked, size = (
            ensemble_params if isinstance(ensemble_params, StackedEnsemble)
            else ({}, ensemble_params,
                  next(iter(ensemble_params.values())).shape[0]))
        members = [{**shared, **{k: v[i] for k, v in stacked.items()}}
                   for i in range(size)]
    else:
        members = list(ensemble_params)
    if compute_dtype is not None:
        own = dict(model.named_parameters())
        members = [cast_floats(dict(own, **m), compute_dtype)
                   for m in members]
    return members


#: the most pixels (H*W) an image may hold for an image model's sampled
#: ensemble to run under vmap, where its class states no limit of its own
#: (``vmap_max_pixels``; the CIFAR-stem ResNets state 32²): on the H100
#: (``chip_smoke.py --surface``'s sweep, B=16, 30 members, f32) ResNet-50's
#: vmapped call was faster up to 96² and the member loop from 128², and
#: DenseNet-121's vmapped call at 64², the loop at 224²
VMAP_MAX_PIXELS = 96 * 96


def vmaps(model, x=None) -> bool:
    """Whether the ensemble forwards of ``model`` on inputs shaped as ``x``
    (a tensor or array) run under ``vmap``: never where the class sets
    ``vmap_ensemble = False``; for images ``[B, C, H, W]`` while ``H*W``
    is at most the class's ``vmap_max_pixels`` (:data:`VMAP_MAX_PIXELS`
    where it states none, None for no limit); otherwise always. Without
    ``x`` the class's own rule alone (the linearized predictive's jvp)."""
    if not getattr(model, "vmap_ensemble", True):
        return False
    most = getattr(model, "vmap_max_pixels", VMAP_MAX_PIXELS)
    if x is None or most is None or len(x.shape) != 4:
        return True
    return x.shape[-2] * x.shape[-1] <= most


def prepare_ensemble(model, ensemble_params, x, compute_dtype=None):
    """``ensemble_params`` as the route for inputs shaped as ``x`` takes it
    (:func:`vmaps`): a :class:`StackedEnsemble` under vmap, else a list of
    member dicts. Prepare once per ensemble, call per batch."""
    if vmaps(model, x):
        return stack_ensemble(ensemble_params, model, compute_dtype)
    return member_list(ensemble_params, model, compute_dtype)


def ensemble_size(ens) -> int:
    return ens.size if isinstance(ens, StackedEnsemble) else len(ens)


def ensemble_logits(model, ens, x: torch.Tensor) -> torch.Tensor:
    """[S, ...] outputs of every member of a :func:`prepare_ensemble`
    ensemble on ``x``: one ``vmap`` of ``functional_call`` over a
    StackedEnsemble's members, or a loop over a member list; the model's
    mode as it is, no gradient. Members that share everything run once,
    expanded."""
    with torch.no_grad():
        if not isinstance(ens, StackedEnsemble):
            outs = []
            for i, member in enumerate(ens):
                with monitor.span("eval.member", member=i):
                    outs.append(functional_call(model, member, (x,)))
            return torch.stack(outs)
        x = _nchw(x)
        if not ens.stacked:
            out = functional_call(model, ens.shared, (x,))
            return out.expand((ens.size,) + out.shape)
        stacked = ens.stacked
        if ens.size == 1:
            # vmap over one member takes the plain conv, not the grouped
            # one, and rounds apart (4.5e-6 on LeNet-5's probabilities): a
            # lone member (a sample_chunk remainder) runs beside a copy of
            # itself, so the chunked mean stays within 1e-6 of max of the
            # unchunked one (tests/test_torch_pipelines.py::
            # test_bnn_stats_and_sample_chunk)
            stacked = {k: torch.cat([v, v]) for k, v in stacked.items()}
        return vmap(lambda p: functional_call(model, {**ens.shared, **p},
                                              (x,)))(stacked)[:ens.size]


def make_forward_fn(model, compute_dtype=None, mesh=None):
    """Eval-mode softmax forward: ``fwd(params, x)`` -> [B, K] in f32
    ([B*T, V] per token for a causal LM), ``params`` (state-dict keys)
    replacing the model's own or None for them. ``compute_dtype`` casts
    the parameters and the input; under ``mesh`` this rank's rows run and
    the probabilities are gathered (JAX :43-62). Buffers stay as they
    are: BatchNorm normalizes in f32 on f32 running statistics, as JAX
    keeps ``batch_stats`` f32."""
    def fwd(params: Optional[Dict[str, torch.Tensor]], x: torch.Tensor):
        if compute_dtype is not None:
            own = dict(model.named_parameters())
            params = cast_floats(dict(own, **(params or {})), compute_dtype)
        x = cast_input(x, compute_dtype)

        def rows(xs):
            with eval_mode(model), torch.no_grad():
                logits = model(xs) if params is None else functional_call(
                    model, params, (xs,))
            return _per_token_probs(logits)
        return gather_rows(mesh, rows, x)
    return fwd


def make_ensemble_fn(model, compute_dtype=None, mesh=None):
    """Per-member softmax over an ensemble axis: ``fwd(ensemble_params,
    x)`` -> [S, B, K] in f32 ([S, B*T, V] for a causal LM), ONE
    ``torch.func.vmap`` of ``functional_call`` over the members stacked
    on a leading axis (JAX :65-88), or the member loop where
    :func:`vmaps` routes ``x`` there; buffers (BatchNorm's running
    statistics) are shared, as JAX's ``batch_stats``.
    ``ensemble_params`` is a list of member dicts, a dict of ``[S, ...]``
    tensors, a :class:`StackedEnsemble` or a :func:`prepare_ensemble`
    result (prepare once, call per batch). Under ``mesh`` this rank's
    rows, gathered along the batch axis."""
    def fwd(ensemble_params: Union[List[Dict], Dict, StackedEnsemble],
            x: torch.Tensor) -> torch.Tensor:
        x = cast_input(x, compute_dtype)
        ens = prepare_ensemble(model, ensemble_params, x, compute_dtype)

        def rows(xs):
            with eval_mode(model):
                return _per_token_probs(ensemble_logits(model, ens, xs),
                                        lead=1)
        return gather_rows(mesh, rows, x, dim=1)
    return fwd


@torch.no_grad()
def eval_nn(model, data: Iterable[Tuple], compute_dtype=None, mesh=None,
            forward_fn=None) -> Tuple[np.ndarray, np.ndarray]:
    """One deterministic pass; returns (softmax [N, K], labels [N]).
    ``forward_fn`` (a :func:`make_forward_fn` forward) replaces the
    default one."""
    fwd = forward_fn or make_forward_fn(model, compute_dtype, mesh)
    probs, labels = [], []
    for x, y in _batches(data, _device(model)):
        probs.append(fwd(None, x).cpu())
        labels.append(y)
    return torch.cat(probs).numpy(), np.concatenate(labels)


def _chunks(ensemble, step: int):
    """A given ensemble in runs of at most ``step`` members."""
    if isinstance(ensemble, (dict, StackedEnsemble)):
        yield ensemble
        return
    members = list(ensemble)
    for i in range(0, len(members), step):
        yield members[i:i + step]


@torch.no_grad()
def _ensemble_sums(fwd, ens, batches, keep_samples, device):
    """Per batch, the softmax summed over a prepared ensemble [B, K]
    (and, with ``keep_samples``, each sample's [S, B, K]); each batch's
    forward and its copy to the host are the spans ``eval.forward`` and
    ``eval.to_host``."""
    sums, per_sample = [], []
    members = ensemble_size(ens)
    route = "vmap" if isinstance(ens, StackedEnsemble) else "loop"
    for x, _ in _batches(batches, device):
        with monitor.span("eval.forward", members=members, route=route):
            probs = fwd(ens, x)
        with monitor.span("eval.to_host"):
            sums.append(probs.sum(0).cpu())
            if keep_samples:
                per_sample.append(probs.cpu().numpy())
    return torch.cat(sums).numpy(), per_sample


def _running_stats(probs_all: np.ndarray, labels: np.ndarray,
                   samples: int) -> Dict[str, List[float]]:
    """The reference's running statistics over the sample axis: accuracy,
    ECE and entropy of the running mean, each sample's NLL
    (evaluate.py:141-146)."""
    out = {"acc": [], "ece": [], "nll": [], "ent": []}
    running = np.cumsum(probs_all, axis=0)
    for s in range(samples):
        mean_s = running[s] / (s + 1)
        out["acc"].append(float(metrics.accuracy(mean_s, labels)))
        out["ece"].append(float(
            100 * metrics.expected_calibration_error(mean_s, labels)[0]))
        out["nll"].append(float(
            metrics.negative_log_likelihood(probs_all[s], labels)))
        out["ent"].append(float(
            metrics.predictive_entropy(mean_s, mean=True)))
    return out


def eval_bnn(model, estimator, data: Iterable[Tuple], samples: int = 30,
             ensemble_params: Optional[List[Dict[str, torch.Tensor]]] = None,
             generator: Optional[torch.Generator] = None,
             stats: bool = False, sample_chunk: Optional[int] = None,
             compute_dtype=None, mesh=None
             ) -> Tuple[np.ndarray, np.ndarray, Dict[str, List[float]]]:
    """Mean softmax over ``samples`` posterior weight draws; returns (mean
    predictions [N, K], labels [N], running statistics).

    The ensemble is drawn once (``estimator.ensemble_params``) unless one
    is given, whose members then set the count; every data batch runs all
    of them in one vmapped forward (:func:`make_ensemble_fn`; a member
    loop where :func:`vmaps` routes the data there), the ensemble
    prepared once. ``sample_chunk`` bounds how many members one call
    holds: a
    drawn ensemble is drawn and run a chunk at a time (JAX's
    ``_eval_bnn_chunked``), a given one is run in chunks. ``stats`` fills
    the reference's running statistics (empty lists otherwise). The call
    is the span ``eval_bnn``."""
    with monitor.span("eval_bnn", samples=samples):
        batches = list(data)
        labels = np.concatenate([np.asarray(y).reshape(-1)
                                 for _, y in batches])
        step = min(sample_chunk or samples, samples)
        if ensemble_params is not None:
            ensembles = _chunks(ensemble_params, sample_chunk or
                                len(ensemble_params))
        else:
            # each chunk drawn when it runs: at most sample_chunk sets exist
            ensembles = (estimator.ensemble_params(min(step, samples - i),
                                                   generator=generator)
                         for i in range(0, samples, step))
        fwd = make_ensemble_fn(model, compute_dtype, mesh)
        total, per_sample, members = None, [], 0
        for ens in ensembles:
            ens = prepare_ensemble(model, ens, batches[0][0], compute_dtype)
            members += ensemble_size(ens)
            s, kept = _ensemble_sums(fwd, ens, batches, stats,
                                     _device(model))
            total = s if total is None else total + s
            if stats:
                per_sample.append(np.concatenate(kept, axis=1))
        stats_list = {"acc": [], "ece": [], "nll": [], "ent": []}
        if stats:
            stats_list = _running_stats(np.concatenate(per_sample, axis=0),
                                        labels, members)
        return total / members, labels, stats_list


def eval_nn_and_bnn(model, estimator, data, samples: int = 30,
                    generator: Optional[torch.Generator] = None,
                    stats: bool = False, compute_dtype=None,
                    sample_chunk: Optional[int] = None, mesh=None):
    """Deterministic and Bayesian predictions over the same data
    (reference eval_nn_and_bnn, evaluate.py:155-170); returns
    (predictions, bnn_predictions, labels, bnn_stats)."""
    batches = list(data)
    predictions, labels = eval_nn(model, batches, compute_dtype, mesh)
    bnn_predictions, _, bnn_stats = eval_bnn(
        model, estimator, batches, samples, generator=generator,
        stats=stats, sample_chunk=sample_chunk, compute_dtype=compute_dtype,
        mesh=mesh)
    return predictions, bnn_predictions, labels, bnn_stats


# -- sufficient-statistics eval (vocab-scale outputs) -------------------------
#: per-token columns: probability of the label (NLL), max probability (ECE
#: bins), argmax == label (accuracy, ECE), entropy (OOD scores)
STATS_COLUMNS = ("p_label", "confidence", "correct", "entropy")


def _probs_to_stats(p2d: torch.Tensor, y) -> torch.Tensor:
    """[N, K] probabilities and [N] labels -> [N, 4] STATS_COLUMNS, on the
    probabilities' device."""
    y = torch.as_tensor(np.asarray(y).reshape(-1), device=p2d.device).long()
    p_label = p2d.gather(1, y[:, None])[:, 0]
    conf = p2d.max(dim=1).values
    correct = (p2d.argmax(dim=1) == y).float()
    ent = -(p2d * torch.log(p2d.clamp_min(1e-12))).sum(dim=1)
    return torch.stack([p_label, conf, correct, ent], dim=1)


@torch.no_grad()
def eval_nn_stats(model, data: Iterable[Tuple], compute_dtype=None,
                  mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`eval_nn` reduced on the device to the [N, 4]
    STATS_COLUMNS; returns (stats, labels [N])."""
    fwd = make_forward_fn(model, compute_dtype, mesh)
    stats, labels = [], []
    for x, y in _batches(data, _device(model)):
        stats.append(_probs_to_stats(fwd(None, x), y).cpu())
        labels.append(y)
    return torch.cat(stats).numpy(), np.concatenate(labels)


@torch.no_grad()
def eval_bnn_stats(model, estimator, data: Iterable[Tuple],
                   samples: int = 30,
                   generator: Optional[torch.Generator] = None,
                   sample_chunk: Optional[int] = None, compute_dtype=None,
                   ensemble_params: Optional[List[Dict]] = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`eval_bnn` reduced on the device: per batch, the sample-mean
    softmax accumulates there and collapses to STATS_COLUMNS. The
    posterior is drawn ``sample_chunk`` members at a time and redrawn for
    every batch from the generator's starting state, so each batch sees
    the same ensemble and at most a chunk of sampled parameter sets
    exists at once (JAX :269-300); each chunk is one vmapped forward
    (:func:`make_ensemble_fn`, routed by :func:`vmaps`). A given ``ensemble_params`` is used as it
    is. Returns (stats [N, 4], labels [N])."""
    device = _device(model)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    start = generator.get_state()
    chunk = min(sample_chunk or samples, samples)

    def ensembles():
        if ensemble_params is not None:
            yield ensemble_params
            return
        generator.set_state(start)
        for i in range(0, samples, chunk):
            yield estimator.ensemble_params(min(chunk, samples - i),
                                            generator=generator)

    fwd = make_ensemble_fn(model, compute_dtype, mesh)
    stats, labels = [], []
    for x, y in _batches(data, device):
        total, members = None, 0
        for ens in ensembles():
            ens = prepare_ensemble(model, ens, x, compute_dtype)
            p = fwd(ens, x).sum(0)
            total = p if total is None else total + p
            members += ensemble_size(ens)
        stats.append(_probs_to_stats(total / members, y).cpu())
        labels.append(y)
    return torch.cat(stats).numpy(), np.concatenate(labels)
