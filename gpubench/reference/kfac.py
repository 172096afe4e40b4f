"""KFAC's Kronecker factors of one batch (Martens and Grosse, 2015; the
convolution form of Grosse and Martens, 2016), the damped inverse roots,
the matrix-normal sample and the posterior ensemble's mean softmax.

For a layer with inputs ``a_n`` (a conv's input patches in (c, kh, kw)
order; a ones column appended where the layer has a bias) and
pre-activation output gradients ``g_n`` of the mean loss, over its N
tokens (a conv's output positions times the batch; a dense layer's rows):

    A = (1 / N) sum_n a_n a_n^T          G = (M^2 / N) sum_n g_n g_n^T

with M the count the mean loss divides by (the batch, or its tokens for a
language model). The labels are given, so each batch is one draw of
labels. The damped inverse root of a factor F at (add, multiply) is
``chol(inv(sqrt(multiply) F + sqrt(add) I))``; a sample of a layer's
``[out, cols]`` weight offset from noise ``z`` [cols, out] is ``(A_root z
G_root^T)^T``. Every sum here runs in blocks of the batch axis.
"""
import fnmatch
import math
from typing import Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from gpubench.reference.layers import Layer, Recorder


def select(layers: Dict[str, Layer], layer_filter) -> Dict[str, Layer]:
    """The layers a filter keeps: all for None, the last for ``"last"``,
    else those whose name matches one of the shell patterns."""
    if layer_filter is None:
        return dict(layers)
    patterns = [layer_filter] if isinstance(layer_filter, str) \
        else list(layer_filter)
    if patterns == ["last"]:
        name = list(layers)[-1]
        return {name: layers[name]}
    return {n: l for n, l in layers.items()
            if any(fnmatch.fnmatch(n, p) for p in patterns)}


def cotangent(logits: torch.Tensor, labels: torch.Tensor, count: int
              ) -> torch.Tensor:
    """d(mean cross-entropy)/d logits: (softmax - onehot) / count."""
    p = torch.softmax(logits.detach(), dim=-1)
    onehot = torch.zeros_like(p).scatter_(-1, labels.long()[..., None], 1.0)
    return (p - onehot) / count


def _a_tokens(layer: Layer, x: torch.Tensor) -> torch.Tensor:
    if layer.kind == "conv":
        p = F.unfold(x, layer.kernel, padding=layer.padding,
                     stride=layer.stride)
        t = p.transpose(1, 2).reshape(-1, layer.fan_in)
    else:
        t = x.reshape(-1, layer.fan_in)
    if layer.bias:
        t = torch.cat([t, t.new_ones(t.shape[0], 1)], dim=1)
    return t


def _g_tokens(layer: Layer, g: torch.Tensor) -> torch.Tensor:
    if layer.kind == "conv":
        g = g.permute(0, 2, 3, 1)
    return g.reshape(-1, layer.out)


def _blocked_gram(tokens, x: torch.Tensor, block: int):
    """(sum of t^T t over the blocks of ``block`` rows of ``x``'s first
    axis, t = tokens(block), the token count)."""
    total, n = None, 0
    for i in range(0, x.shape[0], block):
        t = tokens(x[i:i + block])
        gram = t.T @ t
        total = gram if total is None else total + gram
        n += t.shape[0]
    return total, n


def factors(model, cfg, params: Dict[str, torch.Tensor], x: torch.Tensor,
            labels: torch.Tensor, layer_filter=None, block: int = 16
            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{layer: {"a": A, "g": G}} of one batch; a stacked layer's factors
    ``[depth, side, side]``. ``model`` is a reference model module."""
    chosen = select(model.layers(cfg), layer_filter)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    rec = Recorder()
    logits = model.forward(leaves, x, cfg, train=True, rec=rec)
    count = model.loss_count(x)
    cot = cotangent(logits, labels, count)
    outs = [y for n in chosen for y in rec.outputs[n]]
    grads = iter(torch.autograd.grad(logits, outs, grad_outputs=cot))
    del logits, cot, outs
    out = {}
    with torch.no_grad():
        for name, layer in chosen.items():
            a_list, g_list = [], []
            for act in rec.inputs[name]:
                g = next(grads)
                a, n_a = _blocked_gram(lambda v: _a_tokens(layer, v),
                                       act.detach(), block)
                gg, n_g = _blocked_gram(lambda v: _g_tokens(layer, v), g,
                                        block)
                a_list.append(a / n_a)
                g_list.append(gg * (count ** 2 / n_g))
                del g
            if layer.depth:
                out[name] = {"a": torch.stack(a_list),
                             "g": torch.stack(g_list)}
            else:
                out[name] = {"a": a_list[0], "g": g_list[0]}
    return out


def inverse_root(f: torch.Tensor, add: float, multiply: float
                 ) -> torch.Tensor:
    """chol(inv(sqrt(multiply) F + sqrt(add) I)), batched over leading
    axes."""
    eye = torch.eye(f.shape[-1], dtype=f.dtype, device=f.device)
    d = math.sqrt(multiply) * f + math.sqrt(add) * eye
    return torch.linalg.cholesky(torch.linalg.inv((d + d.mT) / 2))


def inverse_roots(facs, add: float, multiply: float):
    return {n: {"a": inverse_root(f["a"], add, multiply),
                "g": inverse_root(f["g"], add, multiply)}
            for n, f in facs.items()}


def noise_shapes(layers: Dict[str, Layer]) -> Dict[str, tuple]:
    """The standard-normal draw of each layer: [(depth,) cols, out]."""
    return {n: ((l.depth,) if l.depth else ()) + (l.cols, l.out)
            for n, l in layers.items()}


def sample_params(params: Dict[str, torch.Tensor], layers: Dict[str, Layer],
                  roots, noise: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The parameters plus one matrix-normal draw on each layer's weight
    (and bias)."""
    new = dict(params)
    for name, layer in layers.items():
        r = roots[name]
        w = (r["a"] @ noise[name] @ r["g"].mT).mT       # [(depth,) out, cols]
        key = f"{name}.weight"
        new[key] = params[key] + w[..., :layer.fan_in].reshape(
            params[key].shape)
        if layer.bias:
            new[f"{name}.bias"] = params[f"{name}.bias"] + w[..., -1]
    return new


def mean_softmax(model, cfg, members: Iterable[Dict[str, torch.Tensor]],
                 xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The members' mean softmax on each batch of ``xs`` (eval mode), one
    member at a time."""
    total: Optional[List[torch.Tensor]] = None
    count = 0
    with torch.no_grad():
        for p in members:
            probs = [torch.softmax(model.forward(p, x, cfg, train=False)
                                   .float(), dim=-1) for x in xs]
            total = probs if total is None else [
                t + q for t, q in zip(total, probs)]
            count += 1
    return [t / count for t in total]
