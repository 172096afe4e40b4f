"""Stock ``torch.nn.Module``s through ``nn.adapter.from_torch``, against
JAX's ``from_flax`` and ``from_haiku`` on the same weights and inputs.

The counterparts of tests/test_flax_adapter.py and
tests/test_haiku_adapter.py: their CNN (conv 3x3 SAME -> ReLU -> 2x2
average pool -> flatten -> dense 16 -> ReLU -> dense 3) is written once
from ``nn.Conv2d``, ``nn.ReLU``, ``nn.AvgPool2d`` and ``nn.Linear`` (the
pooled map permuted to NHWC before the flatten, so ``hidden``'s columns
take JAX's order), its weights carried over from the flax and haiku
models (HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``). The forward, the
captured ``hidden`` gradient, and the KFAC, Diagonal and EFB factors (EFB
on JAX's KFAC factors, with JAX's eigenvectors: eigh's basis is free
inside degenerate eigenspaces) equal JAX's at 1e-5 of max; INF's invert
and sample are finite; ``from_torch`` leaves the module's parameters,
buffers and mode as they were, a BatchNorm's running statistics through
a capture too.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from curvature_tpu import estimators as jest
from curvature_tpu.estimators.capture import collect as jcollect
from curvature_tpu_torch import estimators
from curvature_tpu_torch.estimators.capture import collect
from curvature_tpu_torch.models import state_from_jax
from curvature_tpu_torch.nn.adapter import from_torch

torch.set_num_threads(1)

fnn = pytest.importorskip("flax.linen")
hk = pytest.importorskip("haiku")

REL = 1e-5


class StockCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 4, 3, padding=1)
        self.act = nn.ReLU()
        self.pool = nn.AvgPool2d(2)
        self.hidden = nn.Linear(64, 16)
        self.head = nn.Linear(16, 3)

    def forward(self, x):
        x = self.pool(self.act(self.conv1(x)))
        x = torch.flatten(x.permute(0, 2, 3, 1), 1)   # NHWC order
        return self.head(self.act(self.hidden(x)))


class FlaxCNN(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(4, (3, 3), padding="SAME", name="conv1")(x)
        x = fnn.relu(x)
        x = fnn.avg_pool(x, (2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        x = fnn.Dense(16, name="hidden")(x)
        x = fnn.relu(x)
        return fnn.Dense(3, name="head")(x)


def _haiku_forward(x):
    x = hk.Conv2D(4, kernel_shape=3, padding="SAME", name="conv1")(x)
    x = jax.nn.relu(x)
    x = hk.avg_pool(x, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    x = x.reshape((x.shape[0], -1))
    x = jax.nn.relu(hk.Linear(16, name="hidden")(x))
    return hk.Linear(3, name="head")(x)


def _stock_from(params, kernel, bias):
    """A StockCNN holding JAX's weights ({layer: {kernel, bias}} under the
    given leaf names)."""
    m = StockCNN()
    with torch.no_grad():
        for name in ("conv1", "hidden", "head"):
            k = np.asarray(params[name][kernel])
            k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            getattr(m, name).weight.copy_(torch.from_numpy(k.copy()))
            getattr(m, name).bias.copy_(
                torch.from_numpy(np.asarray(params[name][bias]).copy()))
    return m


def _flax():
    from curvature_tpu.nn.flax_adapter import from_flax
    fmodel = FlaxCNN()
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 8, 8, 2))
    fvars = fmodel.init(jax.random.PRNGKey(0), x)
    model, variables = from_flax(fmodel, fvars, x)
    return (lambda xx: fmodel.apply(fvars, xx)), model, variables, x, \
        _stock_from(fvars["params"], "kernel", "bias")


def _haiku():
    from curvature_tpu.nn.haiku_adapter import from_haiku
    transformed = hk.transform(_haiku_forward)
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 8, 8, 2))
    params = transformed.init(jax.random.PRNGKey(0), x)
    model, variables = from_haiku(transformed, params, x)
    return (lambda xx: transformed.apply(params, None, xx)), model, \
        variables, x, _stock_from(params, "w", "b")


@pytest.fixture(scope="module", params=["flax", "haiku"])
def pair(request):
    apply, jm, jv, x, stock = _flax() if request.param == "flax" \
        else _haiku()
    xt = torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2).copy())
    return dict(apply=apply, jm=jm, jv=jv, x=x, stock=stock, xt=xt,
                model=from_torch(stock, xt))


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want,
                               atol=REL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_forward_and_metas_match_jax(pair):
    _close(pair["model"](pair["xt"]), pair["apply"](pair["x"]), "logits")
    metas = pair["model"].metas
    assert set(metas) == {"conv1", "hidden", "head"}
    assert metas["conv1"].kind == "conv"
    for name, m in metas.items():
        jmeta = pair["jm"].metas[name]
        assert (m.out_features, m.fan_in, m.has_bias) == \
            (jmeta.out_features, jmeta.fan_in, jmeta.has_bias), name


def test_param_grads_match_jax_capture(pair):
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    cap = collect(pair["model"], pair["model"].metas, pair["xt"],
                  labels=labels)
    jcap = jcollect(pair["jm"], pair["jm"].metas, pair["jv"], pair["x"],
                    labels=jnp.asarray(labels))
    for name in ("conv1", "hidden", "head"):
        _close(cap.param_grads[name][0], jcap.param_grads[name][0], name)


def test_kfac_diag_efb_factors_match_jax(pair):
    labels = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8),
                                           0, 3))
    jm, jv, model = pair["jm"], pair["jv"], pair["model"]
    jk = jest.KFAC(jm, jv)
    jk.update(pair["x"], labels=jnp.asarray(labels))
    tk = estimators.KFAC(model, use_kernels=False)
    tk.update(pair["xt"], labels=labels)
    jd = jest.Diagonal(jm, jv)
    jd.update(pair["x"], labels=jnp.asarray(labels))
    td = estimators.Diagonal(model)
    td.update(pair["xt"], labels=labels)
    je = jest.EFB(jm, jv, jk.state)
    je.update(pair["x"], labels=jnp.asarray(labels))
    te = estimators.EFB(model, state_from_jax(jk.state, "cpu"))
    te.eigvecs = state_from_jax(je.eigvecs, "cpu")
    te.update(pair["xt"], labels=labels)
    for name in ("conv1", "hidden", "head"):
        for k in ("a", "g"):
            _close(tk.state[name][k], jk.state[name][k], f"kfac {name}/{k}")
        _close(td.state[name], jd.state[name], f"diag {name}")
        _close(te.state[name], je.state[name], f"efb {name}")
        _close(te.diags[name], je.diags[name], f"efb diags {name}")
    inf = estimators.INF(model, td.state, tk.state, te.state,
                         eigvecs=te.eigvecs)
    inf.update(rank=10)
    inf.invert(add=10.0, multiply=10.0)
    s = inf.sample(generator=torch.Generator().manual_seed(4))
    assert all(torch.isfinite(v).all() for v in s.values())
    tk.invert(add=1.0, multiply=1.0)
    p = tk.posterior_params(generator=torch.Generator().manual_seed(2))
    out = torch.func.functional_call(model, p, (pair["xt"],))
    assert torch.isfinite(out).all()


def test_from_torch_leaves_the_module_as_it_was():
    """Parameters, buffers (a BatchNorm's running statistics through a
    train-mode capture) and the module's mode are untouched."""
    torch.manual_seed(0)
    stock = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.BatchNorm2d(4),
                          nn.ReLU(), nn.Flatten(), nn.Linear(4 * 6 * 6, 5))
    stock.eval()
    x = torch.randn(4, 3, 6, 6)
    before = {k: v.clone() for k, v in stock.state_dict().items()}
    model = from_torch(stock, x)
    assert set(model.metas) == {"0", "4"}
    assert dict(model.named_parameters()).keys() == \
        dict(stock.named_parameters()).keys()
    est = estimators.KFAC(model, use_kernels=False)
    est.update(x, labels=np.array([0, 1, 2, 3]))
    diag = estimators.Diagonal(model)
    diag.update(x, labels=np.array([0, 1, 2, 3]))
    assert not stock.training
    for k, v in stock.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(torch.isfinite(t).all() for f in est.state.values()
               for t in f.values())
