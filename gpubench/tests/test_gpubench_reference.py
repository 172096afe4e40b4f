"""The plain reference against the port on the CPU at tiny widths: the
factors of one update and the posterior's draws in float64 (the port's
normalization layers compute in float32 inside, hence 1e-5 and 1e-6), and
the 30-member-style ensemble's mean softmax in float32 through the member
loop, as the eval cell runs it."""
import pytest
import torch

from gpubench import weights
from gpubench.generators.fit import make_estimator
from gpubench.families import gpt2 as gpt2_family
from gpubench.families import resnet as resnet_family
from gpubench.reference import kfac
from gpubench.tests import tiny

CASES = {
    "resnet-bottleneck": (tiny.resnet, resnet_family, {"batch": 8}),
    "resnet-basic": (tiny.basic_resnet, resnet_family, {"batch": 8}),
    "gpt2": (lambda: tiny.gpt2(damping={"add": 1e3, "multiply": 100.0}),
             gpt2_family, {"batch": 4, "seq_len": 16}),
}


def _f64_fit(name):
    make, family, traffic = CASES[name]
    cfg = make()
    ref = family.reference
    gen = torch.Generator().manual_seed(0)
    w = weights.make(ref.param_specs(cfg), gen, "cpu")
    x, y = ref.make_inputs(cfg, traffic, gen, "cpu")
    w64 = {k: v.double() for k, v in w.items()}
    x64 = x.double() if x.is_floating_point() else x
    model = family.build(cfg, w, "cpu").double()
    est = make_estimator(dict(cfg, estimator=dict(cfg["estimator"],
                                                  dtype=torch.float64)),
                         model)
    est.update(family.program_input(cfg, x64), labels=y)
    want = kfac.factors(ref, cfg, w64, x64, y,
                        cfg["estimator"]["layer_filter"])
    return cfg, ref, gen, w64, est, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_factors_match_the_port(name):
    _, _, _, _, est, want = _f64_fit(name)
    assert set(est.state) == set(want)
    for layer, facs in want.items():
        for k, t in facs.items():
            got = est.state[layer][k]
            assert got.shape == t.shape
            gap = float((got - t).abs().max() / t.abs().max())
            assert gap < 1e-5, (layer, k, gap)


@pytest.mark.parametrize("name", sorted(CASES))
def test_draws_match_the_port(name):
    cfg, ref, gen, w64, est, want = _f64_fit(name)
    layers = kfac.select(ref.layers(cfg), cfg["estimator"]["layer_filter"])
    z = weights.noise(kfac.noise_shapes(layers), 2, gen, "cpu",
                      torch.float64)
    assert {k: tuple(v) for k, v in est.noise_shapes().items()} \
        == kfac.noise_shapes(layers)
    est.invert(**cfg["damping"])
    members = est.ensemble_params(2, noise=z)
    roots = kfac.inverse_roots(want, **cfg["damping"])
    for got, draw in zip(members, z):
        expect = kfac.sample_params(w64, layers, roots, draw)
        for key, t in got.items():
            offset = expect[key] - w64[key]
            gap = float((t - expect[key]).abs().max() / offset.abs().max())
            assert gap < 1e-6, (key, gap)


def test_ensemble_softmax_matches_the_port():
    from curvature_tpu_torch.eval import eval_bnn, evaluate
    cfg = tiny.resnet(image_size=128)
    ref = resnet_family.reference
    gen = torch.Generator().manual_seed(1)
    w = weights.make(ref.param_specs(cfg), gen, "cpu")
    x, y = ref.make_inputs(cfg, {"batch": 8}, gen, "cpu")
    model = resnet_family.build(cfg, w, "cpu")
    est = make_estimator(cfg, model)
    est.update(resnet_family.program_input(cfg, x), labels=y)
    layers = kfac.select(ref.layers(cfg), None)
    z = weights.noise(kfac.noise_shapes(layers), 3, gen, "cpu")
    est.invert(**cfg["damping"])
    members = est.ensemble_params(3, noise=z)
    xp = resnet_family.program_input(cfg, x)
    assert not evaluate.vmaps(model, xp)      # the member loop, as at 224^2
    got, _, _ = eval_bnn(model, est, [(xp, y.numpy())],
                         ensemble_params=members)
    roots = kfac.inverse_roots(kfac.factors(ref, cfg, w, x, y),
                               **cfg["damping"])
    want = kfac.mean_softmax(
        ref, cfg, (kfac.sample_params(w, layers, roots, d) for d in z),
        [x])[0]
    gap = float((torch.as_tensor(got) - want).abs().max() / want.max())
    assert gap < 1e-5, gap
    # the draws move the predictions far beyond that gap
    map_probs = kfac.mean_softmax(ref, cfg, [w], [x])[0]
    assert float((want - map_probs).abs().max()) > 1e-3
