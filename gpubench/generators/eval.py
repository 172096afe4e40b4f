"""The Bayesian eval: ``eval.eval_bnn`` of a posterior ensemble over
seeded batches.

Set-up draws the weights, one fit batch of ``fit_batch`` images with its
labels, ``distinct_batches`` eval batches of the traffic's shape and the
``samples`` members' standard normals from the seed; it runs one
``KFAC.update`` on the fit batch, ``invert`` at the configuration's
damping and ``ensemble_params(samples, noise=...)`` (timed together as the
posterior's seconds), and one eval call to warm up. A step is one
``eval_bnn`` call on the next eval batch in turn: the call lists its data
before it runs, so the window hands it one batch a call.

The program's answers are the calls' mean predictions. After the window a
sample of ``check_batches`` calls, drawn from the seed among the distinct
batches the window reached, is held to the reference: the same factors
from the fit batch, inverse roots, draws and mean softmax.
"""
import random
from typing import Dict, List

import torch

from gpubench import weights as seeded
from gpubench.generators.fit import make_estimator
from gpubench.reference import kfac as ref_kfac


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, traffic, ref = ctx.cfg, ctx.traffic, ctx.family.reference
        self.samples = traffic["samples"]
        clock = ctx.clock()
        self.weights = seeded.make(ref.param_specs(cfg), ctx.rng,
                                   ctx.device)
        self.fit = ref.make_inputs(cfg, dict(traffic,
                                             batch=traffic["fit_batch"]),
                                   ctx.rng, ctx.device)
        self.batches = [ref.make_inputs(cfg, traffic, ctx.rng,
                                        ctx.device)
                        for _ in range(traffic["distinct_batches"])]
        self.layers = ref_kfac.select(ref.layers(cfg),
                                      cfg["estimator"].get("layer_filter"))
        self.noise = seeded.noise(ref_kfac.noise_shapes(self.layers),
                                  self.samples, ctx.rng, ctx.device)
        self.units = ref.units(self.batches[0][0])
        clock("inputs")
        self.model = ctx.family.build(cfg, self.weights, ctx.device)
        self.est = make_estimator(cfg, self.model)
        shapes = {k: tuple(v) for k, v in self.est.noise_shapes().items()}
        if shapes != ref_kfac.noise_shapes(self.layers):
            raise ValueError("the program's noise shapes differ from the "
                             "reference's layers")
        self.data = [(ctx.family.program_input(cfg, x), y.cpu().numpy())
                     for x, y in self.batches]
        clock("program")
        self.est.update(ctx.family.program_input(cfg, self.fit[0]),
                        labels=self.fit[1])
        clock("update")
        self.est.invert(**cfg["damping"])
        self.members = self.est.ensemble_params(self.samples,
                                                noise=self.noise)
        self.posterior_s = clock("posterior")
        self.outputs: List = []
        self.step(0)
        self.outputs.clear()
        clock("warmup")

    def step(self, i: int):
        from curvature_tpu_torch.eval import eval_bnn
        b = i % len(self.data)
        probs, _, _ = eval_bnn(self.model, self.est, [self.data[b]],
                               ensemble_params=self.members)
        self.outputs.append((b, probs))

    def info(self, steps: int) -> Dict:
        return {"posterior_s": self.posterior_s}

    def _sample(self) -> List[int]:
        """Indices of the checked calls: one call of each of up to
        ``check_batches`` distinct batches, drawn from the seed."""
        last = {b: i for i, (b, _) in enumerate(self.outputs)}
        rng = random.Random(self.ctx.seed)
        ids = sorted(last)
        picked = rng.sample(ids, min(self.ctx.traffic["check_batches"],
                                     len(ids)))
        return [last[b] for b in sorted(picked)]

    def result(self):
        """The sampled calls' mean predictions; the program is freed."""
        self.checked = self._sample()
        got = [torch.as_tensor(self.outputs[i][1]) for i in self.checked]
        del self.est, self.model, self.members
        return got

    def expected(self, tf32: bool = False):
        """The reference's mean softmax on the sampled calls' batches."""
        cfg, ref = self.ctx.cfg, self.ctx.family.reference
        xs = [self.batches[self.outputs[i][0]][0] for i in self.checked]
        with self.ctx.precision(tf32):
            facs = ref_kfac.factors(ref, cfg, self.weights, *self.fit,
                                    cfg["estimator"].get("layer_filter"))
            roots = ref_kfac.inverse_roots(facs, **cfg["damping"])
            del facs
            members = (ref_kfac.sample_params(self.weights, self.layers,
                                              roots, z) for z in self.noise)
            probs = ref_kfac.mean_softmax(ref, cfg, members, xs)
        return [p.cpu() for p in probs]

    def failed(self, got) -> int:
        """Checked calls whose predictions are not finite."""
        return sum(int(not torch.isfinite(p).all()) for p in got)


def compare(got, want) -> Dict[str, float]:
    """``probs_rel``: the worst checked call's max |got - want| over max
    |want| of its mean predictions."""
    worst = 0.0
    for g, w in zip(got, want):
        gap = float((g.double() - w.double()).abs().max()
                    / w.double().abs().max())
        worst = max(worst, gap if gap == gap else float("inf"))
    return {"probs_rel": worst}
