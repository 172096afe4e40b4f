"""The factor pass: ``KFAC.update`` over seeded batches with given labels.

Set-up draws the weights and ``distinct_batches`` batches of the traffic's
shape from the seed, builds the program's model and estimator as the
configuration states, and runs ``warmup_steps`` updates. A step is one
``update`` of the next batch in turn. The traced run's split step calls
the update's two public halves, ``capture`` and ``update_state`` on that
capture (what ``update`` does on one process), each timed on the host
after a synchronize.

The program's answer is its factor state after the window. Every update
adds one batch's factors, so the reference's answer is the sum over the
distinct batches of each batch's factors times the updates it went
through, set-up's included.
"""
import time
from typing import Dict

import torch

from gpubench import weights as seeded
from gpubench.reference import kfac as ref_kfac

#: kernel launch counters of the program's Gram wrappers, read before and
#: after the window (attribute names on ``ops.cuda.patch_gram``)
COUNTERS = (("patch_gram_tiled", "launches"), ("patch_gram_v2", "launches"),
            ("patch_gram", "launches"))


def make_estimator(cfg, model):
    from curvature_tpu_torch import estimators
    spec = dict(cfg["estimator"])
    return getattr(estimators, spec.pop("kind"))(model, **spec)


def launch_counts() -> Dict[str, int]:
    from curvature_tpu_torch.ops.cuda import patch_gram
    return {name: getattr(getattr(patch_gram, name), attr)
            for name, attr in COUNTERS}


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, traffic, ref = ctx.cfg, ctx.traffic, ctx.family.reference
        clock = ctx.clock()
        self.weights = seeded.make(ref.param_specs(cfg), ctx.rng,
                                   ctx.device)
        self.batches = [ref.make_inputs(cfg, traffic, ctx.rng,
                                        ctx.device)
                        for _ in range(traffic["distinct_batches"])]
        self.units = ref.units(self.batches[0][0])
        clock("inputs")
        self.model = ctx.family.build(cfg, self.weights, ctx.device)
        self.est = make_estimator(cfg, self.model)
        self.inputs = [ctx.family.program_input(cfg, x)
                       for x, _ in self.batches]
        self.counts = [0] * len(self.batches)
        clock("program")
        for i in range(traffic["warmup_steps"]):
            self.step(i)
        clock("warmup")
        self.launches0 = launch_counts()

    def step(self, i: int):
        b = i % len(self.batches)
        self.est.update(self.inputs[b], labels=self.batches[b][1])
        self.counts[b] += 1

    def split_step(self, i: int) -> Dict[str, float]:
        """One update as its capture and its factor step, each timed."""
        b = i % len(self.batches)
        sync = self.ctx.sync
        sync()
        t0 = time.perf_counter()
        cap = self.est.capture(self.inputs[b], labels=self.batches[b][1])
        sync()
        t1 = time.perf_counter()
        with torch.no_grad():
            self.est.update_state(self.est.state, cap)
        sync()
        t2 = time.perf_counter()
        self.counts[b] += 1
        return {"capture_s": t1 - t0, "update_state_s": t2 - t1}

    def info(self, steps: int) -> Dict:
        """Gram-kernel launches per update over the window's ``steps``."""
        now = launch_counts()
        return {"gram_launches_per_update": {
            k: (now[k] - self.launches0[k]) / max(steps, 1) for k in now}}

    def result(self):
        """The program's factor state; the program is freed."""
        state = self.est.state
        del self.est, self.model
        return state

    def expected(self, tf32: bool = False):
        """The reference's factor state for the same updates, computed
        with TF32 on where ``tf32`` (the control)."""
        cfg, ref = self.ctx.cfg, self.ctx.family.reference
        total = None
        with self.ctx.precision(tf32):
            for (x, y), n in zip(self.batches, self.counts):
                if not n:
                    continue
                facs = ref_kfac.factors(ref, cfg, self.weights, x, y,
                                        cfg["estimator"].get("layer_filter"))
                if total is None:
                    total = {k: {f: n * t for f, t in v.items()}
                             for k, v in facs.items()}
                else:
                    for k, v in facs.items():
                        for f, t in v.items():
                            total[k][f].add_(t, alpha=n)
                del facs
        return total

    def failed(self, got) -> int:
        """Factor leaves that are not finite."""
        return sum(int(not torch.isfinite(t).all())
                   for v in got.values() for t in v.values())


def _worst(got, want, factor: str) -> float:
    """The worst factor of kind ``factor`` (one per layer and depth) by
    the Frobenius norm of the gap over the reference's."""
    worst = 0.0
    for name, w in want.items():
        g_t, w_t = got[name][factor], w[factor]
        if w_t.ndim == 2:
            g_t, w_t = g_t[None], w_t[None]
        for g_i, w_i in zip(g_t, w_t):
            w_i = w_i.double()
            gap = float((g_i.double() - w_i).norm() / w_i.norm())
            worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def compare(got, want) -> Dict[str, float]:
    """``a_rel`` and ``g_rel``: the worst A and the worst G factor's
    relative gap, ||got - want||_F / ||want||_F."""
    if set(got) != set(want):
        raise ValueError("factor layers differ: "
                         f"{sorted(set(got) ^ set(want))}")
    return {"a_rel": _worst(got, want, "a"), "g_rel": _worst(got, want, "g")}
