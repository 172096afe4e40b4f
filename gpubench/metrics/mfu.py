"""``mfu.<end-to-end metric>``: a step's FLOPs counted from the layer
shapes (``work.py``: the fit's forward, input-gradient backward and factor
Grams; the eval's ``samples`` forwards), times the steps per second of the
traced run's first stretch of whole steps, over the f32-accurate peak, in
%."""
from gpubench import peaks


def read(rec):
    work = rec.get("work")
    if work is None:
        return None
    if rec["generator"] == "fit":
        flops = work.fit_flops()
    else:
        flops = work.eval_flops(rec["traffic"]["samples"])
    w = rec["window"]
    return 100.0 * flops * w["steps"] / w["seconds"] \
        / peaks.F32_ACCURATE_FLOPS
