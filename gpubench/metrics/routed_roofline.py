"""``routed_roofline.<end-to-end metric>``: the least time of a step's
MoE expert Grams (the A and G factors of every ``.experts.`` layer,
counted from the reference's shapes at the mean routed load, ``work.py``,
at the f32-accurate peak or the memory rate, whichever is slower;
``peaks.py``) over the device time of the ``routed`` factor spans of an
update (``routed_factor_ms``), in %."""
from gpubench import peaks
from gpubench.moe_spans import expert_grams
from gpubench.spans import program_spans
from gpubench.moe_spans import median_per_update


def read(rec):
    work = rec.get("work")
    ms = median_per_update(
        program_spans(), "update_state",
        lambda s: s.name == "factor" and s.attrs.get("route") == "routed")
    if work is None or ms is None:
        return None
    flops, nbytes = expert_grams(work)
    if not flops:
        return None
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ms / 1e3)
