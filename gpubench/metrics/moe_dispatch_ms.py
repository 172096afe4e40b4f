"""``moe_dispatch_ms.<end-to-end metric>``: per update, the device's
elapsed time summed over the ``moe.dispatch`` and ``moe.combine`` spans of
every MoE layer (the routing sort and gather, and the weighted sum back)
inside its ``capture`` span, in ms; the median over the traced run's
recorded updates (``spans.py``)."""
from gpubench.spans import program_spans
from gpubench.moe_spans import median_per_update


def read(rec):
    return median_per_update(
        program_spans(), "capture",
        lambda s: s.name in ("moe.dispatch", "moe.combine"))
