"""``routed_factor_ms.<end-to-end metric>``: per update, the device's
elapsed time summed over the ``factor`` spans of the ``routed`` route (an
MoE expert layer's per-expert Grams) inside its ``update_state`` span, in
ms; the median over the traced run's recorded updates (``spans.py``)."""
from gpubench.spans import program_spans
from gpubench.moe_spans import median_per_update


def read(rec):
    return median_per_update(
        program_spans(), "update_state",
        lambda s: s.name == "factor" and s.attrs.get("route") == "routed")
