"""``factors_host_ms.<end-to-end metric>``: the host's time inside an
update's ``update_state`` span, in a whole step with no synchronize added,
in ms; the median over the traced run's recorded updates (``spans.py``)."""
from gpubench.spans import median_ms, program_spans


def read(rec):
    return median_ms(program_spans(), "update_state", "host")
