"""``capture_ms.<end-to-end metric>``: the mean host time of
``KFAC.capture`` (one forward with zero probes, the backward over them),
each call between two synchronizes, over the traced run's split steps."""
from gpubench.readers import mean_ms


def read(rec):
    return mean_ms(rec, "capture_s")
