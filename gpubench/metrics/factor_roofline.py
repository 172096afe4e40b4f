"""``factor_roofline.<end-to-end metric>``: the least time of a step's
factor Grams (every A and G factor of every tracked layer counted from the
layer shapes, at the f32-accurate peak or the memory rate, whichever is
slower; ``work.py``) over the mean host time of ``update_state`` on a
capture, each call between two synchronizes, in %."""
from gpubench.readers import mean_ms


def read(rec):
    ms = mean_ms(rec, "update_state_s")
    if ms is None or "work" not in rec:
        return None
    return 100.0 * rec["work"].factor_seconds() / (ms / 1e3)
