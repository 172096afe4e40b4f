"""``device_idle.<end-to-end metric>``: the share of the profiled stretch
of whole steps in which no operation ran on the device, in % (``trace.py``:
one minus the union of the device events' intervals over the stretch)."""


def read(rec):
    s = rec.get("stretch")
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
