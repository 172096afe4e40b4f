"""``capture_device_ms.<end-to-end metric>``: the device's elapsed time
between the two events of an update's ``capture`` span: its work on the
device and any wait for the host inside it, in ms; the median over the
traced run's recorded updates (``spans.py``)."""
from gpubench.spans import median_ms, program_spans


def read(rec):
    return median_ms(program_spans(), "capture", "device")
