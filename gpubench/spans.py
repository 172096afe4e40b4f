"""Per-update phase times read from the program's own spans
(``curvature_tpu_torch.utils.monitor``): an update is its ``capture`` and
its ``update_state`` span, both carrying the update's ``step``. The
program records spans only while a profiler runs, so in a traced run they
come from the profiled stretches (their warm steps and the one step with
the host's operations included); a phase's value is the median over the
updates that recorded both phases, so that slowed step does not move it.
"""
import statistics
from typing import Optional

#: the two phase spans of one update
PHASES = ("capture", "update_state")


def program_spans():
    """The spans the program recorded, or None where it has no recorder."""
    from curvature_tpu_torch.utils import monitor
    read = getattr(monitor, "spans", None)
    return None if read is None else read()


def median_ms(spans, phase: str, clock: str) -> Optional[float]:
    """The median over updates of ``phase`` (one of :data:`PHASES`) in ms:
    with ``clock`` ``"host"`` the span's host time, with ``"device"`` the
    elapsed time between its two device events; None where no update
    recorded both phases (or, on the device clock, timed none)."""
    steps = {}
    for s in spans or ():
        if s.name in PHASES and "step" in s.attrs:
            steps.setdefault(s.attrs["step"], {})[s.name] = s
    times = []
    for phases in steps.values():
        if len(phases) < len(PHASES):
            continue
        s = phases[phase]
        ms = (s.end_ns - s.start_ns) / 1e6 if clock == "host" \
            else s.device_ms
        if ms is not None:
            times.append(ms)
    return statistics.median(times) if times else None
