"""What the MoE cell's readers share: per-update sums of the device time
of the program's spans nested in a phase span (``spans.py``), and the
expert layers' Grams among a step's counted work (``work.py``)."""
import statistics
from typing import Callable, Optional

from gpubench import peaks


def median_per_update(spans, phase: str, pick: Callable) -> Optional[float]:
    """The median over updates of the device ms summed over the spans that
    ``pick`` keeps inside the update's ``phase`` span (at any depth), over
    the updates that recorded such a span; None where none did (a program
    without those spans)."""
    spans = list(spans or ())
    by_id = {s.id: s for s in spans}
    sums = {}
    for s in spans:
        if not pick(s) or s.device_ms is None:
            continue
        up = by_id.get(s.parent)
        while up is not None and not (up.name == phase
                                      and "step" in up.attrs):
            up = by_id.get(up.parent)
        if up is not None:
            sums[up.id] = sums.get(up.id, 0.0) + s.device_ms
    return statistics.median(sums.values()) if sums else None


def expert_grams(work):
    """(FLOPs, bytes) of the counted Grams of the MoE expert layers (names
    holding ``.experts.``)."""
    grams = [g for g in work.grams if ".experts." in g[0]]
    return (sum(peaks.gram_flops(n, side) for _, _, n, side, _ in grams),
            sum(b for *_, b in grams))
