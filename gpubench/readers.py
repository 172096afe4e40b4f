"""What the metric readers under ``metrics/`` share. A reader's
``read(rec)`` takes the run's record (the harness's ``rec``: the generator,
the unit, the set-up seconds, the window and, in a traced run, the split
steps' host times, the profiled stretch and the step's counted work) and
returns the metric, or None where the run has nothing for it to read."""


def rate(rec, generator: str, unit: str):
    """Units of work through the window over the window's seconds (every
    step's work, each step ending inside the window), for a run of
    ``generator`` whose steps are counted in ``unit``."""
    if rec["generator"] != generator or rec["unit"] != unit:
        return None
    w = rec["window"]
    return w["steps"] * rec["units_per_step"] / w["seconds"]


def mean_ms(rec, key: str):
    """The mean of a split step's host times, in ms."""
    times = rec.get("split", {}).get(key)
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
