"""The device's busy time and the breakdown of stretches of whole steps,
read from ``torch.profiler`` traces.

A stretch opens after a synchronize and closes after its last step's
synchronize; its ends are read on the host's clock (``time.time_ns``, the
clock the traces' timestamps are given in). The first stretch is traced
with the device's activity alone, which costs the host little: every
device event inside it (kernels, copies, sets) counts, ``busy_s`` is the
length of the union of their intervals and ``window_s`` the stretch's,
and it gives the ten device operations that took most time. A second
stretch of one step also records the host's operations, which cost the
host much more per launch: its ten longest idle gaps, each named by the
host ranges open at its start (outermost and innermost).
"""
import time
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every traced event; a
    device event is an operation on the device (a kernel, a copy, a set),
    not the device-side mirror of a host range."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        dev = e.device_type() == cuda
        annotation = getattr(e, "is_user_annotation", None)
        if dev and annotation is not None and annotation():
            continue
        out.append((e.name(), dev, start, start + e.duration_ns()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce(events, marks: Tuple[int, int]) -> Dict:
    """``busy_s``, ``window_s`` and the breakdown of the stretch between
    the host-clock ``marks`` (ns)."""
    s0, s1 = marks
    device, by_name = [], {}
    for name, dev, s, e in events:
        if not dev:
            continue
        s, e = max(s, s0), min(e, s1)
        if e <= s:
            continue
        device.append((s, e))
        by_name[name] = by_name.get(name, 0) + (e - s)
    busy = _union(device)
    gaps, prev = [], s0
    for s, e in busy + [(s1, s1)]:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    host = [(s, e, n) for n, dev, s, e in events if not dev and e > s]

    def doing(t: int) -> str:
        open_ = sorted((s, -e, n) for s, e, n in host if s <= t < e)
        if not open_:
            return "host: no traced range"
        outer, inner = open_[0][2], open_[-1][2]
        return outer if outer == inner else f"{outer} > {inner}"

    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (s1 - s0) / 1e9,
            "device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[doing(t), ns / 1e9] for ns, t in gaps[:TOP]]}


def _profile(step, start: int, seconds: float, sync, window, host: bool):
    """One warm step, then a stretch of whole steps; (events, marks,
    steps in the stretch)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        step(start)
        sync()
        t0 = time.time_ns()
        steps, _ = window(step, seconds, sync, start + 1)
        t1 = time.time_ns()
    return _events(prof), (t0, t1), steps


def profile_steps(step: Callable[[int], None], start: int, seconds: float,
                  sync: Callable[[], None], window) -> Dict:
    """The device's stretch of about ``seconds`` and the host's stretch
    of one step (the module docstring; ``window`` runs the steps): the
    reduction with ``steps`` (the first stretch's), ``ran`` (every step
    run, warm ones included) and ``reduce_s`` (the seconds the traces took
    to read)."""
    events, marks, steps = _profile(step, start, seconds, sync, window,
                                    host=False)
    t0 = time.perf_counter()
    out = reduce(events, marks)
    reduce_s = time.perf_counter() - t0
    nxt = start + 1 + steps
    events, marks, named = _profile(step, nxt, 0.0, sync, window, host=True)
    t0 = time.perf_counter()
    out["idle_gaps"] = reduce(events, marks)["idle_gaps"]
    out.update(steps=steps, ran=steps + named + 2,
               reduce_s=reduce_s + time.perf_counter() - t0)
    return out
