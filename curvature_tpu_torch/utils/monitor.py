"""Telemetry and seeding: host RAM, device memory, phase timers, traces,
spans, RNG seeds.

Port of ``curvature_tpu/utils/monitor.py`` (the reference's tqdm RAM/VRAM
postfix, utils.py:270-285, and its seeding, utils.py:313-330). ``ram``
reads ``/proc/meminfo`` where JAX asks ``psutil``, with psutil's
definition. :class:`Timer` accumulates wall-clock phases, synchronizing
the devices of what it is told to wait for; :func:`profile_trace` is the
``torch.profiler`` counterpart of ``jax.profiler``'s trace directory.

:func:`span` marks a stretch of the program (an update's ``capture`` and
``update_state``, each layer's ``factor``, ``invert``, ``sample``, the
eval's forwards). It records only while a ``torch.profiler`` session runs
or inside :func:`tracing`; otherwise it costs one flag check, as does
:func:`annotate`, which adds attributes to the innermost open span. A recorded
span keeps its id, its parent's id, its name, its start and end on the
host's ``time.time_ns`` clock (the clock the profiler's timestamps are
given in) and its attributes in a bounded in-memory buffer; under a
profiler it is also a ``record_function`` range, so the trace and its
idle gaps carry its name. :func:`spans` reads the buffer without clearing
it, :func:`clear_spans` empties it.
"""
import contextlib
import itertools
import os
import random
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def ram() -> float:
    """System RAM utilization in percent: (total - available) / total,
    psutil's ``virtual_memory().percent``."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            info[key] = float(rest.split()[0])
    return 100.0 * (info["MemTotal"] - info["MemAvailable"]) \
        / info["MemTotal"]


def device_memory_gb(device=None) -> float:
    """Bytes allocated by torch on a CUDA device, in GB (0 for the CPU)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / 1024.0 ** 3


def _devices(tree, out):
    """The CUDA devices of the tensors in ``tree`` (a tensor, or dicts,
    lists and tuples of them)."""
    if torch.is_tensor(tree):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


class Timer:
    """Accumulating phase timer: ``times[name]`` sums the seconds of every
    ``phase(name)`` block. ``block_on`` (a tensor or a tree of them) has
    its CUDA devices synchronized before the clock stops, so queued work
    is counted (JAX's ``block_until_ready``)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        for dev in _devices(block_on, set()):
            torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) \
            + time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activities, and CUDA
    ones where a card is present); on exit the trace is written under
    ``log_dir`` by ``torch.profiler.tensorboard_trace_handler`` (a
    ``*.pt.trace.json`` Chrome trace, as ``jax.profiler`` writes its trace
    directory). Yields the profiler."""
    from torch import profiler
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    handler = profiler.tensorboard_trace_handler(log_dir)
    with profiler.profile(activities=activities,
                          on_trace_ready=handler) as prof:
        yield prof


#: the most spans the buffer holds; later ones are counted, not kept
MAX_SPANS = 1 << 20
#: attributes whose values a span's profiler name carries after its name
LABEL_ATTRS = ("side", "layer", "route")


class Span(NamedTuple):
    """One recorded span: ``parent`` is the id of the span open around it
    on its thread (None at the top); ``start_ns``/``end_ns`` are
    ``time.time_ns`` stamps; ``device_ms`` is the elapsed time between the
    span's two CUDA events where it timed a device (None otherwise)."""
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    attrs: Dict
    device_ms: Optional[float]


class _Recorder:
    """The spans' buffer: closed spans as lists ``[id, parent, name,
    start_ns, end_ns, attrs, device]``, ``device`` a pair of CUDA events
    until :func:`spans` resolves it to ms."""

    def __init__(self):
        self.forced = 0
        self.buffer: List[list] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> List["_Span"]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_REC = _Recorder()


class _Span:
    """A recording span (:func:`span`)."""

    def __init__(self, name: str, device, attrs: Dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self):
        attrs = self.attrs
        if "shape" in attrs:
            attrs["shape"] = list(attrs["shape"])
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            label = " ".join([self.name] + [str(attrs[k])
                                            for k in LABEL_ATTRS
                                            if k in attrs])
            self.range = torch.profiler.record_function(label)
            self.range.__enter__()
        self.events = None
        device = self.device
        if device is not None and torch.device(device).type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(device))
        stack = _REC.stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_REC.ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _REC.stack().pop()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.range is not None:
            self.range.__exit__(*exc)
        with _REC.lock:
            if len(_REC.buffer) < MAX_SPANS:
                _REC.buffer.append([self.id, self.parent, self.name,
                                    self.start, end, self.attrs,
                                    self.events])
            else:
                _REC.dropped += 1
        return False


_OFF = contextlib.nullcontext()


def span(name: str, device=None, **attrs):
    """A context manager marking a stretch of the program as ``name`` with
    ``attrs`` (plain values; a ``shape`` is kept as a list). It records
    only while a ``torch.profiler`` session runs or inside
    :func:`tracing`, and otherwise does nothing past that check. Under a
    profiler it is also a ``record_function`` range named ``name``
    followed by the span's :data:`LABEL_ATTRS` values (``factor a
    layer2.1.conv2 corr``). ``device`` (a CUDA device) records a pair of
    timing events on its current stream at entry and exit, so the span
    also gives the device's elapsed time over it; a CPU device records
    none."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


def annotate(name: str, **attrs):
    """Adds ``attrs`` to the innermost span open on this thread where it is
    a ``name`` span and spans are recording (what a stretch learns only
    once it has begun, such as which Gram a factor took); otherwise does
    nothing past those checks."""
    if not (_REC.forced or _autograd_profiler._is_profiler_enabled):
        return
    stack = _REC.stack()
    if stack and stack[-1].name == name:
        stack[-1].attrs.update(attrs)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block without a profiler."""
    _REC.forced += 1
    try:
        yield
    finally:
        _REC.forced -= 1


def spans() -> List[Span]:
    """The recorded spans in the order they closed (children before their
    parent), without clearing them; the device-timed ones resolved after
    one synchronize."""
    with _REC.lock:
        recs = list(_REC.buffer)
    pending = [r for r in recs if isinstance(r[6], tuple)]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r[6] = r[6][0].elapsed_time(r[6][1])
    return [Span(r[0], r[1], r[2], r[3], r[4], dict(r[5]), r[6])
            for r in recs]


def dropped_spans() -> int:
    """Spans closed while the buffer was full (:data:`MAX_SPANS`)."""
    return _REC.dropped


def clear_spans():
    """Empty the buffer and its count of dropped spans."""
    with _REC.lock:
        _REC.buffer.clear()
        _REC.dropped = 0


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed the numpy, python and torch RNGs; an entropy-mixed seed when
    None."""
    if seed is None:
        from datetime import datetime
        seed = (os.getpid() + int(datetime.now().strftime("%S%f"))
                + int.from_bytes(os.urandom(2), "big")) % (2 ** 31)
    np.random.seed(seed % (2 ** 32))
    random.seed(seed)
    torch.manual_seed(seed)
    return seed
