"""Telemetry and seeding: host RAM, device memory, phase timers, traces,
RNG seeds.

Port of ``curvature_tpu/utils/monitor.py`` (the reference's tqdm RAM/VRAM
postfix, utils.py:270-285, and its seeding, utils.py:313-330). ``ram``
reads ``/proc/meminfo`` where JAX asks ``psutil``, with psutil's
definition. :class:`Timer` accumulates wall-clock phases, synchronizing
the devices of what it is told to wait for; :func:`profile_trace` is the
``torch.profiler`` counterpart of ``jax.profiler``'s trace directory.
"""
import contextlib
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch


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
