"""Telemetry and seeding: host RAM, device memory, RNG seeds.

Port of ``ram``, ``device_memory_gb`` and ``seed_all_rng`` of
``curvature_tpu/utils/monitor.py`` (the reference's tqdm RAM/VRAM postfix,
utils.py:270-285, and its seeding, utils.py:313-330). ``ram`` reads
``/proc/meminfo`` where JAX asks ``psutil``, with psutil's definition.
"""
import os
import random
from typing import Optional

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
