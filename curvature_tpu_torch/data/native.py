"""ctypes binding of the native data-path library (``native/decoder.cpp``).

Port of ``curvature_tpu/data/native.py``. The source is built with ``g++``
at first use into the git-ignored ``build/`` (beside the CUDA libraries,
``ops/cuda/build.py``), with ``native/build.sh``'s flags; ``native/`` is
never written. ``-march=native`` ties a library to its host's CPU, so its
name carries a tag of the host's CPU flags (a copy of ``build/`` on
another machine builds its own). Where JAX falls back to numpy without a
word when the build fails, a failed build here raises with the compiler's
output. Each entry point has its plain numpy version beside it
(``*_plain``), which the CPU tests hold it against.
"""
import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from curvature_tpu_torch.ops.cuda.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "decoder.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")


@functools.lru_cache(maxsize=None)
def _host_tag() -> str:
    """8 hex digits of the machine type and the CPU flags
    ``-march=native`` compiles for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f
                          if line.startswith(("flags", "Features"))), "")
    except OSError:
        pass
    return hashlib.sha1((platform.machine() + flags).encode()).hexdigest()[:8]


def library_path() -> Path:
    return BUILD_DIR / f"libcurvdata-{_host_tag()}.so"


def build() -> Path:
    """Compile ``native/decoder.cpp`` into :func:`library_path` (written
    under a temporary name and renamed, so a concurrent reader never loads
    half a library). Raises with the compiler's output if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run for {SOURCE}: {e}") from e
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{out.stdout}"
                           f"{out.stderr}")
    os.replace(tmp, library_path())
    return library_path()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing or older than its
    source."""
    lib_path = library_path()
    if not lib_path.exists() \
            or lib_path.stat().st_mtime < SOURCE.stat().st_mtime:
        build()
    lib = ctypes.CDLL(str(lib_path))
    lib.ct_decode_idx.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int]
    lib.ct_decode_cifar.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]
    lib.ct_normalize_nhwc3.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int]
    return lib


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def decode_idx(raw: np.ndarray) -> np.ndarray:
    """[n, ...] uint8 -> float32 in [0, 1] (``x * (1/255)``)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(raw.shape, np.float32)
    n = raw.shape[0]
    _lib().ct_decode_idx(raw.ctypes.data, n, int(raw.size // max(n, 1)),
                         out.ctypes.data, _threads())
    return out


def decode_idx_plain(raw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(raw, np.uint8).astype(np.float32) / 255.0


def decode_cifar(raw: np.ndarray, mean: Optional[np.ndarray] = None,
                 std: Optional[np.ndarray] = None) -> np.ndarray:
    """CIFAR records [n, 3072] CHW uint8 -> [n, 32, 32, 3] NHWC float32,
    optionally channel-normalized in the same pass."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.shape[0]
    out = np.empty((n, 32, 32, 3), np.float32)
    m = s = None
    if mean is not None:
        m = np.ascontiguousarray(mean, np.float32)
        s = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    _lib().ct_decode_cifar(raw.ctypes.data, n, out.ctypes.data,
                           m.ctypes.data if m is not None else None,
                           s.ctypes.data if s is not None else None,
                           _threads())
    return out


def decode_cifar_plain(raw: np.ndarray, mean: Optional[np.ndarray] = None,
                       std: Optional[np.ndarray] = None) -> np.ndarray:
    x = np.ascontiguousarray(raw, np.uint8).reshape(-1, 3, 32, 32)
    x = x.transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    if mean is not None:
        x = (x - mean) / std
    return x


def normalize_nhwc3(x: np.ndarray, mean: np.ndarray,
                    std: np.ndarray) -> np.ndarray:
    """Channel normalization of a C-contiguous NHWC float32 RGB batch, in
    place (returns ``x``); any other array takes the plain version."""
    if x.dtype != np.float32 or x.shape[-1] != 3 \
            or not x.flags.c_contiguous:
        return normalize_nhwc3_plain(x, mean, std)
    inv = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    m = np.ascontiguousarray(mean, np.float32)
    _lib().ct_normalize_nhwc3(x.ctypes.data, x.size // 3, m.ctypes.data,
                              inv.ctypes.data, _threads())
    return x


def normalize_nhwc3_plain(x: np.ndarray, mean: np.ndarray,
                          std: np.ndarray) -> np.ndarray:
    return ((x - mean) / std).astype(np.float32)
