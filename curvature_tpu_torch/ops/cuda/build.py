"""Build the CUDA sources under ``csrc/`` into shared libraries and load
them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>.so`` next to the package (``build/`` is git-ignored),
compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a`` at first use;
``csrc/*.cuh`` are headers the sources share.
``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``load(name)`` builds one source if its library is missing or
older than the source, then loads it once per process.
"""
import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    header (``csrc/*.cuh``)."""
    lib = library_path(name)
    inputs = [sources()[name], *CSRC.glob("*.cuh")]
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs))


def build_all(names: Optional[Iterable[str]] = None,
              force: bool = False) -> Dict[str, str]:
    """Compile the given sources (default: all) that are stale, or all of
    them with ``force``, in parallel; returns each library's ``ptxas``
    report. Raises with the compiler output if a build fails."""
    names = [n for n in (names or sources()) if force or _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        # write to a temporary name and rename, so a concurrent reader
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(sources()[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if _stale(name):
        build_all([name])
    return ctypes.CDLL(str(library_path(name)))
