"""What the CUDA kernel wrappers share: the element types the kernels
take, the chain cap of a tensor-core accumulator, the 3xTF32 operand
split in plain torch ops, the checks of a call's input, the occupancy
query and the wave-filling split count, a library's error check and the
stream a launch goes on.

Every wrapper (``patch_gram``, ``sym_gram``, ``corr_gram``) imports these
from here, never from another wrapper.
"""
import ctypes
from typing import Tuple

import torch

#: element types the kernels take, and the suffix of their C entry
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: the most tokens one block sums in the tensor cores' f32 accumulator; a
#: longer range is split, and the splits are summed in f32 in a fixed order
#: (the accumulator's error grows with the chain: PERF.md)
MAX_CHAIN_TOKENS = 8192


def check_device(x: torch.Tensor, name: str):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device "
                         f"{x.device}")


def check_kernel_dtype(x: torch.Tensor, name: str) -> str:
    """The C entry suffix for ``x``'s dtype; raises for any other."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    return KERNEL_DTYPES[x.dtype]


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernels' operand split in plain torch ops: ``hi`` is ``x``
    rounded to TF32 (10 explicit mantissa bits) to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``, and ``lo`` is ``x - hi`` rounded
    the same way; both have their low 13 bits zero and ``hi + lo`` holds
    ``x`` to ~2^-22. The kernels sum ``lo*hi + hi*lo + hi*hi`` for each
    product."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def resident_slots(device_index: int, blocks_per_sm) -> int:
    """Blocks of a kernel the card holds at once: SMs x ``blocks_per_sm``
    (a C occupancy query filling a ``c_int``)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = blocks_per_sm(ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"occupancy query: CUDA error {rc}")
    sms = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return sms * max(per_sm.value, 1)


def split_count(n_tokens: int, num_tiles: int, slots: int) -> int:
    """Token-chunk split count that best fills whole waves of ``slots``
    resident blocks (the last wave of a grid idles the SMs it leaves
    empty), with at least 256 tokens per split; the fewest splits among
    equals."""
    def fill(s):
        blocks = num_tiles * s
        return blocks / (-(-blocks // slots) * slots)
    return max(range(1, max(1, min(64, n_tokens // 256)) + 1),
               key=lambda s: (round(fill(s), 1), -s))


def check(lib: str, rc: int, name: str):
    """Raises for a nonzero return code ``rc`` of the entry ``name`` of
    ``csrc/<lib>.cu``, with that library's ``<lib>_error_string``."""
    if rc == 0:
        return
    from curvature_tpu_torch.ops.cuda import build
    error_string = getattr(build.load(lib), f"{lib}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    raise RuntimeError(f"{name}: CUDA error {rc}: "
                       f"{error_string(rc).decode()}")


def stream(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as a launch takes it."""
    return torch.cuda.current_stream(x.device).cuda_stream
