"""The card's peaks and the least time of a piece of work.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit): 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s FP32 outside
them, 3.35 TB/s of HBM3. The f32-accurate peak is the TF32 rate over 3: a
float32 product kept to f32 accuracy on the tensor cores takes three TF32
products (3xTF32), the way the measured program's f32 Gram kernels run.
No f32-accurate implementation computes faster, so a share of it cannot
pass 100% for work counted as done. A share of the FP32-FMA peak could,
once f32 work moves to the tensor cores.
"""

TF32_FLOPS = 495e12
F32_ACCURATE_FLOPS = TF32_FLOPS / 3
BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of the operations at the f32-accurate peak and the bytes
    at the memory rate."""
    return max(flops / F32_ACCURATE_FLOPS, nbytes / BYTES_S)


def gram_flops(tokens: int, side: int) -> int:
    """FLOPs of the lower triangle, diagonal included, of a ``[side,
    side]`` Gram over ``tokens`` rows: two per multiply-add."""
    return tokens * side * (side + 1)


def gram_bytes(in_elements: int, side: int, itemsize: int = 4) -> int:
    """The input read once and the f32 output written once."""
    return in_elements * itemsize + side * side * 4


def gram_bound(shape, kernel_size, strides, pads, itemsize: int = 4):
    """(FLOPs, bytes) of a patch Gram of an NHWC input ``shape`` with its
    ones column, ``[F + 1, F + 1]``, F = C kh kw: N (F + 1)(F + 2) FLOPs
    against the input read once and the f32 output written once (the
    patch-Gram kernels' own bound)."""
    b, h, w, c = shape
    kh, kw = kernel_size
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    n, f1 = b * ho * wo, c * kh * kw + 1
    return n * f1 * (f1 + 1), b * h * w * c * itemsize + f1 * f1 * 4
