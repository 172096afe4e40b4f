#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``curvature_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py              # what CI runs
    python3 chip_smoke.py --profile    # adds a device-time breakdown of one
                                       # update of each path
    python3 chip_smoke.py --kernels    # builds and checks the kernels only

It builds the CUDA kernels from ``curvature_tpu_torch/ops/cuda/csrc``,
counts the tensor-core (HGMMA) instructions of each kernel in their SASS
(the f32 patch Gram and every bf16 kernel must have them, the FP32 FMA
kernel none), holds each kernel (patch_gram_tiled, patch_gram_v2,
patch_gram, sym_gram; f32 and bf16) against its plain PyTorch version on
the card, including a case whose blocks each sum a full
``MAX_CHAIN_TOKENS`` chain, then drives
three paths of ResNet-50 (ImageNet stem, 1000 classes, 224x224, MC=1,
seeded weights), named after ``bench.py``'s rows:

  * ``resnet50_kfac_update_img_s``: the KFAC Laplace loop in f32 at B=16,
    4 factor updates, split-damped inversion, a 30-sample posterior
    ensemble, and the NN/BNN eval on 2 synthetic test batches;
  * ``resnet50_kfac_update_bf16_b32_img_s``: KFAC updates with
    ``compute_dtype=bfloat16`` at B=32 (layer2.0.conv2 through the v2
    kernel in bf16);
  * ``resnet50_kfac_update_bf16_sub4_img_s``: bf16 with
    ``token_subsample=0.25`` at B=16 (no Gram kernel, the JAX gate).

Every failed check raises. The last line of standard output is the
``{"ok": true, ...}`` JSON object; the line before it is the ``kernels``
JSON object. It exits non-zero, printing no result, where there is no
CUDA device or where the package is not beside it.
"""
import argparse
import functools
import json
import subprocess
import sys
import time

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, dense TF32
#: and BF16 on the tensor cores (f32 accumulation, what wgmma computes),
#: HBM3. f32 Grams run 3xTF32 (csrc/tf32x3_gram.cuh): three TF32 products
#: per f32 product, so their bound is 3x the FLOP at the TF32 rate; the
#: strict FP32 FMA figure stays in each f32 record as bound_fp32_fma_ms
#: (sym_gram's f32 kernel still runs FP32 FMA)
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
TF32X3 = 3
PEAK_BYTES_S = 3.35e12
#: the JAX tests' parity bars: patch Gram (tests/test_pallas_kernels.py:31)
#: and sym_gram (:141, of max(max|want|, 1))
GRAM_RTOL = 1e-4
SYM_RTOL = 2e-5
#: bf16 compute against f32 factors (tests/test_capture.py:137)
BF16_RTOL = 2e-2
BATCH, SIZE, CLASSES, UPDATES, SAMPLES = 16, 224, 1000, 4, 30
BATCH_B32 = 32
ADD, MULTIPLY = 1.0, 18916.0
PATHS = ("resnet50_kfac_update_img_s", "resnet50_kfac_update_bf16_b32_img_s",
         "resnet50_kfac_update_bf16_sub4_img_s")
SAME1 = ((1, 1), (1, 1))
#: entry -> [main-path shape first, then odd cases]: (shape, kernel,
#: padding, strides); sym_gram cases are (N, F)
PATCH_CASES = {
    # the odd cases of tests/test_pallas_kernels.py (SAME with odd H/W,
    # 5x5, stride-2 odd grid)
    "patch_gram_tiled": [
        ((16, 56, 56, 64), (3, 3), SAME1, (1, 1)),
        ((2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
        ((1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
        ((2, 12, 12, 128), (3, 3), SAME1, (2, 2)),
        ((3, 9, 9, 64), (3, 3), SAME1, (2, 2)),
    ],
    "patch_gram_v2": [
        ((16, 56, 56, 128), (3, 3), SAME1, (2, 2)),
        ((3, 9, 9, 8), (3, 3), SAME1, (2, 2)),
        ((2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
        ((2, 12, 12, 4), (5, 5), ((2, 2), (2, 2)), (2, 2)),
        ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ],
    # the four shapes of tests/test_pallas_kernels.py:20-25 (2x2 VALID at
    # C=3, non-square 10x6)
    "patch_gram": [
        ((16, 56, 56, 64), (3, 3), SAME1, (1, 1)),
        ((2, 8, 8, 4), (3, 3), SAME1, (1, 1)),
        ((3, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (1, 1)),
        ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
        ((1, 9, 9, 3), (2, 2), ((0, 0), (0, 0)), (1, 1)),
    ],
}
#: bf16 boundary cases of the wgmma gather, run through patch_gram_v2 (its
#: odd cases above hold C = 4, the scalar gather, and C = 8)
BF16_PATCH_CASES = [
    # C = 96: 64-feature tiles straddle taps; F = 864 is not a multiple of
    # 64; N = 162 is not a multiple of one 64-token stage
    ((2, 9, 9, 96), (3, 3), SAME1, (1, 1)),
    ((1, 5, 5, 64), (3, 3), SAME1, (1, 1)),       # N = 25 < one stage
    ((4, 28, 28, 64), (3, 3), SAME1, (2, 2)),     # N = 784 in 3 splits
]
#: (784, 4609) is ResNet-50's layer4 3x3 patch matrix at B=16; (600, 1024)
#: has F % 8 == 0 (no padding in bf16)
SYM_CASES = [(784, 4609), (3136, 1025), (700, 577), (513, 2049), (600, 1024)]
#: run through patch_gram in f32 and bf16: N = 132 * 64 * 64 = 540,672 =
#: 66 x MAX_CHAIN_TOKENS, so every block of the 66 splits sums a full
#: 8,192-token chain in its tensor-core accumulator (F = 576)
CHAIN_CASE = ((132, 64, 64, 64), (3, 3), SAME1, (1, 1))
REPLACES = {
    "patch_gram_tiled": "curvature_tpu/ops/pallas/patch_gram.py:464",
    "patch_gram_v2": "curvature_tpu/ops/pallas/patch_gram.py:229",
    "patch_gram": "curvature_tpu/ops/pallas/patch_gram.py:114",
    "sym_gram": "curvature_tpu/ops/pallas/sym_gram.py:85",
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, min_ms=50.0, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around
    back-to-back calls after ``warmup`` calls: at least 20 calls and about
    ``min_ms`` of device time, so that short kernels are not timed over a
    window of a few milliseconds."""
    import torch

    def timed(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return timed(max(20, min(2000, int(min_ms / max(timed(3), 1e-3)))))


def add_device_times(records):
    """Each record's device time per call by kernel name (torch.profiler)
    and its sum, ``device_ms``: the kernels' own time, where ``ms`` also
    holds the host's gaps between back-to-back wrapper calls that cannot
    be enqueued as fast as the card runs them (kernels of ~0.1 ms). Run
    after the paths: a profiler run slows the host's later launches."""
    for rec in records:
        rec["device_ms_by_kernel"] = device_ms_by_kernel(rec.pop("call"))
        rec["device_ms"] = sum(rec["device_ms_by_kernel"].values())
        log(f"{rec['name']}: {rec['ms']:.4f} ms, device {rec['device_ms']:.4f}"
            f" ms ({rec['gather']} gather; {rec['tile']}), plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f} / f32 "
            f"out {rec['library_f32_out_ms']}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']}); by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec["device_ms_by_kernel"].items()))


def device_ms_by_kernel(fn, calls=5):
    """Device time per call of ``fn`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def bound(ops, nbytes, rate):
    """(ms, by): the larger of ``ops`` at ``rate`` per second and the
    bytes at the card's memory rate."""
    ops_ms = ops / rate * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def bounds(flops, nbytes, dtype):
    """The record's bound keys for a Gram of ``flops`` FLOP over ``nbytes``
    bytes: bf16 at the BF16 tensor-core rate; f32 as 3xTF32 (3x the FLOP
    at the TF32 rate), with the strict FP32 FMA bound beside it."""
    if dtype == "bf16":
        ms, by = bound(flops, nbytes, PEAK_FLOPS["bf16"])
        return {"bound_ms": ms, "bound_by": by, "bound_fp32_fma_ms": None}
    ms, by = bound(TF32X3 * flops, nbytes, PEAK_FLOPS["tf32"])
    return {"bound_ms": ms, "bound_by": by,
            "bound_fp32_fma_ms": bound(flops, nbytes, PEAK_FLOPS["fp32"])[0]}


def gram_bound(shape, kernel_size, strides, pads, dtype, itemsize):
    """The patch Gram's bound keys: the lower triangle with its diagonal
    of the [F+1, F+1] Gram, N*(F+1)*(F+2) FLOP, against the input read once
    and the f32 output written once."""
    b, h, w, c = shape
    kh, kw = kernel_size
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    n, f1 = b * ho * wo, c * kh * kw + 1
    return bounds(n * f1 * (f1 + 1), b * h * w * c * itemsize + f1 * f1 * 4,
                  dtype)


def unfold(x_nhwc, kernel_size, pads, strides):
    """The [N, F] patch matrix by ``F.unfold`` (yardsticks only)."""
    import torch.nn.functional as F
    p = F.unfold(x_nhwc.permute(0, 3, 1, 2), kernel_size,
                 padding=(pads[0][0], pads[1][0]), stride=strides)
    return p.transpose(1, 2).reshape(-1, p.shape[1])


def yardsticks(dtype, p_of):
    """Library yardsticks, never called by the port, as {key: (name, fn)}:
    ``p.T @ p`` in the input's dtype (bf16 gives cuBLAS's bf16-output
    product) and, for bf16, ``torch.mm(..., out_dtype=torch.float32)``
    (f32 output, the kernels' contract) where this torch accepts it.
    ``p_of()`` builds the [N, F] matrix (the unfold counts in the time)."""
    import torch

    def same_out():
        p = p_of()
        return p.T @ p
    out = {"library_ms": (f"p.T @ p ({dtype} output)", same_out)}
    if dtype == "bf16":
        def f32_out():
            p = p_of()
            return torch.mm(p.T, p, out_dtype=torch.float32)
        try:
            f32_out()
            out["library_f32_out_ms"] = (
                "torch.mm(p.T, p, out_dtype=torch.float32)", f32_out)
        except (TypeError, RuntimeError, NotImplementedError) as e:
            log(f"  torch.mm out_dtype=float32 not available: {e}")
    return out


def time_yardsticks(dtype, p_of):
    times, names = {}, {}
    for key, (name, fn) in yardsticks(dtype, p_of).items():
        times[key] = cuda_ms(fn)
        names[key.replace("_ms", "_call")] = name
    times.setdefault("library_f32_out_ms", None)
    return {**times, **names}


#: (function, dtype) -> the kernel template that computes it, as it
#: appears in the SASS; the ``*wgmma_kernel`` ones run on the tensor cores
KERNEL_OF = {("patch", "f32"): "gram_tf32x3_wgmma_kernel",
             ("patch", "bf16"): "gram_wgmma_kernel",
             ("sym", "f32"): "sym_partial_kernel",
             ("sym", "bf16"): "sym_wgmma_kernel"}


def hgmma_counts(build):
    """Tensor-core (HGMMA) instructions per kernel in the SASS of the built
    libraries (``cuobjdump -sass``); raises if a ``*wgmma_kernel`` has none
    or any other kernel (FP32 FMA, the reduces) has some, or if a kernel of
    ``KERNEL_OF`` is missing."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).parent
                                             / "cuobjdump")
    counts = {}
    for name in ("patch_gram", "sym_gram"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    for fn, n in sorted(counts.items()):
        log(f"  SASS {fn}: {n} HGMMA")
        wgmma = "wgmma_kernel" in fn
        if wgmma and n == 0:
            raise AssertionError(f"{fn}: no HGMMA in its SASS")
        if not wgmma and n:
            raise AssertionError(f"{fn}: HGMMA in a kernel off the tensor "
                                 "cores")
    for kernel in KERNEL_OF.values():
        if not any(kernel in fn for fn in counts):
            raise AssertionError(f"{kernel} not found in the SASS")
    return counts


def _record(name, dtype, shape, abs_err, rel, worst, cases, **times):
    return {"name": name if dtype == "f32" else f"{name}_{dtype}",
            "function": name, "dtype": dtype, "route": "cuda",
            "source": "curvature_tpu_torch/ops/cuda/csrc/"
                      + ("sym_gram.cu" if name == "sym_gram"
                         else "patch_gram.cu"),
            "replaces": REPLACES[name], "launches": None,
            "launches_by_path": None, "max_abs_err": abs_err,
            "max_rel_err": rel, "worst_rel_err_all_cases": worst,
            "cases": cases, "shape": list(shape), **times}


def _launch_twice(fn, *args):
    """One kernel result, after checking that a second launch gives the
    same bits (no atomics, a fixed reduction order)."""
    import torch
    got = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, fn(*args)):
        raise AssertionError(f"{fn.__name__}: two launches differ (the "
                             "reduction must be deterministic)")
    return got


def check_patch_kernels(tpg, dtype):
    """Each patch-Gram entry against its plain version on the card, in
    ``dtype``; times at the main-path shape. Returns the records."""
    import numpy as np
    import torch
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    records = []
    for name, items in PATCH_CASES.items():
        fn = getattr(tpg, name)
        if name == "patch_gram_v2" and dtype == "bf16":
            # the bf16_b32 path's layer2.0.conv2, and the gather's edges
            items = [((BATCH_B32,) + items[0][0][1:],) + items[0][1:]] \
                + items[1:] + BF16_PATCH_CASES
        worst, main = 0.0, None
        for i, (shape, ks, pad, st) in enumerate(items):
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(tdt)
            args = (x, ks, pad) if name == "patch_gram" else (x, ks, pad, st)
            got = _launch_twice(fn, *args)
            want = tpg.patch_gram_plain(x, ks, pad, st)
            abs_err = float((got - want).abs().max())
            rel = abs_err / float(want.abs().max())
            gather = tpg.gather_kind(x)
            log(f"  {name} {dtype} {shape} k={ks} pad={pad} s={st}: "
                f"splits={patch_splits(tpg, x, ks, pad, st)} gather={gather} "
                f"max_abs_err={abs_err:.3e} rel={rel:.3e}")
            if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
                raise AssertionError(
                    f"{name} {dtype} {shape}: kernel disagrees with its "
                    f"plain version (rel {rel:.3e} > {GRAM_RTOL})")
            worst = max(worst, rel)
            if i == 0:
                main = (x, ks, pad, st, args, abs_err, rel, gather)
        x, ks, pad, st, args, abs_err, rel, gather = main
        pads = tpg.resolve_padding(pad, x.shape[1], x.shape[2], ks, st)
        records.append(_record(
            name, dtype, x.shape, abs_err, rel, worst, len(items),
            gather=gather, ms=cuda_ms(lambda: fn(*args)),
            call=functools.partial(fn, *args),
            plain_ms=cuda_ms(lambda: tpg.patch_gram_plain(x, ks, pad, st)),
            **gram_bound(tuple(x.shape), ks, st, pads, dtype,
                         x.element_size()),
            **time_yardsticks(dtype, lambda: unfold(x, ks, pads, st))))
    records[-1]["chain_cap_rel_err"] = check_chain(tpg, tdt, rng)
    return records


def check_chain(tpg, tdt, rng):
    """CHAIN_CASE through ``patch_gram``: every block sums exactly
    MAX_CHAIN_TOKENS tokens in one tensor-core accumulator. Returns its
    error, rel to max|G|."""
    import numpy as np
    import torch
    shape, ks, pad, st = CHAIN_CASE
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(tdt)
    n = shape[0] * shape[1] * shape[2]
    per_split = -(-n // patch_splits(tpg, x, ks, pad, st))
    if per_split != tpg.MAX_CHAIN_TOKENS:
        raise AssertionError(f"chain case: {per_split} tokens a split, not "
                             f"{tpg.MAX_CHAIN_TOKENS}")
    got = _launch_twice(tpg.patch_gram, x, ks, pad)
    want = tpg.patch_gram_plain(x, ks, pad, st)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  patch_gram {tdt} {shape} chain cap: {per_split} tokens in each "
        f"block's accumulator, rel={rel:.3e}")
    if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
        raise AssertionError(f"chain case {tdt}: rel {rel:.3e} > {GRAM_RTOL}")
    return rel


def patch_splits(tpg, x, ks, pad, st):
    """The token split count the wrapper launches ``x`` with."""
    import torch
    b, h, w, c = x.shape
    pads = tpg.resolve_padding(pad, h, w, ks, st)
    ho, wo = tpg._out_shape(h, w, ks, pads, st)
    bf16 = x.dtype == torch.bfloat16
    slots = tpg._resident_blocks(x.device.index, st[0], bf16,
                                 tpg.gather_kind(x) == "vector")
    return tpg.plan_splits(b * ho * wo, tpg.block_tiles(c * ks[0] * ks[1],
                                                         bf16), True, slots)


def check_sym_kernel(tsg, dtype):
    """sym_gram against its plain version on the card, in ``dtype``:
    every case, both variants bitwise equal, a bitwise symmetric result."""
    import numpy as np
    import torch
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    worst, main = 0.0, None
    for i, (n, f) in enumerate(SYM_CASES):
        if not tsg.sym_gram_supported(n, f):
            raise AssertionError(f"sym_gram ({n}, {f}) is below the gate")
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(
            np.float32)).cuda().to(tdt)
        got = _launch_twice(tsg.sym_gram, x)
        if not torch.equal(got, tsg.sym_gram(x, variant="rect")):
            raise AssertionError("sym_gram: 'rect' differs from 'tri'")
        if not torch.equal(got, got.T):
            raise AssertionError(f"sym_gram ({n}, {f}): not symmetric")
        want = tsg.sym_gram_plain(x)
        abs_err = float((got - want).abs().max())
        rel = abs_err / max(float(want.abs().max()), 1.0)
        log(f"  sym_gram {dtype} ({n}, {f}): max_abs_err={abs_err:.3e} "
            f"rel={rel:.3e}")
        if not (torch.isfinite(got).all() and rel <= SYM_RTOL):
            raise AssertionError(
                f"sym_gram {dtype} ({n}, {f}): kernel disagrees with its "
                f"plain version (rel {rel:.3e} > {SYM_RTOL})")
        worst = max(worst, rel)
        if i == 0:
            main = (x, abs_err, rel)
    x, abs_err, rel = main
    n, f = x.shape
    return [_record(
        "sym_gram", dtype, x.shape, abs_err, rel, worst, len(SYM_CASES),
        gather=("vector, features padded to 8" if f % 8 else "vector")
        if dtype == "bf16" else "scalar f32",
        ms=cuda_ms(lambda: tsg.sym_gram(x)),
        call=lambda: tsg.sym_gram(x),
        plain_ms=cuda_ms(lambda: tsg.sym_gram_plain(x)),
        **bounds(n * f * (f + 1), n * f * x.element_size() + f * f * 4,
                 dtype),
        **time_yardsticks(dtype, lambda: x))]


class Counters:
    """The kernel wrappers' launch counters."""

    def __init__(self, tpg, tsg):
        self.fns = {"patch_gram_tiled": tpg.patch_gram_tiled,
                    "patch_gram_v2": tpg.patch_gram_v2,
                    "patch_gram": tpg.patch_gram, "sym_gram": tsg.sym_gram}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.fns.items()}


def nchw_batches(rng, n_batches, batch, dev):
    import numpy as np
    import torch
    xs, ys = synthetic(rng, n_batches * batch)
    return [(torch.from_numpy(np.ascontiguousarray(
        xs[i * batch:(i + 1) * batch].transpose(0, 3, 1, 2))).to(dev)
        .contiguous(memory_format=torch.channels_last),
        ys[i * batch:(i + 1) * batch]) for i in range(n_batches)]


def synthetic(rng, num):
    from curvature_tpu_torch.data import synthetic_images
    return synthetic_images(rng, num, SIZE, SIZE, 3, CLASSES)


def drive_updates(est, batches, gen, counters, path, expect):
    """The path's updates with the counters set to 0 just before and read
    just after; ``expect`` is the exact launch count of each kernel."""
    import torch
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in batches:
        est.update(x, generator=gen, num_samples=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counters.read()
    log(f"{path}: {len(batches)} updates in {seconds:.3f} s (first block, "
        f"incl. warm-up); launches {json.dumps(got)}")
    if got != expect:
        raise AssertionError(f"{path}: expected launches {expect}, got {got}")
    for name, fac in est.state.items():
        for key, t in fac.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"{path}: {name}.{key} is not finite")
    return got


def best_rate(est, batches, gen, batch):
    """Images per second through ``update``, best of 3 blocks, each ended
    by a synchronize."""
    import torch
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in batches:
            est.update(x, generator=gen, num_samples=1)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return batch * len(batches) / best


def a_factor_check(est, plain_est, x, name, what):
    """One layer's A factor from ``est`` (kernel route) against
    ``plain_est`` (``use_kernels=False``) on the same capture."""
    import torch
    cap = est.capture(x, labels=torch.zeros(x.shape[0], dtype=torch.long,
                                            device=x.device))
    meta, act = plain_est.metas[name], cap.acts[name]
    got = est._a_factor(meta, act)
    want = plain_est._a_factor(meta, act)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"A factor {name} ({what}) kernel vs use_kernels=False: "
        f"rel {rel:.3e}")
    if rel > GRAM_RTOL:
        raise AssertionError(f"{name} ({what}): A factor rel err {rel:.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a device-time breakdown of one update "
                         "of each path")
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels, print their records, "
                         "and stop (no paths, no result line)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from curvature_tpu_torch import estimators, models
        from curvature_tpu_torch.eval import eval_bnn, eval_nn, metrics
        from curvature_tpu_torch.ops.cuda import build
        from curvature_tpu_torch.ops.cuda import patch_gram as tpg
        from curvature_tpu_torch.ops.cuda import sym_gram as tsg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    # strict f32 wherever parity is checked (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)}")
    log(smi)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all(force=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(reports)} (nvcc -gencode arch=compute_90a,code=sm_90a, "
        "one process per source)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                        "spill", "wgmma", "arning")):
                log(f"  {name}: {line.strip()}")
    hgmma = hgmma_counts(build)

    # -- 2. kernels against their plain versions ----------------------------
    log("kernels vs plain versions:")
    records = []
    for dtype in ("f32", "bf16"):
        records += check_patch_kernels(tpg, dtype)
        records += check_sym_kernel(tsg, dtype)
    for rec in records:
        fam = "sym" if rec["function"] == "sym_gram" else "patch"
        edge = tsg._TILE if fam == "sym" else \
            tpg.BF16_TILE if rec["dtype"] == "bf16" else tpg.F32_TILE
        kernel = KERNEL_OF[fam, rec["dtype"]]
        if not kernel.endswith("wgmma_kernel"):
            how = "4x4 FP32 FMA micro-tiles"
        elif rec["dtype"] == "f32":
            how = f"3xTF32 wgmma m64n{edge}k8 on tf32 tensor cores"
        else:
            how = f"wgmma m64n{edge}k16 on bf16 tensor cores"
        rec["tile"] = f"{edge}x{edge}, {how}"
        rec["hgmma_in_sass"] = {fn: n for fn, n in hgmma.items()
                                if kernel in fn}
    if args.kernels:
        add_device_times(records)
        print(json.dumps({"kernels": records}))
        return 0

    # -- 3. the paths ---------------------------------------------------------
    model = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(1)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    batches_b32 = [x for x, _ in nchw_batches(rng, UPDATES, BATCH_B32, dev)]
    gen = torch.Generator(device=dev).manual_seed(2)
    counters = Counters(tpg, tsg)
    none = {name: 0 for name in counters.fns}
    by_path = {}

    # 3a. f32: the KFAC Laplace loop
    est = estimators.KFAC(model)
    if not est.use_kernels:
        raise AssertionError("use_kernels='auto' must enable the kernels "
                             "on CUDA")
    by_path[PATHS[0]] = drive_updates(
        est, batches, gen, counters, PATHS[0],
        dict(none, patch_gram_tiled=3 * UPDATES, patch_gram_v2=UPDATES))
    t0 = time.perf_counter()
    est.invert(ADD, MULTIPLY)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ensemble = est.ensemble_params(SAMPLES, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counters.reset()
    nn_probs, labels = eval_nn(model, test_data)
    bnn_probs, _ = eval_bnn(model, est, test_data, samples=SAMPLES,
                            ensemble_params=ensemble)
    if counters.read() != none:
        raise AssertionError("eval must not launch the Gram kernels: "
                             f"{counters.read()}")
    log(f"invert(add={ADD}, multiply={MULTIPLY}): {invert_s:.3f} s; "
        f"{SAMPLES}-sample ensemble: {sample_s:.3f} s")
    for name, inv in est.inv_state.items():
        for key, t in inv.items():
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name}.{key} is not finite")
    for what, p in (("nn", nn_probs), ("bnn", bnn_probs)):
        if p.shape != (2 * BATCH, CLASSES) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"{what} probabilities malformed")
    stats = {}
    for what, p in (("nn", nn_probs), ("bnn", bnn_probs)):
        stats[what] = {
            "acc": float(metrics.accuracy(p, labels)),
            "ece": float(metrics.expected_calibration_error(p, labels)[0]),
            "nll": float(metrics.negative_log_likelihood(p, labels))}
    log(f"metrics (random weights, {2 * BATCH} synthetic images): "
        f"{json.dumps(stats)}")

    # 3b. bf16 at B=32: layer2.0.conv2 through the v2 kernel in bf16
    est16 = estimators.KFAC(model, compute_dtype=torch.bfloat16)
    by_path[PATHS[1]] = drive_updates(
        est16, batches_b32, gen, counters, PATHS[1],
        dict(none, patch_gram_v2=UPDATES))

    # 3c. bf16 with token_subsample=0.25 at B=16: no Gram kernel
    est_sub = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                              token_subsample=0.25)
    by_path[PATHS[2]] = drive_updates(est_sub, batches, gen, counters,
                                      PATHS[2], none)

    for rec in records:
        paths = PATHS[:1] if rec["dtype"] == "f32" else PATHS[1:]
        rec["launches_by_path"] = {
            p: by_path[p][rec["function"]] if p in paths else 0
            for p in PATHS}
        rec["launches"] = sum(rec["launches_by_path"].values())

    # -- 4. is what came out right? -----------------------------------------
    # the kernels' A factors against use_kernels=False on the same capture
    checked = ["layer1.0.conv2", "layer2.0.conv2"]
    for name in checked:
        a_factor_check(est, estimators.KFAC(
            model, use_kernels=False, layer_filter=checked),
            batches[-1], name, "f32")
    a_factor_check(est16, estimators.KFAC(
        model, use_kernels=False, compute_dtype=torch.bfloat16,
        layer_filter=["layer2.0.conv2"]),
        batches_b32[-1], "layer2.0.conv2", "bf16, B=32")
    # bf16 factors against f32 ones from one batch with the same labels
    one = {}
    for what, kw in (("f32", {}), ("bf16", {"compute_dtype": torch.bfloat16})):
        e = estimators.KFAC(model, **kw)
        e.update(batches[0], labels=torch.arange(BATCH, device=dev))
        one[what] = e.state
    worst = {"a": 0.0, "g": 0.0}
    for name, fac in one["f32"].items():
        for key in worst:
            want, got = fac[key], one["bf16"][name][key]
            rel = float((got - want).abs().max() / want.abs().max())
            worst[key] = max(worst[key], rel)
            if key == "a" and rel > BF16_RTOL:
                raise AssertionError(f"{name}: bf16 A factor {rel:.3e} of "
                                     f"max from the f32 one (> {BF16_RTOL})")
    log(f"bf16 vs f32 factors, one batch, worst over layers: "
        f"A {worst['a']:.3e} (bar {BF16_RTOL}), G {worst['g']:.3e}")

    # -- 5. rates --------------------------------------------------------------
    rates = {PATHS[0]: best_rate(est, batches, gen, BATCH),
             PATHS[1]: best_rate(est16, batches_b32, gen, BATCH_B32),
             PATHS[2]: best_rate(est_sub, batches, gen, BATCH)}
    best_eval = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_bnn(model, est, test_data, samples=SAMPLES,
                 ensemble_params=ensemble)
        torch.cuda.synchronize()
        best_eval = min(best_eval, time.perf_counter() - t0)
    bnn_img_s = 2 * BATCH / best_eval
    for path, what in zip(PATHS, (f"f32 B={BATCH}", f"bf16 B={BATCH_B32}",
                                  f"bf16 token_subsample=0.25 B={BATCH}")):
        log(f"{path}: {rates[path]:.2f} update img/s (ResNet-50 {what} "
            f"MC=1, best of 3 blocks of {UPDATES} updates; {smi})")
    log(f"resnet50_bnn30_eval_img_s: {bnn_img_s:.2f} (best of 3 blocks of "
        f"{2 * BATCH} images x {SAMPLES} samples; {smi})")
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    add_device_times(records)
    if args.profile:
        for path, e, b in zip(PATHS, (est, est16, est_sub),
                              (batches, batches_b32, batches)):
            log(f"{path}:")
            profile_update(e, b[0], gen)

    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_update(est, x, gen):
    """Device time of one update by kernel name (torch.profiler), and the
    device-busy share of the update's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    est.update(x, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.update(x, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3    # ms
    log(f"profile: one update {wall * 1e3:.1f} ms wall, "
        f"{busy:.1f} ms of device kernels ({100 * busy / (wall * 1e3):.1f}%"
        f" of the wall time), {sum(e.count for e in events)} launches")
    for e in events[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
