#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``curvature_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py              # what CI runs
    python3 chip_smoke.py --profile    # adds a device-time breakdown of one update

It builds the CUDA kernels from ``curvature_tpu_torch/ops/cuda/csrc``,
holds each kernel against its plain PyTorch version on the card, then
drives the main path, the KFAC Laplace loop on ResNet-50 (ImageNet stem,
1000 classes, 224x224, B=16, f32, MC=1, seeded weights): 4 factor
updates, split-damped inversion, a 30-sample posterior ensemble, and the
NN/BNN eval on 2 synthetic test batches. Every failed check raises. The
last line of standard output is the ``{"ok": true, ...}`` JSON object;
the line before it is the ``kernels`` JSON object.

It exits non-zero, printing no result, where there is no CUDA device or
where the package is not beside it.
"""
import argparse
import json
import subprocess
import sys
import time

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
#: the JAX tests' parity bar for the patch Gram (tests/test_pallas_kernels.py)
GRAM_RTOL = 1e-4
BATCH, SIZE, CLASSES, UPDATES, SAMPLES = 16, 224, 1000, 4, 30
ADD, MULTIPLY = 1.0, 18916.0


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gram_bound(shape, kernel_size, strides, pads):
    """(bound_ms, bound_by) of the patch Gram: the lower triangle with
    its diagonal of the [F+1, F+1] Gram, N*(F+1)*(F+2) FLOP at the FP32
    rate, against the input read once and the output written once."""
    b, h, w, c = shape
    kh, kw = kernel_size
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    n, f1 = b * ho * wo, c * kh * kw + 1
    ops_ms = n * f1 * (f1 + 1) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = (b * h * w * c + f1 * f1) * 4 / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def library_gram(x_nhwc, kernel_size, pads, strides):
    """Yardstick only, never called by the port: ``F.unfold`` and one
    ``torch.matmul`` (no ones row/column)."""
    import torch.nn.functional as F
    p = F.unfold(x_nhwc.permute(0, 3, 1, 2), kernel_size,
                 padding=(pads[0][0], pads[1][0]), stride=strides)
    p = p.transpose(1, 2).reshape(-1, p.shape[1])
    return p.T @ p


def check_kernels(tpg):
    """Each kernel against its plain version on the card; times at the
    main-path shape. Returns the per-kernel records."""
    import numpy as np
    import torch
    same1 = ((1, 1), (1, 1))
    cases = {
        # entry: [main-path shape first, then the odd cases of
        # tests/test_pallas_kernels.py (SAME with odd H/W, 5x5, stride-2
        # odd grid)]
        "patch_gram_tiled": [
            ((16, 56, 56, 64), (3, 3), same1, (1, 1)),
            ((2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
            ((1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
            ((2, 12, 12, 128), (3, 3), same1, (2, 2)),
            ((3, 9, 9, 64), (3, 3), same1, (2, 2)),
        ],
        "patch_gram_v2": [
            ((16, 56, 56, 128), (3, 3), same1, (2, 2)),
            ((3, 9, 9, 8), (3, 3), same1, (2, 2)),
            ((2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
            ((2, 12, 12, 4), (5, 5), ((2, 2), (2, 2)), (2, 2)),
            ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
        ],
    }
    replaces = {
        "patch_gram_tiled": "curvature_tpu/ops/pallas/patch_gram.py:464",
        "patch_gram_v2": "curvature_tpu/ops/pallas/patch_gram.py:229",
    }
    rng = np.random.default_rng(0)
    records = {}
    for name, items in cases.items():
        fn = getattr(tpg, name)
        worst_rel, main = 0.0, None
        for i, (shape, ks, pad, st) in enumerate(items):
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda()
            got = fn(x, ks, pad, st)
            torch.cuda.synchronize()
            if not torch.equal(got, fn(x, ks, pad, st)):
                raise AssertionError(f"{name} {shape}: two launches differ "
                                     "(the reduction must be deterministic)")
            want = tpg.patch_gram_plain(x, ks, pad, st)
            abs_err = float((got - want).abs().max())
            rel = abs_err / float(want.abs().max())
            log(f"  {name} {shape} k={ks} pad={pad} s={st}: "
                f"max_abs_err={abs_err:.3e} rel={rel:.3e}")
            if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
                raise AssertionError(
                    f"{name} {shape}: kernel disagrees with its plain "
                    f"version (rel {rel:.3e} > {GRAM_RTOL})")
            worst_rel = max(worst_rel, rel)
            if i == 0:
                main = (x, ks, pad, st, abs_err, rel)
        x, ks, pad, st, abs_err, rel = main
        pads = tpg.resolve_padding(pad, x.shape[1], x.shape[2], ks, st)
        bound_ms, bound_by = gram_bound(tuple(x.shape), ks, st, pads)
        records[name] = {
            "name": name, "route": "cuda",
            "source": "curvature_tpu_torch/ops/cuda/csrc/patch_gram.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": abs_err, "max_rel_err": rel,
            "worst_rel_err_all_cases": worst_rel, "cases": len(items),
            "shape": list(x.shape),
            "ms": cuda_ms(lambda: fn(x, ks, pad, st)),
            "plain_ms": cuda_ms(lambda: tpg.patch_gram_plain(x, ks, pad, st)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(lambda: library_gram(x, ks, pads, st)),
        }
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a device-time breakdown of one update")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from curvature_tpu_torch import estimators, models
        from curvature_tpu_torch.data import synthetic_images
        from curvature_tpu_torch.eval import eval_bnn, eval_nn, metrics
        from curvature_tpu_torch.ops.cuda import build
        from curvature_tpu_torch.ops.cuda import patch_gram as tpg
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
        f"{sorted(reports)} (nvcc -gencode arch=compute_90a,code=sm_90a)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- 2. kernels against their plain versions ----------------------------
    log("kernels vs plain versions:")
    records = check_kernels(tpg)

    # -- 3. the main path ---------------------------------------------------
    model = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(1)
    xs, _ = synthetic_images(rng, BATCH * UPDATES, SIZE, SIZE, 3, CLASSES)
    batches = [torch.from_numpy(np.ascontiguousarray(
        xs[i * BATCH:(i + 1) * BATCH].transpose(0, 3, 1, 2))).to(dev)
        .contiguous(memory_format=torch.channels_last)
        for i in range(UPDATES)]
    xt, yt = synthetic_images(rng, 2 * BATCH, SIZE, SIZE, 3, CLASSES)
    test_data = [(torch.from_numpy(np.ascontiguousarray(
        xt[i * BATCH:(i + 1) * BATCH].transpose(0, 3, 1, 2))).to(dev)
        .contiguous(memory_format=torch.channels_last),
        yt[i * BATCH:(i + 1) * BATCH]) for i in range(2)]
    gen = torch.Generator(device=dev).manual_seed(2)

    est = estimators.KFAC(model)
    if not est.use_kernels:
        raise AssertionError("use_kernels='auto' must enable the kernels "
                             "on CUDA")
    tpg.patch_gram_tiled.launches = 0
    tpg.patch_gram_v2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in batches:
        est.update(x, generator=gen, num_samples=1)
    torch.cuda.synchronize()
    first_block = time.perf_counter() - t0
    after_updates = (tpg.patch_gram_tiled.launches,
                     tpg.patch_gram_v2.launches)
    log(f"main path: {UPDATES} updates in {first_block:.3f} s (first "
        f"block, incl. warm-up); launches tiled={after_updates[0]} "
        f"v2={after_updates[1]}")
    if after_updates != (3 * UPDATES, UPDATES):
        raise AssertionError(f"expected {3 * UPDATES} tiled and {UPDATES} "
                             f"v2 launches, got {after_updates}")

    t0 = time.perf_counter()
    est.invert(ADD, MULTIPLY)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ensemble = est.ensemble_params(SAMPLES, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    nn_probs, labels = eval_nn(model, test_data)
    bnn_probs, _ = eval_bnn(model, est, test_data, samples=SAMPLES,
                            ensemble_params=ensemble)
    launches = (tpg.patch_gram_tiled.launches, tpg.patch_gram_v2.launches)
    if launches != after_updates:
        raise AssertionError("invert/sample/eval must not launch the "
                             f"Gram kernels: {after_updates} -> {launches}")
    records["patch_gram_tiled"]["launches"] = launches[0]
    records["patch_gram_v2"]["launches"] = launches[1]
    log(f"invert(add={ADD}, multiply={MULTIPLY}): {invert_s:.3f} s; "
        f"{SAMPLES}-sample ensemble: {sample_s:.3f} s")

    # -- 4. is what came out right? -----------------------------------------
    for name, fac in est.state.items():
        for key, t in list(fac.items()) + list(est.inv_state[name].items()):
            if not torch.isfinite(t).all():
                raise AssertionError(f"{name}.{key} is not finite")
    for what, p in (("nn", nn_probs), ("bnn", bnn_probs)):
        if p.shape != (2 * BATCH, CLASSES) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"{what} probabilities malformed")
    # the kernels' A factors against use_kernels=False on the same batch
    check = ["layer1.0.conv2", "layer2.0.conv2"]
    plain_est = estimators.KFAC(model, use_kernels=False, layer_filter=check)
    cap = estimators.collect(model, plain_est.metas, batches[-1],
                             labels=torch.zeros(BATCH, dtype=torch.long,
                                                device=dev))
    for name in check:
        meta, act = plain_est.metas[name], cap.acts[name]
        got = est._a_factor(meta, act)
        want = plain_est._a_factor(meta, act)
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"A factor {name} kernel vs use_kernels=False: rel {rel:.3e}")
        if rel > GRAM_RTOL:
            raise AssertionError(f"{name}: A factor rel err {rel:.3e}")
    stats = {}
    for what, p in (("nn", nn_probs), ("bnn", bnn_probs)):
        stats[what] = {
            "acc": float(metrics.accuracy(p, labels)),
            "ece": float(metrics.expected_calibration_error(p, labels)[0]),
            "nll": float(metrics.negative_log_likelihood(p, labels))}
    log(f"metrics (random weights, {2 * BATCH} synthetic images): "
        f"{json.dumps(stats)}")

    # -- 5. rates (best of 3 blocks, each ended by a synchronize) ---------
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in batches:
            est.update(x, generator=gen, num_samples=1)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    update_img_s = BATCH * UPDATES / best
    best_eval = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_bnn(model, est, test_data, samples=SAMPLES,
                 ensemble_params=ensemble)
        torch.cuda.synchronize()
        best_eval = min(best_eval, time.perf_counter() - t0)
    bnn_img_s = 2 * BATCH / best_eval
    log(f"update img/s: {update_img_s:.2f} (ResNet-50 f32 B={BATCH} MC=1, "
        f"best of 3 blocks of {UPDATES} updates)")
    log(f"bnn30 eval img/s: {bnn_img_s:.2f} (best of 3 blocks of "
        f"{2 * BATCH} images x {SAMPLES} samples)")
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if args.profile:
        profile_update(est, batches[0], gen)

    print(json.dumps({"kernels": list(records.values())}))
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
