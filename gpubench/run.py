"""Run one cell of the benchmark on one card and print its result line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the measured package ``curvature_tpu_torch``. The last line of
standard output is the result's JSON object; the checks that decide
``correct`` are the last lines of standard error. Exits 3 without a
result where CUDA or the cell's cards are missing, 2 where the measured
package is, and 4 where a JAX module, or the JAX package, is loaded once
the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
BUILD = REPO / "build"
#: every cache the program and its libraries write, at fixed paths inside
#: the checkout, so that only a checkout's first run builds and compiles
CACHES = {"TRITON_CACHE_DIR": BUILD / "triton",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(REPO))
    from gpubench import harness
    cell = harness.Cell(REPO, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    try:
        import curvature_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the measured package is missing: {exc}", file=sys.stderr)
        return 2
    result = harness.run_cell(REPO, args.workload, args.seed, args.seconds,
                              bool(args.trace), T0)
    barred = harness.barred_modules()
    if barred:
        print(f"barred modules loaded: {barred}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
