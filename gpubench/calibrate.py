"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3

For each seed: the cell's set-up and a short window at the cell's own
sizes, then the program's reading (its answer against the reference's,
as a run's checks compare them) and the control's (the reference with
TF32 on, put in the program's place, against the reference in f32). One
JSON line a seed on standard output. The benchmark's runs do not run the
control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    """The program's and the control's readings of one seed."""
    import torch
    from gpubench import harness
    ctx = harness.Ctx(cell, seed, device)
    gen = importlib.import_module(
        f"gpubench.generators.{cell.traffic['generator']}")
    t0 = time.perf_counter()
    run = gen.Run(ctx)
    setup_s = time.perf_counter() - t0
    steps, secs = harness.window(run.step, seconds, ctx.sync)
    got = run.result()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    want = run.expected(tf32=False)
    control = run.expected(tf32=True)
    out = {"seed": seed, "setup_s": setup_s, "steps": steps,
           "seconds": secs, "program": gen.compare(got, want),
           "control": gen.compare(control, want),
           "failed": run.failed(got)}
    del run, got, want, control
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from gpubench import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell(REPO, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
