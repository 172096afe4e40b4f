"""The benchmark's run of one cell, driven by ``BENCHMARK.json`` and the
data files under this folder.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file (``configs[].file``) gives the model's sizes
and precision, its ``family`` (the program's side in
``families/<family>.py``, whose ``reference`` is the plain model) and the
estimator. The traffic file ``traffic/<traffic>.json`` names its
``generator`` (``generators/<generator>.py``, the one general generator
of that kind of work) and gives its parameters. Each metric is read by
``metrics/<name>.py``, or by ``metrics/<prefix>.py`` for a name
``<prefix>.<end-to-end metric>``.
The limits of the cell's correctness checks are in
``limits/<cell>.json``. Nothing here names a cell, a configuration or a
metric.

A run: set-up (the generator's ``Run``: seeded weights and inputs on the
card, the program built and warmed up), then the window, then the checks:
the program's answer freed from the program and held to the reference's.
With ``trace`` the window is three stretches of about a third each: whole
steps (the rate), split steps (the layers' host times), and whole steps
under the profiler (the device's busy time and its operations), and then
one step under the profiler with the host's operations (the idle gaps'
names; ``trace.py``).
"""
import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
#: top-level module names that no run may hold once its window has closed
BARRED = ("jax", "jaxlib", "flax", "curvature_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    found = [e for e in entries if e["name"] == name]
    if not found:
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")
    return found[0]


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, name: str):
    """The module whose ``read(rec)`` gives metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(path)
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{root / 'metrics'}")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, repo: Path, name: str, root: Optional[Path] = None):
        self.repo = Path(repo)
        self.root = Path(root or self.repo / "gpubench")
        bench = load_json(self.repo / "BENCHMARK.json")
        entry = _named(bench["workloads"], name, "workload")
        self.name, self.chips = name, entry["chips"]
        self.config = load_json(self.repo / _named(
            bench["configs"], entry["config"], "configuration")["file"])
        self.traffic = load_json(self.root / "traffic"
                                 / f"{entry['traffic']}.json")
        self.limits = load_json(self.root / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


class Ctx:
    """What a generator is given: the configuration, the traffic, the seed,
    the device and ``rng``, a ``torch.Generator`` on it seeded from the
    seed."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device = torch.device(device)
        self.family = importlib.import_module(
            f"gpubench.families.{self.cfg['family']}")
        self.rng = torch.Generator(device=self.device)
        self.rng.manual_seed(seed % 2 ** 64)
        self.tf32 = bool(self.cfg.get("allow_tf32", False))
        self._set_tf32(self.tf32)

    def clock(self) -> Callable[[str], float]:
        """A set-up clock: each call synchronizes, records the seconds
        since the previous call (or the clock's making) under its name in
        ``setup_parts`` and returns them."""
        self.setup_parts: Dict[str, float] = {}
        last = [time.perf_counter()]

        def lap(name: str) -> float:
            self.sync()
            now = time.perf_counter()
            self.setup_parts[name] = now - last[0]
            last[0] = now
            return self.setup_parts[name]
        return lap

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _set_tf32(on: bool):
        import torch
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    @contextlib.contextmanager
    def precision(self, tf32: bool):
        """TF32 on or off for the block, the configuration's after."""
        self._set_tf32(tf32)
        try:
            yield
        finally:
            self._set_tf32(self.tf32)


def window(step: Callable[[int], None], seconds: float,
           sync: Callable[[], None], start: int = 0):
    """Steps from ``start`` until ``seconds`` have passed since a
    synchronize, then a synchronize: (steps, seconds to the last
    synchronize). Every step's work ends inside the window."""
    sync()
    t0 = time.perf_counter()
    i = start
    while True:
        step(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    return i - start, time.perf_counter() - t0


def _card() -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return {"nvidia_smi": out.stdout.strip()}
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"not read: {exc}"}


def run_cell(repo: Path, name: str, seed: int, seconds: float,
             trace: bool, t0: float, device="cuda", root=None,
             log=sys.stderr) -> Dict:
    """One run of cell ``name``; returns the result line's object, and
    writes the info line and the checks to ``log``. ``t0`` is the host
    clock at the process's start (set-up is measured from it)."""
    import torch
    from gpubench import trace as tracing
    from gpubench import work as counting
    cell = Cell(repo, name, root)
    t_harness = time.perf_counter()
    readers = {m["name"]: reader(cell.root, m["name"])
               for m in cell.metrics(trace)}
    ctx = Ctx(cell, seed, device)
    gen = importlib.import_module(
        f"gpubench.generators.{cell.traffic['generator']}")
    run = gen.Run(ctx)
    ctx.setup_parts = dict(before_harness=t_harness - t0, **ctx.setup_parts)
    rec = {"generator": cell.traffic["generator"],
           "unit": cell.config["unit"],
           "units_per_step": run.units, "setup_s": time.perf_counter() - t0,
           "traffic": cell.traffic, "posterior_s":
           getattr(run, "posterior_s", None)}
    if not trace:
        steps, secs = window(run.step, seconds, ctx.sync)
        rec["window"] = {"steps": steps, "seconds": secs}
        attempted = steps
    else:
        third = seconds / 3
        steps, secs = window(run.step, third, ctx.sync)
        rec["window"] = {"steps": steps, "seconds": secs}
        split: Dict[str, List[float]] = {}
        if hasattr(run, "split_step"):
            t_split = time.perf_counter()
            while True:
                for k, v in run.split_step(steps).items():
                    split.setdefault(k, []).append(v)
                steps += 1
                if time.perf_counter() - t_split >= third:
                    break
        rec["split"] = split
        rec["stretch"] = tracing.profile_steps(run.step, steps, third,
                                               ctx.sync, window)
        steps += rec["stretch"]["ran"]
        attempted = steps
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    info = dict(run.info(attempted), setup_s=rec["setup_s"],
                setup_parts=ctx.setup_parts,
                window=rec["window"], memory_peak_bytes=peak, **_card())
    got = run.result()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = run.expected()
    checks = gen.compare(got, want)
    info["reference_s"] = time.perf_counter() - t_ref
    failed = run.failed(got)
    if trace:
        rec["work"] = counting.count(
            ctx.family.reference, cell.config, cell.traffic,
            cell.config["estimator"].get("layer_filter"))
        info["stretch"] = {k: v for k, v in rec["stretch"].items()
                           if k not in ("device_ops", "idle_gaps")}
    print("gpubench info: " + json.dumps(info), file=log, flush=True)
    metrics = {}
    for m in cell.metrics(trace):
        value = readers[m["name"]].read(rec)
        if value is None:
            raise RuntimeError(f"{name}: metric {m['name']} read nothing")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.limits
    if set(limits) != set(checks):
        raise KeyError(f"{name}: checks {sorted(checks)} but limits "
                       f"{sorted(limits)}")
    correct = failed == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items())
    for k, v in checks.items():
        print(f"check {k} {v!r} limit {limits[k]!r}", file=log, flush=True)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if ctx.device.type == "cuda"
                         else ctx.device.type,
                         "kind": (torch.cuda.get_device_name(ctx.device)
                                  if ctx.device.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = rec["stretch"]["busy_s"]
        result["device"]["window_s"] = rec["stretch"]["window_s"]
        result["breakdown"] = {k: rec["stretch"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def barred_modules() -> List[str]:
    """Loaded modules whose top-level name is barred."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BARRED)
