"""A toy repository for the CPU tests: a copy of this folder and of
``BENCHMARK.json`` to which toy cells and a toy metric are added as data
files and entries alone, as a later change adds a cell."""
import json
import shutil
from pathlib import Path

from gpubench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
CELLS = {"toy.fit": ("toy-resnet", "toy-fit"),
         "toy.lm": ("toy-gpt2", "toy-lm"),
         "toy.eval": ("toy-resnet", "toy-eval")}
TRAFFIC = {
    "toy-fit": {"generator": "fit", "batch": 4, "distinct_batches": 3,
                "warmup_steps": 1},
    "toy-lm": {"generator": "fit", "batch": 2, "seq_len": 16,
               "distinct_batches": 3, "warmup_steps": 1},
    "toy-eval": {"generator": "eval", "batch": 4, "samples": 3, "fit_batch": 8,
                 "distinct_batches": 3, "check_batches": 2}}
#: generous limits: the toy sizes normalize over few values a channel
LIMITS = {"toy.fit": {"a_rel": 1e-3, "g_rel": 1e-3},
          "toy.lm": {"a_rel": 1e-4, "g_rel": 1e-4},
          "toy.eval": {"probs_rel": 1e-4}}
TOY_METRIC = '''"""toy_steps: the window's steps."""


def read(rec):
    return float(rec["window"]["steps"])
'''
#: each real cell's stand-in, for the metrics' ``workloads``
STAND_IN = {"resnet50.fit-b128": "toy.fit", "gpt2-124m.fit-t1024": "toy.lm",
            "resnet50.bnn30-b64": "toy.eval"}


def make(dest: Path) -> Path:
    """The toy repository under ``dest``; returns its root."""
    shutil.copytree(HERE, dest / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", dest / "BENCHMARK.json")
    root = dest / "gpubench"
    for name, cfg in (("toy-resnet", tiny.resnet(name="toy-resnet")),
                      ("toy-gpt2", tiny.gpt2(name="toy-gpt2"))):
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, traffic in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, limits in LIMITS.items():
        (root / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (root / "metrics" / "toy_steps.py").write_text(TOY_METRIC)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": n, "source": "tiny test widths",
         "file": f"gpubench/configs/{n}.json", "reduced": [], "why": "test"}
        for n in ("toy-resnet", "toy-gpt2")]
    bench["workloads"] += [
        {"name": c, "config": cfg, "traffic": t, "chips": 1, "why": "test"}
        for c, (cfg, t) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [STAND_IN[w] for w in m["workloads"]]
    bench["per_layer"].append(
        {"name": "toy_steps", "unit": "steps", "better": "higher",
         "source": "host_clock", "layer": "whole step", "moves": "fit_img_s",
         "workloads": ["toy.fit"]})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
