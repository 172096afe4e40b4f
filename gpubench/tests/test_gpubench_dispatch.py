"""The harness's dispatch on the CPU: toy cells and a toy metric added as
files alone run through ``run_cell`` with the chip check skipped, and a
run whose timed path is broken underneath comes out not correct."""
import subprocess
import sys
import time

import numpy as np
import pytest

from gpubench import harness
from gpubench.tests import toy


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    return toy.make(tmp_path_factory.mktemp("toyrepo"))


def run(repo, cell, trace=False, seed=2 ** 31 + 11):
    return harness.run_cell(repo, cell, seed, 0.3, trace,
                            time.perf_counter(), device="cpu")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_toy_cells_run(repo, cell, trace):
    result = run(repo, cell, trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    want = harness.Cell(repo, cell).metrics(trace)
    assert set(result["metrics"]) == {m["name"] for m in want}
    for m in want:
        value = result["metrics"][m["name"]]["value"]
        assert np.isfinite(value) and value >= 0
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    if cell == "toy.fit" and trace:
        assert result["metrics"]["toy_steps"]["value"] >= 1


def _broken_update(kind):
    from curvature_tpu_torch.estimators.kfac import KFAC
    original = KFAC.update

    def unchanged(self, x, labels=None, generator=None, num_samples=1):
        return self.state

    def half(self, x, labels=None, generator=None, num_samples=1):
        n = x.shape[0] // 2
        return original(self, x[:n], labels[:n], generator, num_samples)
    return {"unchanged": unchanged, "half_batch": half}[kind]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", ["toy.fit", "toy.lm"])
def test_broken_fit_is_not_correct(repo, cell, fault, monkeypatch):
    from curvature_tpu_torch.estimators.kfac import KFAC
    monkeypatch.setattr(KFAC, "update", _broken_update(fault))
    assert run(repo, cell)["correct"] is False


def test_altered_answer_is_not_correct(repo, monkeypatch):
    import curvature_tpu_torch.eval as port_eval
    original = port_eval.eval_bnn

    def altered(*args, **kwargs):
        probs, labels, stats = original(*args, **kwargs)
        probs = probs.copy()
        probs[0] = np.roll(probs[0], 1)
        return probs, labels, stats
    monkeypatch.setattr(port_eval, "eval_bnn", altered)
    assert run(repo, "toy.eval")["correct"] is False


def test_no_card_no_result(repo):
    """Without CUDA (3) or without the measured package (2) the runner
    exits non-zero and prints no result; run from a folder that holds only
    the benchmark's files."""
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "toy.fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
