"""The control on the card: the reference put in the program's place and
computed with TF32 on (the precision below the configurations' float32)
must fail the cell's limits, while the program at float32 passes them.
Each cell at a batch a test run holds; ``gpubench/calibrate.py`` reads the
same numbers at the cells' own sizes. Marked ``cuda``: skips without a
card."""
import pytest
import torch

from gpubench import calibrate, harness

#: each cell's traffic cut to what a test run holds
SMALL = {"resnet50.fit-b128": {"batch": 16, "distinct_batches": 2},
         "gpt2-124m.fit-t1024": {"seq_len": 256, "distinct_batches": 2},
         "resnet50.bnn30-b64": {"batch": 16, "fit_batch": 16,
                                "distinct_batches": 2, "check_batches": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.Cell(harness.ROOT.parent, name)
    cell.traffic = dict(cell.traffic, **SMALL[name])
    out = calibrate.readings(cell, 20240601, 1.0)
    assert out["failed"] == 0
    for key, limit in cell.limits.items():
        assert out["program"][key] <= limit, (key, out)
    assert any(out["control"][k] > limit
               for k, limit in cell.limits.items()), out
