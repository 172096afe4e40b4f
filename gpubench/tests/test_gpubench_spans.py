"""The readers of the program's phase spans (``spans.py``,
``metrics/capture_*_ms.py``, ``metrics/factors_*_ms.py``) on a
synthetic span list of three updates, one of them slowed: each returns
the median over the updates that recorded both phases, the device readers
from the events' elapsed times, and None where no update recorded both or
where the program has no recorder."""
import pytest

from curvature_tpu_torch.utils import monitor
from gpubench import harness

READERS = {"capture_host_ms": ("capture", "host"),
           "factors_host_ms": ("update_state", "host"),
           "capture_device_ms": ("capture", "device"),
           "factors_device_ms": ("update_state", "device")}

#: per step: (capture host ms, capture device ms, update_state host ms,
#: update_state device ms); step 2 is the slowed one
TIMES = {1: (100.0, 110.0, 300.0, 305.0), 2: (900.0, 950.0, 2000.0, 2100.0),
         3: (120.0, 125.0, 320.0, 330.0)}
WANT = {("capture", "host"): 120.0, ("capture", "device"): 125.0,
        ("update_state", "host"): 320.0, ("update_state", "device"): 330.0}


def _updates(steps=TIMES, step_attr=True):
    """Spans as the recorder gives them: each update's capture (with a
    child), its factors and its update_state, one after the other."""
    out, t, ids = [], 1_000_000_000, iter(range(1, 1000))
    for step, (ch, cd, uh, ud) in steps.items():
        attrs = {"step": step} if step_attr else {}
        cap, upd = next(ids), next(ids)
        out.append(monitor.Span(next(ids), cap, "capture.forward", t,
                                t + 1_000_000, {}, None))
        out.append(monitor.Span(cap, None, "capture", t,
                                t + int(ch * 1e6), dict(attrs), cd))
        t += int(ch * 1e6)
        out.append(monitor.Span(next(ids), upd, "factor", t, t + 5_000_000,
                                {"layer": "fc", "side": "a",
                                 "route": "patches", "shape": [4, 8]},
                                None))
        out.append(monitor.Span(upd, None, "update_state", t,
                                t + int(uh * 1e6), dict(attrs), ud))
        t += int(uh * 1e6)
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Make the program's recorder hold ``spans``."""
    def set_spans(spans):
        monkeypatch.setattr(monitor, "spans", lambda: list(spans))
    return set_spans


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_takes_the_median_over_updates(name, recorded):
    recorded(_updates())
    got = harness.reader(harness.ROOT, f"{name}.fit_img_s").read({})
    assert got == pytest.approx(WANT[READERS[name]], abs=1e-6)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_both_phases(name, recorded):
    reader = harness.reader(harness.ROOT, f"{name}.fit_tok_s")
    recorded(_updates(step_attr=False))
    assert reader.read({}) is None
    recorded([s for s in _updates() if s.name != "update_state"])
    assert reader.read({}) is None
    recorded([])
    assert reader.read({}) is None


def test_an_update_missing_a_phase_is_left_out(recorded):
    """Step 3's update_state is missing: the medians are of steps 1 and 2
    alone."""
    spans = _updates()
    spans = [s for s in spans if not (s.name == "update_state"
                                      and s.attrs["step"] == 3)]
    recorded(spans)
    got = harness.reader(harness.ROOT, "capture_host_ms.fit_img_s").read({})
    assert got == pytest.approx((100.0 + 900.0) / 2)


def test_device_readers_read_nothing_without_events(recorded):
    recorded([s._replace(device_ms=None) for s in _updates()])
    for name, (_, clock) in READERS.items():
        got = harness.reader(harness.ROOT, f"{name}.fit_img_s").read({})
        assert (got is None) == (clock == "device")


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(monitor, "spans")
    for name in READERS:
        assert harness.reader(harness.ROOT,
                              f"{name}.fit_img_s").read({}) is None


def test_readers_read_the_recorder_of_a_traced_update():
    """End to end on the CPU: a small KFAC update under ``tracing()`` gives
    both host readers a value, the device readers none."""
    import torch
    from curvature_tpu_torch import estimators, models, nn
    tm = nn.Sequential([nn.Conv(3, 4, 3, padding=1, name="c"), nn.ReLU(),
                        nn.Flatten(), nn.Dense(4 * 8 * 8, 5, name="fc")])
    models.load_jax_variables(tm, models.seeded_variables(tm, 0))
    est = estimators.KFAC(tm, use_kernels=False)
    x, y = torch.randn(2, 3, 8, 8), torch.tensor([1, 3])
    monitor.clear_spans()
    try:
        with monitor.tracing():
            est.update(x, labels=y)
            est.update(x, labels=y)
        for name, (_, clock) in READERS.items():
            got = harness.reader(harness.ROOT, f"{name}.fit_img_s").read({})
            assert (got is None) == (clock == "device")
            assert got is None or got > 0
    finally:
        monitor.clear_spans()
