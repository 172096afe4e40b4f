"""The span recorder of ``curvature_tpu_torch/utils/monitor.py`` on a small
conv model: silent without a profiler or ``tracing()``; under either, an
update's ``capture`` (its forward and backward as children) and
``update_state`` (one ``factor`` per tracked layer and side, with the
route the estimator takes) share the update's ``step``, nest, and sit on
the profiler's clock; the buffer is bounded and read without clearing;
the eval's member loop records each member; recording leaves the factor
state bit-identical."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from curvature_tpu_torch import estimators as port_est
from curvature_tpu_torch import eval as port_eval
from curvature_tpu_torch import models as tmodels
from curvature_tpu_torch import nn as tnn
from curvature_tpu_torch.utils import monitor

torch.set_num_threads(1)

LAYERS = ("c1", "c2", "fc")


def _model(device="cpu"):
    tm = tnn.Sequential([tnn.Conv(3, 8, 3, padding=1, name="c1"),
                         tnn.ReLU(),
                         tnn.Conv(8, 8, 3, padding=1, name="c2"),
                         tnn.ReLU(), tnn.Flatten(),
                         tnn.Dense(8 * 8 * 8, 10, name="fc")])
    tmodels.load_jax_variables(tm, tmodels.seeded_variables(tm, 0))
    return tm.to(device)


def _batch(device="cpu"):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 8, 8, generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    return x.to(device), y.to(device)


@pytest.fixture(autouse=True)
def empty_buffer():
    monitor.clear_spans()
    yield
    monitor.clear_spans()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_nothing_recorded_without_profiler_or_tracing():
    tm = _model()
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False)
    est.update(x, labels=y)
    est.invert(1.0, 1.0)
    est.ensemble_params(2, generator=torch.Generator().manual_seed(0))
    port_eval.eval_bnn(tm, est, [(x, y.numpy())], samples=2,
                       generator=torch.Generator().manual_seed(0))
    assert monitor.spans() == [] and monitor.dropped_spans() == 0


def test_update_under_profiler_records_its_phases_and_factors():
    tm = _model()
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False)
    est.update(x, labels=y)
    with profile(activities=[ProfilerActivity.CPU]):
        est.update(x, labels=y)
    spans = monitor.spans()
    by_id = {s.id: s for s in spans}
    (cap,) = _by_name(spans, "capture")
    (upd,) = _by_name(spans, "update_state")
    assert cap.attrs == {"step": 2} and upd.attrs == {"step": 2}
    assert cap.parent is None and upd.parent is None
    assert cap.end_ns <= upd.start_ns
    assert cap.device_ms is None and upd.device_ms is None
    for child in ("capture.forward", "capture.backward"):
        (s,) = _by_name(spans, child)
        assert s.parent == cap.id
    fwd, bwd = (_by_name(spans, n)[0]
                for n in ("capture.forward", "capture.backward"))
    assert fwd.end_ns <= bwd.start_ns
    factors = _by_name(spans, "factor")
    assert sorted((s.attrs["layer"], s.attrs["side"]) for s in factors) \
        == sorted((n, side) for n in LAYERS for side in "ag")
    for s in factors:
        assert s.parent == upd.id
        meta = est.metas[s.attrs["layer"]]
        if s.attrs["side"] == "a":
            assert s.attrs["route"] == est.a_route(
                meta, tuple(s.attrs["shape"]), 4)
        else:
            assert s.attrs["route"] == "plain"
            assert s.attrs["shape"][0] == 1
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_spans_share_the_profilers_clock():
    """Each span's ends lie within 1 ms of the profiler's own range of the
    same name (its ``record_function``): the factor ranges are named by
    side, layer and route."""
    tm = _model()
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False)
    with profile(activities=[ProfilerActivity.CPU]):
        est.update(x, labels=y)
    monitor.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.update(x, labels=y)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = monitor.spans()
    assert len(spans) == 4 + 2 * len(LAYERS)
    for s in spans:
        label = " ".join([s.name] + [str(s.attrs[k]) for k in
                                     monitor.LABEL_ATTRS if k in s.attrs])
        (start, end), = ranges[label]
        assert abs(s.start_ns - start) < 1_000_000, label
        assert abs(s.end_ns - end) < 1_000_000, label
    assert "factor a c2 patches" in ranges and "capture" in ranges


def test_tracing_records_bounded_and_reads_without_clearing(monkeypatch):
    tm = _model()
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False)
    with monitor.tracing():
        est.update(x, labels=y)
    whole = monitor.spans()
    assert len(whole) == 4 + 2 * len(LAYERS)
    assert monitor.spans() == whole
    monitor.clear_spans()
    monkeypatch.setattr(monitor, "MAX_SPANS", 3)
    with monitor.tracing():
        est.update(x, labels=y)
    kept = monitor.spans()
    assert len(kept) == 3
    assert monitor.dropped_spans() == len(whole) - 3
    assert [s.name for s in kept] == [s.name for s in whole[:3]]
    monitor.clear_spans()
    assert monitor.spans() == [] and monitor.dropped_spans() == 0
    est.update(x, labels=y)
    assert monitor.spans() == []


def test_member_loop_records_each_member():
    tm = _model()
    tm.vmap_ensemble = False
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False)
    est.update(x, labels=y)
    est.invert(1.0, 1.0)
    batches = [(x[:2], y[:2].numpy()), (x[2:], y[2:].numpy())]
    with monitor.tracing():
        port_eval.eval_bnn(tm, est, batches, samples=3,
                           generator=torch.Generator().manual_seed(0))
    spans = monitor.spans()
    (top,) = _by_name(spans, "eval_bnn")
    (sample,) = _by_name(spans, "sample")
    assert sample.parent == top.id and sample.attrs == {"members": 3}
    forwards = _by_name(spans, "eval.forward")
    assert [s.attrs for s in forwards] == [
        {"members": 3, "route": "loop"}] * 2
    members = _by_name(spans, "eval.member")
    assert len(members) == 2 * 3
    parents = {s.parent for s in members}
    assert parents == {s.id for s in forwards}
    assert [s.attrs["member"] for s in members] == [0, 1, 2] * 2
    assert len(_by_name(spans, "eval.to_host")) == 2


@pytest.mark.parametrize("record", ["tracing", "profiler"])
def test_recording_leaves_the_factor_state_unchanged(record):
    tm = _model()
    x, y = _batch()
    plain = port_est.KFAC(tm, use_kernels=False)
    plain.update(x, labels=y)
    traced = port_est.KFAC(tm, use_kernels=False)
    with (monitor.tracing() if record == "tracing"
          else profile(activities=[ProfilerActivity.CPU])):
        traced.update(x, labels=y)
    assert len(monitor.spans()) == 4 + 2 * len(LAYERS)
    for name in plain.state:
        for key, t in plain.state[name].items():
            assert torch.equal(t, traced.state[name][key]), (name, key)


@pytest.mark.parametrize("option", ["stack_grams", "fused_g"])
def test_stack_grams_and_fused_g_name_their_routes(option):
    """Under ``stack_grams`` the batched products are one ``stack_grams``
    span (c1 and c2 share their G tokens' shape: one bucket) and the
    bucketed factors carry that route; under ``fused_g`` every G is a
    ``tap``."""
    tm = _model()
    x, y = _batch()
    est = port_est.KFAC(tm, use_kernels=False, **{option: True})
    with monitor.tracing():
        est.update(x, labels=y)
    spans = monitor.spans()
    (upd,) = _by_name(spans, "update_state")
    routes = {(s.attrs["layer"], s.attrs["side"]): s.attrs["route"]
              for s in _by_name(spans, "factor")}
    assert set(routes) == {(n, side) for n in LAYERS for side in "ag"}
    assert {routes[(n, "a")] for n in LAYERS} == {"patches"}
    if option == "stack_grams":
        (stack,) = _by_name(spans, "stack_grams")
        assert stack.parent == upd.id and stack.attrs == {"buckets": 1}
        assert [routes[(n, "g")] for n in LAYERS] == [
            "stack_grams", "stack_grams", "plain"]
    else:
        assert {routes[(n, "g")] for n in LAYERS} == {"tap"}


@pytest.mark.cuda
def test_device_timed_phases_under_a_device_only_profile():
    """On the card, a profiler tracing device activity alone turns
    recording on, and ``capture`` and ``update_state`` carry the device's
    elapsed ms between their events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tm = _model("cuda")
    x, y = _batch("cuda")
    est = port_est.KFAC(tm)
    est.update(x, labels=y)
    with profile(activities=[ProfilerActivity.CUDA]):
        est.update(x, labels=y)
        torch.cuda.synchronize()
    spans = monitor.spans()
    for name in ("capture", "update_state"):
        (s,) = _by_name(spans, name)
        assert s.device_ms is not None and s.device_ms > 0, s
    assert all(s.device_ms is None for s in _by_name(spans, "factor"))
