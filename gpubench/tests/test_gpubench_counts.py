"""The work counts from the layer shapes (CPU, the meta device): the
published sizes of both configurations, the Gram formula of the
patch-Gram kernels' bound, and shares that cannot pass 100% for an
implementation that does the counted work."""
import pytest
import torch

from gpubench import peaks, work
from gpubench.reference import gpt2, resnet
from gpubench.tests import tiny


def test_resnet50_counts():
    cfg = tiny.config("resnet50-imagenet")
    w = work.count(resnet, cfg, {"batch": 1})
    assert w.units == 1
    assert w.forward_macs == 4_089_184_256                  # 4.09 GMAC
    assert work.parameters(resnet, cfg) == 25_557_032
    # the port's KFAC state: an A factor of side fan_in for the bias-free
    # convs, 2049 for the fc (the kernels' [F+1] Grams would hold
    # 153,957,381 floats)
    assert w.state_floats == 153_851_562
    assert round(w.gram_flops / 1e9, 2) == 25.11
    assert round(w.fit_flops() / 1e9, 2) == 41.23
    assert round(w.eval_flops(30) / 1e9, 1) == 245.4


def test_resnet50_state_is_the_ports():
    from curvature_tpu_torch import estimators, models
    cfg = tiny.config("resnet50-imagenet")
    est = estimators.KFAC(models.resnet50(device="cpu"))
    floats = sum(t.numel() for f in est.state.values() for t in f.values())
    assert floats == work.count(resnet, cfg, {"batch": 1}).state_floats


def test_gpt2_124m_counts():
    cfg = tiny.config("gpt2-124m")
    params = work.parameters(gpt2, cfg)
    head = cfg["vocab_size"] * cfg["n_embd"]
    assert head == 38_597_376
    assert params - head == 124_439_808
    assert params == 163_037_184
    w = work.count(gpt2, cfg, {"batch": 1, "seq_len": 1024}, "h.*")
    assert w.units == 1024
    assert w.gram_flops / w.units == 325_859_424     # 326 MFLOP a token
    assert round(2 * w.forward_macs / w.units / 1e6, 1) == 284.8
    # the untracked head's input gradient is counted, the first layer's not
    assert w.backward_macs < w.forward_macs


@pytest.mark.parametrize("shape,kernel,stride,pad", [
    ((16, 56, 56, 64), (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((32, 56, 56, 128), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((8, 224, 224, 3), (7, 7), (2, 2), ((3, 3), (3, 3)))])
def test_gram_count_is_the_kernels_bound(shape, kernel, stride, pad):
    b, h, w_, c = shape
    ho = (h + sum(pad[0]) - kernel[0]) // stride[0] + 1
    wo = (w_ + sum(pad[1]) - kernel[1]) // stride[1] + 1
    side = c * kernel[0] * kernel[1] + 1            # with the ones column
    flops, nbytes = peaks.gram_bound(shape, kernel, stride, pad)
    assert peaks.gram_flops(b * ho * wo, side) == flops
    assert peaks.gram_bytes(b * h * w_ * c, side) == nbytes


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e12),
                                          (3.3e12, 6.7e10)])
def test_no_share_passes_100(flops, nbytes):
    # the fastest a run of the counted work can be on the card: every
    # FLOP at the f32-accurate peak and every byte at the memory rate
    fastest = max(flops / (495e12 / 3), nbytes / 3.35e12)
    assert peaks.least_seconds(flops, nbytes) / fastest <= 1.0 + 1e-12


def test_mfu_reader_at_the_peak():
    from gpubench import harness
    cfg = tiny.resnet()
    w = work.count(resnet, cfg, {"batch": 4})
    seconds = w.fit_flops() / peaks.F32_ACCURATE_FLOPS
    rec = {"generator": "fit", "unit": "img", "units_per_step": 4, "work": w,
           "window": {"steps": 1, "seconds": seconds}}
    mfu = harness.reader(harness.ROOT, "mfu.fit_img_s").read(rec)
    assert mfu == pytest.approx(100.0)
    rec["split"] = {"update_state_s": [w.factor_seconds()]}
    roof = harness.reader(harness.ROOT, "factor_roofline.fit_img_s")
    assert roof.read(rec) == pytest.approx(100.0)


def test_counts_need_no_memory():
    before = torch.empty(0).device
    work.count(resnet, tiny.config("resnet50-imagenet"), {"batch": 128})
    assert torch.empty(0).device == before
