"""The port's figures (``pipelines/plot.py`` on ``utils/figure.py`` and
``utils/pdf.py``) against JAX's ``plot.py`` on matplotlib (Agg).

Each case gives both packages the same seeded numpy inputs (200 images
of 10 classes, an 11 x 9 loss grid, a 6-layer factor dict, a 12-point
damping search), catches every figure each package saves (JAX's is not
written) and holds the port's artists to what JAX handed matplotlib:
line data within 1e-5 of the series' max |value|, colours (RGBA),
line styles, markers and labels; bars, hatches and histograms (edges
within 1e-6, counts equal, or one count moved to its neighbour where an
input lies within f32 rounding of the edge between them); scatter offsets
and mapped colours, the colorbar's range and label; ``vlines``/``axvline``
positions; contour levels equal, each level's vertex set within 1e-9;
``clabel``'s texts; the 3-D panel's grid; labels, titles and legend
entries equal, the numbers formatted into them within 1e-5 relative;
scales; every 2-D axes' view limits (twins and the colorbar included)
within 1e-9 relative. Each PDF the port writes is parsed here on its own
(the xref offsets, every stream's /Length, startxref) and its text held
to the figure's.
"""
import os
import re

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as mplt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib import colors as mcolors  # noqa: E402

from curvature_tpu.pipelines import plot as jplot  # noqa: E402
from curvature_tpu_torch.pipelines import plot as tplot  # noqa: E402
from curvature_tpu_torch.utils import figure as tfig  # noqa: E402
from curvature_tpu_torch.utils import pdf as tpdf  # noqa: E402
from tests.torch_pdf_check import parse_pdf  # noqa: E402

NUMBER = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")


class _Cfg:
    data = "mnist"


def _probs(rng, n=200, k=10, sharp=3.0):
    logits = sharp * rng.standard_normal((n, k))
    p = np.exp(logits - logits.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    probs, ood = _probs(rng), _probs(rng, sharp=1.0)
    bnn, bnn_ood = _probs(rng, sharp=2.0), _probs(rng, sharp=0.7)
    labels = rng.integers(0, 10, 200)
    labels[:120] = probs[:120].argmax(1)            # ~60% accurate
    xs, ys = np.linspace(-1, 1, 11), np.linspace(-1, 1, 9)
    loss = 2.3 + np.add.outer(0.8 * ys ** 2, 1.3 * xs ** 2) \
        + 0.05 * rng.standard_normal((9, 11))
    state = {}
    for i in range(5):              # five KFAC layers and a diagonal one
        a = rng.standard_normal((5 + i, 5 + i))
        g = rng.standard_normal((3 + i, 3 + i))
        state[f"layer{i}"] = {"a": a @ a.T + 0.1 * np.eye(5 + i),
                              "g": g @ g.T + 0.1 * np.eye(3 + i)}
    state["fc_diag"] = np.abs(rng.standard_normal((4, 7)))
    hyper = {"norms": [[10 ** v] * 3 for v in rng.uniform(-3, 3, 12)],
             "scales": [[10 ** v] * 3 for v in rng.uniform(-3, 3, 12)],
             "cost": list(rng.uniform(0.5, 3.0, 12)),
             "acc": list(rng.uniform(10, 90, 12))}
    steps = np.concatenate([np.linspace(0, 0.2, 11), np.linspace(0.3, 1, 8)])
    fgsm = {k: list(rng.uniform(0, 90, 19)) for k in ("acc", "ece1", "ent")}
    fgsm_bnn = {k: list(rng.uniform(0, 90, 19)) for k in ("acc", "ece1",
                                                          "ent")}
    loss1d = {"xcoordinates": np.linspace(-1, 1, 11),
              "train_loss": 2 + np.linspace(-1, 1, 11) ** 2,
              "val_loss": 2.2 + np.linspace(-1, 1, 11) ** 2,
              "train_acc": 90 - 30 * np.linspace(-1, 1, 11) ** 2,
              "val_acc": 85 - 30 * np.linspace(-1, 1, 11) ** 2}
    history = {"loss": list(2.0 / np.arange(1, 9)),
               "val_acc": list(50 + 5 * np.arange(8.0))}
    ev = np.abs(rng.standard_normal(500)) ** 3 + 1e-6
    ritz = np.array([1e-3, 0.1, 2.0, 50.0])
    return dict(probs=probs, ood=ood, bnn=bnn, bnn_ood=bnn_ood,
                labels=labels, surface={"xcoordinates": xs,
                                        "ycoordinates": ys, "loss": loss},
                state=state, hyper=hyper, steps=steps, fgsm=fgsm,
                fgsm_bnn=fgsm_bnn, loss1d=loss1d, history=history, ev=ev,
                ritz=ritz, weights=np.array([0.4, 0.3, 0.2, 0.1]))


IN = _inputs()

#: id -> (call(plot_module, path or None), what the histograms bin)
CASES = {
    "training_curves": lambda p, d: p.training_curves(
        IN["history"], d and d + "/curves.pdf"),
    "factor_norms": lambda p, d: p.factor_norms(
        IN["state"], d and d + "/norms.pdf"),
    "calibration": lambda p, d: p.calibration(
        IN["probs"], IN["labels"], d and d + "/cal.pdf", label="NN",
        color="crimson"),
    "reliability_diagram": lambda p, d: p.reliability_diagram(
        IN["bnn"], IN["labels"], path=d and d + "/rel.pdf"),
    "confidence_hist": lambda p, d: p.confidence_hist(
        IN["probs"], d and d + "/conf.pdf"),
    "inv_ecdf_vs_pred_entropy": lambda p, d: p.inv_ecdf_vs_pred_entropy(
        IN["ood"], color="darkorange", linestyle="--", label="OOD",
        path=d and d + "/iecdf.pdf"),
    "true_false_ecdf": lambda p, d: p.true_false_ecdf(
        IN["probs"], IN["labels"], d and d + "/tf.pdf"),
    "entropy_hist": lambda p, d: p.entropy_hist(
        IN["probs"], IN["ood"], d and d + "/ent.pdf"),
    "eigenvalue_histogram": lambda p, d: p.eigenvalue_histogram(
        IN["ev"], d and d + "/eig.pdf", label="KFAC",
        true_spectrum=np.array([0.5, 1.5, 3.0, 1e4])),
    "spectral_density": lambda p, d: p.spectral_density(
        IN["ritz"], IN["weights"], d and d + "/dens.pdf", label="exact"),
    "adversarial_results": lambda p, d: p.adversarial_results(
        IN["steps"], IN["fgsm"], IN["fgsm_bnn"], d and d + "/adv"),
    "hyper_results": lambda p, d: p.hyper_results(
        IN["hyper"], d and d + "/hyper.pdf"),
    "plot_loss1d": lambda p, d: p.plot_loss1d(
        IN["loss1d"], d and d + "/loss1d.pdf"),
    "plot_surfaces": lambda p, d: p.plot_surfaces(
        IN["surface"], d and d + "/loss2d.pdf"),
    "ood_panels": lambda p, d: p.ood_panels(
        _Cfg, IN["probs"], IN["bnn"], IN["ood"], IN["bnn_ood"],
        IN["labels"], (d or "") + "/m"),
    # the degenerate inputs of tests/test_plot.py and their kin
    "spectral_density_nonpositive": lambda p, d: p.spectral_density(
        np.array([np.nan, -1.0, 0.0]), np.array([0.5, 0.3, 0.2]),
        d and d + "/dens0.pdf"),
    "spectral_density_empty": lambda p, d: p.spectral_density(
        np.zeros(0), np.zeros(0), d and d + "/dens_empty.pdf", label="x"),
    "eigenvalue_histogram_empty_with_overlay": lambda p, d:
        p.eigenvalue_histogram(np.array([0.0, -1.0, np.nan]),
                               d and d + "/eig0.pdf",
                               true_spectrum=np.array([0.5, 1.5, 3.0])),
    "eigenvalue_histogram_one_value": lambda p, d: p.eigenvalue_histogram(
        np.array([2.0]), d and d + "/eig1.pdf"),
    "true_false_ecdf_no_wrong": lambda p, d: p.true_false_ecdf(
        IN["probs"], IN["probs"].argmax(1), d and d + "/tf_right.pdf"),
    "training_curves_loss_only": lambda p, d: p.training_curves(
        {"loss": [3.0, 2.0, 1.5]}, d and d + "/curves1.pdf"),
    "hyper_results_one_point": lambda p, d: p.hyper_results(
        {"norms": [[1.0]], "scales": [[10.0]], "cost": [0.7]},
        d and d + "/hyper1.pdf"),
}


def _draw(module, call, monkeypatch, out_dir):
    """Every figure ``call`` saves, with its path; JAX's are not
    written, the port's are. matplotlib's contour sets keep their
    segments as ``contour`` made them (``clabel(inline=True)`` cuts
    them under the labels) in ``segs_before_clabel``."""
    from matplotlib.contour import ContourLabeler
    clabel = ContourLabeler.clabel

    def keep(cs, *a, **k):
        cs.segs_before_clabel = [[seg.copy() for seg in lev]
                                 for lev in cs.allsegs]
        return clabel(cs, *a, **k)
    monkeypatch.setattr(ContourLabeler, "clabel", keep)
    saved = []
    orig = module._save

    def save(fig, path):
        saved.append((fig, path))
        if module is tplot:
            orig(fig, path)
    monkeypatch.setattr(module, "_save", save)
    returned = call(module, out_dir)
    if not saved:                     # no path: the returned figure
        fig = returned if hasattr(returned, "axes") else returned.figure
        saved.append((fig, None))
    return saved


# -- holding the port's artists to matplotlib's ----------------------------

def _same_text(got: str, want: str):
    gn, wn = NUMBER.findall(got), NUMBER.findall(want)
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    for g, w in zip(gn, wn):
        assert abs(float(g) - float(w)) <= 1e-5 * max(abs(float(w)), 1e-3), \
            (got, want)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size:
        scale = max(np.nanmax(np.abs(want)) if np.isfinite(want).any()
                    else 0.0, 1e-300)
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=what)


def _lim(t, m, name, what):
    """The view limits within 1e-9 relative, widened by 1.2 times how
    far the port's data limits lie from matplotlib's (the margins scale
    those by 1.1): data that came through the metrics in f32 (entropies,
    confidences) differ from JAX's by rounding, and the view follows."""
    got = np.asarray(getattr(t, f"get_{name}lim")(), np.float64)
    want = np.asarray(getattr(m, f"get_{name}lim")(), np.float64)
    dt = np.asarray(t.data_limits(name), np.float64)
    shared = m._shared_axes[name].get_siblings(m)
    dm = np.array([min(getattr(a.dataLim, f"interval{name}")[0]
                       for a in shared),
                   max(getattr(a.dataLim, f"interval{name}")[1]
                       for a in shared)])
    if getattr(m, f"get_{name}scale")() == "log":
        got, want = np.log10(got), np.log10(want)
        with np.errstate(divide="ignore", invalid="ignore"):
            dt, dm = np.log10(dt), np.log10(dm)
    ok = np.isfinite(dt) & np.isfinite(dm)
    slack = 1.2 * np.abs(dt - dm)[ok].max() if ok.any() else 0.0
    tol = 1e-9 * max(np.abs(want).max(), abs(want[1] - want[0]), 1e-300)
    assert np.abs(got - want).max() <= tol + slack, (what, name, got, want)


def _rgba(c):
    return tuple(float(v) for v in mcolors.to_rgba(c))


def _hold_hist(mp, tp, data, what):
    """Bars of one histogram: edges within 1e-6, heights equal; a count
    that differs must have moved to its neighbour across an edge that an
    input lies within f32 rounding of (named in the message)."""
    for got, want, part in (([r.x for r in tp], [r.get_x() for r in mp],
                             "edges"),
                            ([r.width for r in tp],
                             [r.get_width() for r in mp], "widths")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=f"{what} {part}")
    got = np.array([r.height for r in tp])
    want = np.array([r.get_height() for r in mp])
    _close(got, want, 1e-5, what + " heights")
    # the counts (a density's height times the sample count and width)
    n = len(np.ravel(data))
    got = np.rint(got * (1 if np.all(got == np.rint(got)) else
                         n * np.array([r.width for r in tp])))
    want = np.rint(want * (1 if np.all(want == np.rint(want)) else
                           n * np.array([r.get_width() for r in mp])))
    bad = np.nonzero(got != want)[0]
    if len(bad):
        edges = [mp[i + 1].get_x() for i in bad[:-1]]
        near = [v for v in np.ravel(data) for e in edges
                if abs(v - e) <= 4 * np.finfo(np.float32).eps * max(abs(e), 1)]
        assert len(bad) == 2 and bad[1] == bad[0] + 1 and near and \
            np.isclose(got[bad].sum(), want[bad].sum()), \
            (what, bad, got[bad], want[bad])
        print(f"{what}: input {near[0]!r} at the edge {edges[0]!r} moved "
              "one count to its neighbour")


def _hold_axes(m, t, what, hist_data):
    assert t.name == m.name, what
    if m.name == "3d":
        mpolys = [m.collections[0]._vec[:3, s].T
                  for s in m.collections[0]._segslices]
        surf = t.collections[0]
        assert len(surf.polys) == len(mpolys), what
        for g, w in zip(surf.polys, mpolys):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
        return
    _same_text(t.xlabel, m.get_xlabel())
    _same_text(t.ylabel, m.get_ylabel())
    _same_text(t.title, m.get_title())
    assert t.ylabel_color == _rgba(m.yaxis.label.get_color()), what
    assert (t.get_xscale(), t.get_yscale()) == (m.get_xscale(),
                                                m.get_yscale()), what
    _lim(t, m, "x", what)
    _lim(t, m, "y", what)
    if t.colorbar is not None:                       # the colorbar's axes
        return
    if t.xticks is not None:
        np.testing.assert_array_equal(t.xticks, m.get_xticks())
        assert t.xticklabels == [s.get_text() for s in m.get_xticklabels()]
    mlines, tlines = m.get_lines(), t.lines
    assert len(tlines) == len(mlines), what
    for k, (ml, tl) in enumerate(zip(mlines, tlines)):
        w = f"{what} line {k}"
        _close(tl.x, ml.get_xdata(), 1e-5, w + " x")
        _close(tl.y, ml.get_ydata(), 1e-5, w + " y")
        assert tl.color == _rgba(ml.get_color()), w
        assert tl.alpha == ml.get_alpha(), w
        assert tl.linestyle == ml.get_linestyle(), w
        assert tl.marker == ml.get_marker(), w
        if ml.get_label().startswith("_"):
            assert tl.label.startswith("_"), w
        else:
            _same_text(tl.label, ml.get_label())
    mp, tp = m.patches, t.patches
    assert len(tp) == len(mp), what
    if hist_data is not None:
        # one histogram per call: split at each container
        start = 0
        for data, cont in zip(hist_data, m.containers):
            n = len(cont.patches)
            _hold_hist(mp[start:start + n], tp[start:start + n], data,
                       f"{what} hist")
            start += n
    else:
        _close([r.x for r in tp], [r.get_x() for r in mp], 1e-9, what)
        _close([r.width for r in tp], [r.get_width() for r in mp], 1e-9,
               what)
        _close([r.height for r in tp], [r.get_height() for r in mp], 1e-5,
               what)
    _close([r.y for r in tp], [r.get_y() for r in mp], 1e-5, what + " y")
    for r, q in zip(tp, mp):
        assert r.facecolor == _rgba(q.get_facecolor()), what
        assert r.edgecolor == _rgba(q.get_edgecolor()), what
        assert r.hatch == q.get_hatch(), what
    mc, tc = m.collections, t.collections
    assert len(tc) == len(mc), what
    for k, (q, c) in enumerate(zip(mc, tc)):
        w = f"{what} collection {k}"
        kind = type(q).__name__
        if kind == "PathCollection":
            _close(c.offsets, q.get_offsets(), 1e-12, w)
            _close(c.sizes, np.broadcast_to(q.get_sizes(), c.sizes.shape),
                   0, w)
            want = q.to_rgba(q.get_array()) if q.get_array() is not None \
                else q.get_facecolors()
            np.testing.assert_array_equal(c.facecolors, want, err_msg=w)
            if q.colorbar is not None:
                cb = c.colorbar
                assert (cb.vmin, cb.vmax) == pytest.approx(
                    (q.colorbar.vmin, q.colorbar.vmax), rel=1e-12), w
                assert cb.label == q.colorbar.ax.get_ylabel(), w
        elif kind == "LineCollection":
            _close(c.segments, np.asarray(q.get_segments()), 1e-12, w)
            assert c.color[:3] == tuple(q.get_colors()[0][:3]), w
            assert c.alpha == q.get_alpha(), w
        elif kind == "QuadContourSet":
            np.testing.assert_array_equal(c.levels, q.levels, err_msg=w)
            for lev, segs, msegs in zip(q.levels, c.allsegs,
                                        q.segs_before_clabel):
                got = np.unique(np.concatenate(segs).reshape(-1, 2), axis=0) \
                    if segs else np.zeros((0, 2))
                want = np.unique(np.concatenate(msegs), axis=0) if msegs \
                    else np.zeros((0, 2))
                assert got.shape == want.shape, (w, lev)
                if len(got):
                    # each vertex has its match within 1e-9, both ways
                    dist = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
                    assert dist.min(1).max() <= 1e-9 and \
                        dist.min(0).max() <= 1e-9, (w, lev)
            texts = [q.get_text(lv, q.labelFmt) for lv in q.labelLevelList]
            assert c.label_texts == texts, w
            assert {s.get_text() for s in q.labelTexts} <= set(texts), w
        else:
            raise AssertionError(f"{w}: unexpected {kind}")
    leg, tleg = m.get_legend(), t.get_legend()
    assert (leg is None) == (tleg is None), what
    if leg is not None:
        mt = [s.get_text() for s in leg.get_texts()]
        assert len(tleg.texts) == len(mt), (what, tleg.texts, mt)
        for g, wt in zip(tleg.texts, mt):
            _same_text(g, wt)
        assert tleg.frameon == leg.get_frame_on(), what


def _hist_data(case, d):
    """What each histogram of the case bins, from the JAX side's
    numbers (for naming an input that sits on an edge)."""
    from curvature_tpu.eval import metrics as jm
    ent = lambda p: np.asarray(jm.predictive_entropy(p))  # noqa: E731
    if case == "confidence_hist":
        return [np.asarray(jm.confidence(IN["probs"], mean=False))]
    if case == "entropy_hist":
        return [ent(IN["probs"]), ent(IN["ood"])]
    if case.startswith("eigenvalue_histogram"):
        ev = np.ravel(IN["ev"]) if case == "eigenvalue_histogram" else \
            np.array([2.0])
        return [np.log10(ev[ev > 0])]
    if d.endswith("_entropy.pdf"):
        pair = ("bnn", "bnn_ood") if "_bnn_" in d else ("probs", "ood")
        return [ent(IN[pair[0]]), ent(IN[pair[1]])]
    return None


def _expected_strings(fig):
    want = []
    for ax in fig.axes:
        want += [s for s in (ax.xlabel, ax.ylabel, ax.title) if s]
        if ax.legend_ is not None:
            want += ax.legend_.texts
    return want


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_figure_holds_to_matplotlibs(case, monkeypatch, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _draw(jplot, CASES[case], monkeypatch, jdir)
    got = _draw(tplot, CASES[case], monkeypatch, tdir)
    try:
        assert [p and os.path.relpath(p, tdir) for _, p in got] == \
            [p and os.path.relpath(p, jdir) for _, p in want]
        for (tf, path), (mf, _) in zip(got, want):
            assert isinstance(tf, tfig.Figure)
            assert len(tf.axes) == len(mf.axes), case
            hist = _hist_data(case, path or "")
            for k, (t, m) in enumerate(zip(tf.axes, mf.axes)):
                _hold_axes(m, t, f"{case} {path} axes {k}", hist)
            shown = parse_pdf(path)
            for s in _expected_strings(tf):
                assert s.replace("−", "-") in shown, (path, s, shown)
            info = tpdf.read_pdf(path)
            assert info["pages"] == 1 and info["strings"] == shown
            series = sum(len(a.children) for a in tf.axes
                         if not isinstance(a, tfig.Axes3D))
            assert info["painted"] >= series, (path, info)
    finally:
        mplt.close("all")


def test_fgsm_suffix_rule_and_non_pdf_suffix(tmp_path):
    """``adversarial_results`` appends ``_fgsm.pdf`` to a path without
    the suffix and keeps one with it (JAX :235-236); a ``.png`` path
    writes a PNG, and a figure path with a suffix the port does not write
    raises naming it."""
    base = str(tmp_path / "sweep")
    tplot.adversarial_results(IN["steps"], IN["fgsm"], IN["fgsm_bnn"], base)
    tplot.adversarial_results(IN["steps"], IN["fgsm"], IN["fgsm_bnn"],
                              base + ".pdf")
    assert sorted(os.listdir(tmp_path)) == ["sweep.pdf", "sweep_fgsm.pdf"]
    tplot.confidence_hist(IN["probs"], str(tmp_path / "c.png"))
    with open(tmp_path / "c.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(ValueError, match="'eps'"):
        tplot.confidence_hist(IN["probs"], str(tmp_path / "c.eps"))


def test_read_pdf_finds_structural_faults(tmp_path):
    """``read_pdf`` reads a written file and refuses one whose stream
    length, xref offset or startxref is off."""
    path = str(tmp_path / "f.pdf")
    tplot.confidence_hist(IN["probs"], path)
    info = tpdf.read_pdf(path)
    assert info["pages"] == 1 and "Confidence" in info["strings"]
    assert info["ops"]["re"] >= 30 and info["bytes"] == os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read()
    faults = {
        "length": re.sub(rb"/Length (\d+)", lambda m: b"/Length %d" % (
            int(m.group(1)) + 1), data, count=1),
        "xref": re.sub(rb"\n(\d{10}) 00000 n", lambda m: b"\n%010d 00000 n"
                       % (int(m.group(1)) + 1), data, count=1),
        "startxref": re.sub(rb"startxref\n(\d+)", lambda m: b"startxref\n%d"
                            % (int(m.group(1)) - 1), data),
    }
    for name, bad in faults.items():
        assert bad != data, name
        p = str(tmp_path / f"{name}.pdf")
        with open(p, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            tpdf.read_pdf(p)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.37, 2.9), (1e-4, 3e-4),
                                   (2.3, 2.31), (-250.0, 12000.0)])
def test_own_tick_locator_picks_nice_values(lo, hi):
    ticks = tfig.nice_ticks(lo, hi)
    assert 4 <= len(ticks) <= 10
    assert lo - 1e-12 <= ticks.min() and ticks.max() <= hi + 1e-12
    step = np.diff(ticks)
    mant = step[0] / 10 ** np.floor(np.log10(step[0]))
    assert np.allclose(step, step[0]) and \
        any(np.isclose(mant, m) for m in (1, 2, 2.5, 5))
