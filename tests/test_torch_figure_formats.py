"""The port's figures in SVG and PNG beside PDF: one layout, three
canvases (``utils/pdf.py``, ``utils/svg.py``, ``utils/png.py``).

Every figure of ``tests/test_torch_plot.py``'s cases is written in the
three formats: the SVG parses (``xml.etree``) and holds the PDF's strings
in order and one painted element per PDF paint operator; the PNG decodes
with PIL at ``figsize x dpi`` pixels, RGBA, a white page with ink inside
every axes frame that holds data. Lines sit at the pixels the frame maps
their data to, and a string drawn from DejaVu Sans's outlines covers the
pixels that matplotlib's Agg renderer inks for the same string, font and
size (IoU of the thresholded ink >= 0.85; the measured figures are in the
test). A suffix the port does not write raises naming it.
"""
import io
import os

import numpy as np
import pytest
from PIL import Image

from curvature_tpu_torch.utils import figure as tfig
from curvature_tpu_torch.utils import pdf as tpdf
from curvature_tpu_torch.utils import png as tpng
from curvature_tpu_torch.utils import svg as tsvg
from tests.test_torch_plot import CASES
from tests.test_torch_plot import tplot

FIGURES = sorted(k for k in CASES if k != "ood_panels")
#: the cases whose data leave the axes empty (no finite positive value)
EMPTY = ("spectral_density_nonpositive", "spectral_density_empty")


def _figure(case):
    out = CASES[case](tplot, None)
    return out.figure if isinstance(out, tfig.Axes) else out


@pytest.mark.parametrize("case", FIGURES)
def test_svg_holds_the_pdfs_drawing(tmp_path, case):
    fig = _figure(case)
    fig.savefig(str(tmp_path / "f.pdf"))
    fig.savefig(str(tmp_path / "f.svg"))
    want = tpdf.read_pdf(str(tmp_path / "f.pdf"))
    got = tsvg.read_svg(str(tmp_path / "f.svg"))
    stand_in = {ord(k): v for k, v in tpdf._STAND_INS.items()}
    assert [s.translate(stand_in) for s in got["strings"]] == \
        want["strings"]
    assert got["painted"] == want["painted"]
    assert got["bytes"] == os.path.getsize(tmp_path / "f.svg")


@pytest.mark.parametrize("case", FIGURES)
def test_png_page_and_ink(tmp_path, case):
    fig = _figure(case)
    path = str(tmp_path / "f.png")
    fig.savefig(path, dpi=50)
    img = Image.open(path)
    assert img.mode == "RGBA"
    w, h = (round(v * 50) for v in fig.figsize)
    assert img.size == (w, h)
    a = np.asarray(img).astype(int)
    assert (a[0, 0] == 255).all() and (a[..., 3] == 255).all()
    for ax in fig.axes:
        x, y, aw, ah = ax.rect
        box = a[round((1 - y - ah) * h) - 1:round((1 - y) * h) + 1,
                round(x * w) - 1:round((x + aw) * w) + 1, :3]
        if isinstance(ax, tfig.Axes3D):
            continue
        # the frame, and inside it the data where there is any
        assert (box[:, :3] < 250).any(), (case, ax.rect)
        if case not in EMPTY:
            assert (box[4:-4, 4:-4] < 250).any(), (case, ax.rect)


def _line_figure():
    fig, ax = tfig.subplots(figsize=(4, 3))
    ax.plot([0.0, 1.0], [0.25, 0.25], color="k")
    ax.axvline(0.5, color="k")
    return fig, ax


def test_png_lines_sit_where_the_frame_maps_them(tmp_path):
    fig, ax = _line_figure()
    dpi = 100
    path = str(tmp_path / "l.png")
    fig.savefig(path, dpi=dpi)
    a = np.asarray(Image.open(path))[..., :3].astype(int).sum(-1)
    W, H = fig.figsize[0] * 72.0, fig.figsize[1] * 72.0
    frame = tfig._Frame(ax, W, H)
    col = float(frame.px(0.5)) * dpi / 72.0
    row = (H - float(frame.py(0.25))) * dpi / 72.0
    mid_row = (H - float(frame.py(sum(frame.ylim) / 2 + 0.3 * (
        frame.ylim[1] - frame.ylim[0])))) * dpi / 72.0
    r, c = int(row), int(col)
    # the horizontal line: dark at its row, white 5 px above and below
    x = int(float(frame.px(0.2)) * dpi / 72.0)
    assert a[r, x] < 200 and a[r - 5, x] == 765 and a[r + 5, x] == 765
    # the vertical line: dark at its column, white 5 px to either side
    y = int(mid_row)
    assert a[y, c] < 200 and a[y, c - 5] == 765 and a[y, c + 5] == 765


@pytest.mark.parametrize("size,dpi", [(12.0, 300), (64.0, 100)])
def test_png_text_matches_matplotlib_agg(size, dpi):
    """'Reliability 0.25 (ECE)' left and baseline anchored at one point
    of the page, drawn from DejaVu Sans's outlines (kerned, the origin on
    a whole pixel) against matplotlib's Agg with its defaults: IoU of the
    pixels darker than mid grey >= 0.85. Measured: 0.894 at 12 pt and 300
    dpi, 0.936 at 64 pt and 100 dpi. Agg hints the outlines (stems and
    heights snapped to the pixel grid) and the port does not: at 8-10 pt
    and 300 dpi the same string measures 0.81-0.82."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    text = "Reliability 0.25 (ECE)"
    W, H = (360.0, 48.0) if dpi == 300 else (720.0, 108.0)
    x, y = 20.0, 16.0 if dpi == 300 else 30.0
    c = tpng.Canvas(W, H, dpi=dpi)
    c.rect(0, 0, W, H, fill=(1.0, 1.0, 1.0, 1.0))
    c.text(x, y, text, size, (0.0, 0.0, 0.0, 1.0))
    ours = c.pixels()[..., :3].mean(-1) < 128
    with matplotlib.rc_context(matplotlib.rcParamsDefault):
        fig = plt.figure(figsize=(W / 72.0, H / 72.0), dpi=dpi)
        fig.text(x / W, y / H, text, fontsize=size, family="DejaVu Sans",
                 ha="left", va="baseline")
        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=dpi)
        plt.close(fig)
    theirs = np.asarray(Image.open(buf))[..., :3].mean(-1) < 128
    assert ours.shape == theirs.shape
    iou = (ours & theirs).sum() / (ours | theirs).sum()
    assert iou >= 0.85, iou


def test_text_width_is_dejavus_advance():
    """The PNG's string advance is DejaVu Sans's, as matplotlib measures
    it (within a pixel at 100 dpi)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.font_manager import FontProperties
    from matplotlib.textpath import TextPath
    text = "Accuracy [%]"
    path = TextPath((0, 0), text, size=10,
                    prop=FontProperties(family="DejaVu Sans"))
    bb = path.get_extents()
    assert abs(tpng.text_width(text, 10.0) - bb.x1) < 1.0


@pytest.mark.parametrize("suffix", ["eps", "jpg"])
def test_unsupported_suffix_raises(tmp_path, suffix):
    fig, _ = _line_figure()
    with pytest.raises(ValueError, match=f"'{suffix}'.*pdf, svg, png"):
        fig.savefig(str(tmp_path / f"f.{suffix}"))
    assert not os.listdir(tmp_path)


def test_format_argument_and_dpi(tmp_path):
    """``format`` wins over the suffix, as in matplotlib; ``dpi`` sets the
    PNG's pixels and its pHYs chunk."""
    fig, _ = _line_figure()
    path = str(tmp_path / "f.out")
    fig.savefig(path, format="png", dpi=72)
    img = Image.open(path)
    assert img.size == (288, 216)
    assert round(img.info["dpi"][0]) == 72
    fig.savefig(str(tmp_path / "g.svg"), format="svg")
    assert tsvg.read_svg(str(tmp_path / "g.svg"))["painted"] > 0
