"""An SVG 1.1 writer for the port's figures.

:class:`Canvas` has the drawing interface of ``utils/pdf.Canvas`` (paths,
rectangles, circles, hatching, text, clipping; points, the origin at the
bottom left), so ``utils/figure.render`` draws the same layout on either.
Each paint is one element (``<path>``, ``<rect>``, ``<circle>``): the
element count equals the PDF's count of paint operators. Alpha becomes
``fill-opacity``/``stroke-opacity``, a clip rectangle a ``<clipPath>``
whose group closes at ``pop_clip``, strokes have round caps and joins as
in the PDF. Text is one ``<text>`` per string in Helvetica (the PDF's
base-14 font, with Arial and sans-serif after it), its anchor placed as
the PDF places it and its ``textLength`` the layout's
``figure.text_width``, so a string's box is the PDF's whatever font the
viewer has.
"""
import math
from typing import List, Sequence
from xml.sax.saxutils import escape

from curvature_tpu_torch.utils.pdf import _ASCENT, _DESCENT, _num


def _rgb(color) -> str:
    return "#" + "".join(f"{min(255, max(0, round(v * 255))):02x}"
                         for v in color[:3])


class Canvas:
    """One page of ``width`` x ``height`` points. Colours are RGBA tuples;
    ``alpha``, where given, replaces the colour's alpha."""

    def __init__(self, width: float, height: float):
        self.width, self.height = float(width), float(height)
        self.body: List[str] = []
        self.clips: List[str] = []
        self.depth = 0

    def _y(self, y: float) -> float:
        return self.height - y

    def _style(self, fill=None, stroke=None, alpha=None, width=1.0,
               dash=None) -> str:
        out = []
        if fill is None:
            out.append('fill="none"')
        else:
            fa = alpha if alpha is not None else fill[3]
            out.append(f'fill="{_rgb(fill)}"')
            if fa < 1.0:
                out.append(f'fill-opacity="{_num(fa)}"')
        if stroke is not None:
            sa = alpha if alpha is not None else stroke[3]
            out.append(f'stroke="{_rgb(stroke)}" stroke-width='
                       f'"{_num(width)}" stroke-linecap="round" '
                       'stroke-linejoin="round"')
            if sa < 1.0:
                out.append(f'stroke-opacity="{_num(sa)}"')
            if dash:
                out.append('stroke-dasharray="'
                           + " ".join(_num(d) for d in dash) + '"')
        return " ".join(out)

    @staticmethod
    def _visible(fill, stroke, alpha) -> bool:
        if fill is None and stroke is None:
            return False
        fa = (alpha if alpha is not None else fill[3]) if fill else 0.0
        sa = (alpha if alpha is not None else stroke[3]) if stroke else 0.0
        return fa > 0 or sa > 0

    def path(self, points: Sequence[Sequence[float]], close=False,
             fill=None, stroke=None, alpha=None, width=1.0, dash=None):
        pts = [(float(x), float(y)) for x, y in points]
        if len(pts) < 2 or not self._visible(fill, stroke, alpha):
            return
        d = "M" + " L".join(f"{_num(x)} {_num(self._y(y))}" for x, y in pts)
        if close:
            d += " Z"
        self.body.append(f'<path d="{d}" '
                         f'{self._style(fill, stroke, alpha, width, dash)}/>')

    def rect(self, x, y, w, h, fill=None, stroke=None, alpha=None,
             width=1.0):
        if not self._visible(fill, stroke, alpha):
            return
        x0, w = (x, w) if w >= 0 else (x + w, -w)
        y0, h = (y, h) if h >= 0 else (y + h, -h)
        self.body.append(
            f'<rect x="{_num(x0)}" y="{_num(self._y(y0 + h))}" '
            f'width="{_num(w)}" height="{_num(h)}" '
            f'{self._style(fill, stroke, alpha, width)}/>')

    def circle(self, x, y, r, fill=None, stroke=None, alpha=None,
               width=1.0):
        if not self._visible(fill, stroke, alpha):
            return
        self.body.append(
            f'<circle cx="{_num(x)}" cy="{_num(self._y(y))}" r="{_num(r)}" '
            f'{self._style(fill, stroke, alpha, width)}/>')

    def hatch(self, x, y, w, h, color, spacing=6.0, width=1.0):
        """Diagonal lines ('/') every ``spacing`` points, clipped to the
        rectangle: one path, as the PDF paints them at once."""
        if w <= 0 or h <= 0:
            return
        self.push_clip(x, y, w, h)
        parts, k = [], -h
        while k < w:
            parts.append(f"M{_num(x + k)} {_num(self._y(y))} "
                         f"L{_num(x + k + h)} {_num(self._y(y + h))}")
            k += spacing
        if parts:
            self.body.append(f'<path d="{" ".join(parts)}" '
                             f'{self._style(None, color, None, width)}/>')
        self.pop_clip()

    def push_clip(self, x, y, w, h):
        cid = f"c{len(self.clips)}"
        self.clips.append(
            f'<clipPath id="{cid}"><rect x="{_num(x)}" '
            f'y="{_num(self._y(y + h))}" width="{_num(w)}" '
            f'height="{_num(h)}"/></clipPath>')
        self.body.append(f'<g clip-path="url(#{cid})">')
        self.depth += 1

    def pop_clip(self):
        self.body.append("</g>")
        self.depth -= 1

    def text(self, x, y, text: str, size: float, color, halign="left",
             valign="baseline", rotation=0.0):
        """``text`` at ``size`` points, anchored as ``pdf.Canvas.text``
        anchors it, stretched to the layout's Helvetica advance."""
        from curvature_tpu_torch.utils.figure import text_width
        if not text:
            return
        w = text_width(text, size)
        dx = -w * {"left": 0.0, "center": 0.5, "right": 1.0}[halign]
        dy = size / 1000.0 * {"baseline": 0.0, "bottom": _DESCENT,
                              "top": -_ASCENT,
                              "center": -(_ASCENT - _DESCENT) / 2}[valign]
        t = math.radians(rotation)
        cs, sn = math.cos(t), math.sin(t)
        ox, oy = x + cs * dx - sn * dy, y + sn * dx + cs * dy
        turn = f" rotate({_num(-rotation)})" if rotation else ""
        opacity = (f' fill-opacity="{_num(color[3])}"'
                   if color[3] < 1.0 else "")
        self.body.append(
            f'<text transform="translate({_num(ox)} {_num(self._y(oy))})'
            f'{turn}" font-family="Helvetica, Arial, sans-serif" '
            f'font-size="{_num(size)}" textLength="{_num(w)}" '
            f'lengthAdjust="spacingAndGlyphs" fill="{_rgb(color)}"'
            f'{opacity} xml:space="preserve">{escape(text)}</text>')

    def document(self) -> bytes:
        if self.depth:
            raise ValueError(f"{self.depth} clip group(s) left open")
        w, h = _num(self.width), _num(self.height)
        head = ('<?xml version="1.0" encoding="utf-8" standalone="no"?>\n'
                '<!DOCTYPE svg PUBLIC "-//W3C//DTD SVG 1.1//EN" '
                '"http://www.w3.org/Graphics/SVG/1.1/DTD/svg11.dtd">\n'
                f'<svg xmlns="http://www.w3.org/2000/svg" version="1.1" '
                f'width="{w}pt" height="{h}pt" viewBox="0 0 {w} {h}">\n')
        defs = "<defs>\n" + "\n".join(self.clips) + "\n</defs>\n" \
            if self.clips else ""
        return (head + defs + "\n".join(self.body) + "\n</svg>\n").encode(
            "utf-8")


def write_svg(path: str, canvas: Canvas) -> int:
    """Write ``canvas`` to ``path``; returns its size in bytes."""
    data = canvas.document()
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def read_svg(path: str):
    """(strings of the ``<text>`` elements in order, count of the painted
    elements, bytes) of an SVG file this module wrote; parsed with
    ``xml.etree``, clip paths not counted."""
    import xml.etree.ElementTree as ET
    ns = "{http://www.w3.org/2000/svg}"
    with open(path, "rb") as f:
        data = f.read()
    root = ET.fromstring(data)
    if root.tag != ns + "svg":
        raise ValueError(f"{path}: the root is {root.tag}, not svg")
    clip_kids = {id(k) for c in root.iter(ns + "clipPath") for k in c}
    strings = [t.text or "" for t in root.iter(ns + "text")]
    painted = sum(1 for e in root.iter()
                  if e.tag in (ns + "path", ns + "rect", ns + "circle")
                  and id(e) not in clip_kids)
    return {"strings": strings, "painted": painted, "bytes": len(data)}

