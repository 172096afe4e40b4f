"""A PNG writer for the port's figures: a scanline rasterizer and the
glyph outlines of DejaVu Sans.

:class:`Canvas` has the drawing interface of ``utils/pdf.Canvas`` (paths,
rectangles, circles, hatching, text, clipping; points, the origin at the
bottom left), so ``utils/figure.render`` draws the same layout on it. The
page is ``width/72 x dpi`` by ``height/72 x dpi`` pixels, RGBA 8-bit.

Every paint is a set of polygons filled by the nonzero rule with
anti-aliased coverage (:func:`coverage`): each pixel row is cut by
``SUBROWS`` sub-scanlines, each sub-scanline's crossings with the polygon
edges are sorted and their winding numbers summed, and the spans where
the winding is nonzero add their exact horizontal overlap with each
pixel, so a pixel's coverage is its covered area to within one
sub-scanline. Everything is numpy on arrays of edges. A stroke is widened
to polygons: a rectangle per segment and a disc at every vertex (the
PDF's round caps and joins), all wound the same way so that their
overlaps stay filled; a dashed stroke (``figure._DASHES`` scaled by the
width, phase 0, as the PDF's ``d`` operator) is cut into its dashes
first, each with round caps. A clip rectangle multiplies the coverage by
its own fractional coverage. Paints are composited source-over in f32.

Text is drawn from the glyph outlines of DejaVu Sans, matplotlib's
default font, bundled as ``fonts/DejaVuSans.ttf`` (a byte copy of
matplotlib's, with its ``LICENSE_DEJAVU``): the TrueType tables ``head``,
``hhea``, ``maxp``, ``cmap`` (format 4), ``hmtx``, ``loca`` and ``glyf``
(simple and composite glyphs) are read here, each quadratic contour
flattened and filled by the nonzero rule, unhinted. A string advances by
DejaVu's widths and the ``kern`` table's pairs (as matplotlib does) from
the anchor the layout gives (``pdf.Canvas.text``'s rule with DejaVu's
advance in place of Helvetica's), its origin moved to the nearest whole
pixel, where Agg puts a text image.

:func:`write_png` writes IHDR, pHYs (the dpi), one IDAT (zlib) and IEND,
each chunk with its CRC, from the standard library.
"""
import functools
import math
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from curvature_tpu_torch.utils.pdf import _ASCENT, _DESCENT

#: sub-scanlines per pixel row: vertical anti-aliasing levels
SUBROWS = 5
FONT_PATH = Path(__file__).resolve().parent / "fonts" / "DejaVuSans.ttf"
#: line segments per quadratic Bezier of a glyph contour
_CURVE_STEPS = 6


# -- the rasterizer ---------------------------------------------------------

def _edges(polys: Sequence[np.ndarray]) -> np.ndarray:
    """[n, 4] (x0, y0, x1, y1) edges of closed polygons, horizontal ones
    dropped."""
    parts = []
    for p in polys:
        p = np.asarray(p, np.float64)
        if len(p) < 2:
            continue
        parts.append(np.concatenate([p, np.roll(p, -1, axis=0)], axis=1))
    if not parts:
        return np.zeros((0, 4))
    e = np.concatenate(parts)
    e = e[np.isfinite(e).all(axis=1)]
    return e[e[:, 1] != e[:, 3]]


def _spans(polys: Sequence[np.ndarray], box: Tuple[int, int, int, int]):
    """The nonzero spans of ``polys`` (pixel coordinates, y down) on every
    sub-scanline inside ``box`` = (x0, y0, x1, y1), integer pixel bounds:
    (pixel row of each span, its start x, its end x, the bounds clipped
    to the polygons), or None where nothing falls inside."""
    e = _edges(polys)
    if not len(e):
        return None
    bx0, by0, bx1, by1 = box
    x0 = max(bx0, int(math.floor(min(e[:, 0].min(), e[:, 2].min()))))
    x1 = min(bx1, int(math.ceil(max(e[:, 0].max(), e[:, 2].max()))))
    y0 = max(by0, int(math.floor(min(e[:, 1].min(), e[:, 3].min()))))
    y1 = min(by1, int(math.ceil(max(e[:, 1].max(), e[:, 3].max()))))
    if x1 <= x0 or y1 <= y0:
        return None
    up = e[:, 3] > e[:, 1]
    ya = np.where(up, e[:, 1], e[:, 3])
    yb = np.where(up, e[:, 3], e[:, 1])
    xa = np.where(up, e[:, 0], e[:, 2])
    xb = np.where(up, e[:, 2], e[:, 0])
    wind = np.where(up, 1, -1)
    # sub-scanline j sits at y = (j + 0.5) / SUBROWS; an edge crosses the
    # ones with ya <= y < yb, clipped to the box's rows
    jlo = np.maximum(np.ceil(ya * SUBROWS - 0.5), y0 * SUBROWS).astype(
        np.int64)
    jhi = np.minimum(np.ceil(yb * SUBROWS - 0.5), y1 * SUBROWS).astype(
        np.int64)
    counts = np.maximum(jhi - jlo, 0)
    total = int(counts.sum())
    if total == 0:
        return None
    idx = np.repeat(np.arange(len(e)), counts)
    starts = np.cumsum(counts) - counts
    j = jlo[idx] + (np.arange(total) - starts[idx])
    ys = (j + 0.5) / SUBROWS
    slope = (xb - xa) / (yb - ya)
    xs = xa[idx] + (ys - ya[idx]) * slope[idx]
    d = wind[idx]
    # one sort key, the sub-scanline then x: x clipped to just outside the
    # box keeps each row's order (a span is clipped to the box anyway)
    xs = np.clip(xs, x0 - 1.0, x1 + 1.0)
    order = np.argsort(j * float(x1 - x0 + 4) + (xs - (x0 - 2.0)))
    j, xs, d = j[order], xs[order], d[order]
    # the winding number after each crossing, summed per sub-scanline
    after = np.cumsum(d)
    first = np.ones(total, bool)
    first[1:] = j[1:] != j[:-1]
    base = np.maximum.accumulate(np.where(first, np.arange(total), 0))
    after = after - (after[base] - d[base])
    before = after - d
    opens = (before == 0) & (after != 0)
    a = np.clip(xs[opens], x0, x1)
    b = np.clip(xs[(before != 0) & (after == 0)], x0, x1)
    return j[opens] // SUBROWS, a, b, (x0, y0, x1, y1)


def coverage(polys: Sequence[np.ndarray], box: Tuple[int, int, int, int],
             spans=None) -> Tuple[Optional[np.ndarray], Tuple[int, int]]:
    """Anti-aliased nonzero coverage of ``polys`` (pixel coordinates, y
    down) inside ``box`` = (x0, y0, x1, y1), integer pixel bounds. Returns
    ([h, w] coverage in [0, 1], (x, y) of its top-left pixel), or (None,
    ...) where nothing falls inside. ``spans``: :func:`_spans`' result,
    where it is at hand."""
    sp = _spans(polys, box) if spans is None else spans
    if sp is None:
        return None, (0, 0)
    rows, a, b, (x0, y0, x1, y1) = sp
    w, h = x1 - x0, y1 - y0
    a, b, rows = a - x0, b - x0, rows - y0
    # coverage of [a, b) in column i: h_a(i) - h_b(i), with h_t a step
    # from floor(t) (its first value 1 - frac(t)): two entries each in a
    # difference array, summed along the row
    cols, weights = [], []
    for t, sign in ((a, 1.0), (b, -1.0)):
        col = np.floor(t).astype(np.int64)
        frac = t - col
        at = rows * (w + 2) + col
        cols += [at, at + 1]
        weights += [sign * (1.0 - frac), sign * frac]
    acc = np.bincount(np.concatenate(cols), np.concatenate(weights),
                      h * (w + 2)).astype(np.float32)
    cov = np.cumsum(acc.reshape(h, w + 2), axis=1)[:, :w] \
        * np.float32(1.0 / SUBROWS)
    return np.clip(cov, 0.0, 1.0), (x0, y0)


def sparse_coverage(sp, most: float = 0.25):
    """:func:`coverage` from :func:`_spans`' result ``sp`` as (rows,
    columns, values) of the pixels the spans touch, where they touch at
    most ``most`` of the bounding box's pixels (outlines, glyphs); None
    for a paint that fills more (take the dense :func:`coverage`)."""
    rows, a, b, (x0, y0, x1, y1) = sp
    fa = np.floor(a).astype(np.int64)
    fb = np.minimum(np.floor(b).astype(np.int64), x1 - 1)
    counts = np.maximum(fb - fa + 1, 0)
    total = int(counts.sum())
    if total > most * SUBROWS * (x1 - x0) * (y1 - y0):
        return None
    idx = np.repeat(np.arange(len(a)), counts)
    col = fa[idx] + (np.arange(total) - (np.cumsum(counts) - counts)[idx])
    part = np.clip(np.minimum(b[idx], col + 1) - np.maximum(a[idx], col),
                   0.0, 1.0)
    keys, inv = np.unique(rows[idx] * (x1 + 1) + col, return_inverse=True)
    vals = np.bincount(inv, part) / SUBROWS
    return (keys // (x1 + 1), keys % (x1 + 1),
            np.clip(vals, 0.0, 1.0).astype(np.float32))


def _oriented(p: np.ndarray) -> np.ndarray:
    """``p`` wound counter-clockwise in its own coordinates (positive
    signed area)."""
    x, y = p[:, 0], p[:, 1]
    area = np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)
    return p if area >= 0 else p[::-1]


def _disc(cx: float, cy: float, r: float) -> np.ndarray:
    n = int(min(64, max(8, math.ceil(2 * math.pi * r / 1.5))))
    t = np.arange(n) * (2 * math.pi / n)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)


def _dashes(pts: np.ndarray, pattern: Sequence[float]) -> List[np.ndarray]:
    """The 'on' pieces of a polyline under a dash ``pattern`` (on, off,
    ...) of phase 0."""
    pieces, cur = [], [pts[0]]
    k, left, on = 0, pattern[0], True
    for p, q in zip(pts[:-1], pts[1:]):
        seg = float(np.hypot(*(q - p)))
        pos = 0.0
        while seg - pos > left:
            pos += left
            point = p + (q - p) * (pos / seg)
            if on:
                cur.append(point)
                pieces.append(np.array(cur))
            else:
                cur = [point]
            on = not on
            k = (k + 1) % len(pattern)
            left = pattern[k]
        left -= seg - pos
        if on:
            cur.append(q)
    if on and len(cur) > 1:
        pieces.append(np.array(cur))
    return pieces


def stroke_polygons(pts: np.ndarray, r: float, close: bool = False,
                    dash: Optional[Sequence[float]] = None,
                    round_ends: bool = True) -> List[np.ndarray]:
    """A polyline of half-width ``r`` as polygons, all wound alike: a
    rectangle per segment and a disc at every vertex (round caps and
    joins; ``round_ends=False`` leaves the discs out, for lines whose ends
    lie on a clip edge); ``dash`` (in the points' units) cuts it into
    dashes first."""
    pts = np.asarray(pts, np.float64)
    if close:
        pts = np.concatenate([pts, pts[:1]])
    runs = _dashes(pts, dash) if dash else [pts]
    polys = []
    for run in runs:
        d = run[1:] - run[:-1]
        length = np.hypot(d[:, 0], d[:, 1])
        keep = length > 0
        n = np.zeros_like(d)
        n[keep] = np.stack([-d[keep, 1], d[keep, 0]], axis=1) \
            / length[keep, None] * r
        for p, q, m in zip(run[:-1][keep], run[1:][keep], n[keep]):
            polys.append(_oriented(np.array([p + m, q + m, q - m, p - m])))
        if round_ends:
            for v in run:
                polys.append(_oriented(_disc(v[0], v[1], r)))
    return polys


# -- the font ---------------------------------------------------------------

class TrueTypeFont:
    """The glyph outlines, advances and character map of a TrueType
    font (quadratic ``glyf`` outlines)."""

    def __init__(self, path):
        self.data = data = Path(path).read_bytes()
        num = struct.unpack(">H", data[4:6])[0]
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(num):
            tag, _, off, length = struct.unpack(
                ">4sIII", data[12 + 16 * i:28 + 16 * i])
            self.tables[tag.decode("latin-1")] = (off, length)
        head = self.tables["head"][0]
        self.upem = struct.unpack(">H", data[head + 18:head + 20])[0]
        loc_format = struct.unpack(">h", data[head + 50:head + 52])[0]
        self.num_glyphs = struct.unpack(
            ">H", data[self.tables["maxp"][0] + 4:][:2])[0]
        hhea = self.tables["hhea"][0]
        n_metrics = struct.unpack(">H", data[hhea + 34:hhea + 36])[0]
        hmtx = self.tables["hmtx"][0]
        adv = np.frombuffer(data, ">u2", n_metrics * 2, hmtx)[0::2]
        self.advances = np.concatenate([adv, np.full(
            max(0, self.num_glyphs - n_metrics), adv[-1])]).astype(float)
        loca = self.tables["loca"][0]
        if loc_format == 0:
            self.loca = np.frombuffer(data, ">u2", self.num_glyphs + 1,
                                      loca).astype(np.int64) * 2
        else:
            self.loca = np.frombuffer(data, ">u4", self.num_glyphs + 1,
                                      loca).astype(np.int64)
        self.cmap = self._cmap4()
        self.kerning = self._kern()
        self._outlines: Dict[int, List[np.ndarray]] = {}

    def _kern(self) -> Dict[Tuple[int, int], int]:
        """(left glyph, right glyph) -> horizontal adjustment in font
        units, from the ``kern`` table's format-0 subtables (the pairs
        FreeType's ``FT_Get_Kerning`` reads, as matplotlib applies them);
        empty without the table."""
        if "kern" not in self.tables:
            return {}
        data, pos = self.data, self.tables["kern"][0]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        pos += 4
        out = {}
        for _ in range(n):
            length, coverage = struct.unpack(">HH", data[pos + 2:pos + 6])
            if coverage >> 8 == 0 and coverage & 1:
                pairs = struct.unpack(">H", data[pos + 6:pos + 8])[0]
                rec = np.frombuffer(data, ">u2", 3 * pairs, pos + 14)
                rec = rec.reshape(pairs, 3)
                vals = rec[:, 2].astype(np.int16)
                for (a, b), v in zip(rec[:, :2].tolist(), vals.tolist()):
                    out[(a, b)] = v
            pos += length
        return out

    def advances_of(self, text: str) -> List[float]:
        """Each character's advance in font units, the kerning with the
        next one included."""
        gids = [self.glyph_id(ch) for ch in text]
        return [self.advances[g] + (self.kerning.get((g, nxt), 0)
                                    if nxt is not None else 0)
                for g, nxt in zip(gids, gids[1:] + [None])]

    def _cmap4(self) -> Dict[int, int]:
        data, base = self.data, self.tables["cmap"][0]
        n = struct.unpack(">H", data[base + 2:base + 4])[0]
        sub = None
        for i in range(n):
            plat, enc, off = struct.unpack(
                ">HHI", data[base + 4 + 8 * i:base + 12 + 8 * i])
            fmt = struct.unpack(">H", data[base + off:base + off + 2])[0]
            if fmt == 4 and (plat, enc) in ((3, 1), (0, 3), (0, 4)):
                sub = base + off
                break
        if sub is None:
            raise ValueError("the font has no format-4 Unicode cmap")
        seg = struct.unpack(">H", data[sub + 6:sub + 8])[0] // 2
        ends = np.frombuffer(data, ">u2", seg, sub + 14)
        starts = np.frombuffer(data, ">u2", seg, sub + 16 + 2 * seg)
        deltas = np.frombuffer(data, ">i2", seg, sub + 16 + 4 * seg)
        ro_pos = sub + 16 + 6 * seg
        range_offs = np.frombuffer(data, ">u2", seg, ro_pos)
        out = {}
        for i in range(seg):
            for c in range(int(starts[i]), int(ends[i]) + 1):
                if c == 0xFFFF:
                    continue
                if range_offs[i] == 0:
                    g = (c + int(deltas[i])) & 0xFFFF
                else:
                    at = ro_pos + 2 * i + int(range_offs[i]) \
                        + 2 * (c - int(starts[i]))
                    g = struct.unpack(">H", data[at:at + 2])[0]
                    if g:
                        g = (g + int(deltas[i])) & 0xFFFF
                if g:
                    out[c] = g
        return out

    def glyph_id(self, ch: str) -> int:
        return self.cmap.get(ord(ch), 0)

    def _contours(self, gid: int) -> List[List[Tuple[float, float, bool]]]:
        """Glyph ``gid``'s contours as (x, y, on-curve) points, font
        units."""
        data = self.data
        start = self.tables["glyf"][0] + int(self.loca[gid])
        if self.loca[gid + 1] == self.loca[gid]:
            return []
        nc = struct.unpack(">h", data[start:start + 2])[0]
        pos = start + 10
        if nc >= 0:
            ends = struct.unpack(f">{nc}H", data[pos:pos + 2 * nc])
            pos += 2 * nc
            ilen = struct.unpack(">H", data[pos:pos + 2])[0]
            pos += 2 + ilen
            npts = ends[-1] + 1 if nc else 0
            flags = []
            while len(flags) < npts:
                f = data[pos]
                pos += 1
                flags.append(f)
                if f & 8:
                    flags.extend([f] * data[pos])
                    pos += 1
            coords = []
            for short, same in ((2, 16), (4, 32)):
                vals, v = [], 0
                for f in flags[:npts]:
                    if f & short:
                        dv = data[pos]
                        pos += 1
                        v += dv if f & same else -dv
                    elif not f & same:
                        v += struct.unpack(">h", data[pos:pos + 2])[0]
                        pos += 2
                    vals.append(v)
                coords.append(vals)
            out, first = [], 0
            for end in ends:
                out.append([(float(coords[0][k]), float(coords[1][k]),
                             bool(flags[k] & 1))
                            for k in range(first, end + 1)])
                first = end + 1
            return out
        out = []
        while True:
            flags, sub = struct.unpack(">HH", data[pos:pos + 4])
            pos += 4
            if flags & 1:
                a1, a2 = struct.unpack(">hh", data[pos:pos + 4])
                pos += 4
            else:
                a1, a2 = struct.unpack(">bb", data[pos:pos + 2])
                pos += 2
            dx, dy = (a1, a2) if flags & 2 else (0, 0)
            m = (1.0, 0.0, 0.0, 1.0)
            if flags & 8:
                s = struct.unpack(">h", data[pos:pos + 2])[0] / 16384.0
                pos += 2
                m = (s, 0.0, 0.0, s)
            elif flags & 0x40:
                sx, sy = struct.unpack(">hh", data[pos:pos + 4])
                pos += 4
                m = (sx / 16384.0, 0.0, 0.0, sy / 16384.0)
            elif flags & 0x80:
                m = tuple(v / 16384.0 for v in struct.unpack(
                    ">hhhh", data[pos:pos + 8]))
                pos += 8
            for contour in self._contours(sub):
                out.append([(m[0] * x + m[2] * y + dx,
                             m[1] * x + m[3] * y + dy, on)
                            for x, y, on in contour])
            if not flags & 0x20:
                return out

    def outline(self, gid: int) -> List[np.ndarray]:
        """Glyph ``gid`` as flattened closed polygons in font units (y
        up), cached."""
        if gid not in self._outlines:
            self._outlines[gid] = [_flatten(c) for c in self._contours(gid)
                                   if len(c) > 1]
        return self._outlines[gid]


def _flatten(contour) -> np.ndarray:
    """A closed quadratic TrueType contour as a polygon: consecutive
    off-curve points imply the on-curve point between them."""
    pts = [(x, y) for x, y, _ in contour]
    on = [o for _, _, o in contour]
    n = len(pts)
    if not any(on):
        first = ((pts[0][0] + pts[1][0]) / 2, (pts[0][1] + pts[1][1]) / 2)
        seq = [(first, True)] + [(pts[(k + 1) % n], False)
                                 for k in range(n)]
    else:
        s = on.index(True)
        seq = [(pts[(s + k) % n], on[(s + k) % n]) for k in range(n)]
    seq.append(seq[0])
    out = [seq[0][0]]
    t = np.linspace(0.0, 1.0, _CURVE_STEPS + 1)[1:, None]
    k = 1
    while k < len(seq):
        p, is_on = seq[k]
        if is_on:
            out.append(p)
            k += 1
            continue
        nxt, nxt_on = seq[k + 1] if k + 1 < len(seq) else (seq[0][0], True)
        end = nxt if nxt_on else ((p[0] + nxt[0]) / 2, (p[1] + nxt[1]) / 2)
        a, c = np.array(out[-1]), np.array(end)
        b = np.array(p)
        curve = (1 - t) ** 2 * a + 2 * (1 - t) * t * b + t ** 2 * c
        out.extend(map(tuple, curve))
        k += 2 if nxt_on else 1
    return np.array(out[:-1])


@functools.lru_cache(maxsize=None)
def font() -> TrueTypeFont:
    """The bundled DejaVu Sans."""
    return TrueTypeFont(FONT_PATH)


def text_width(text: str, size: float) -> float:
    """The advance of ``text`` in DejaVu Sans at ``size`` points, kerned."""
    f = font()
    return sum(f.advances_of(text)) * size / f.upem


# -- the canvas -------------------------------------------------------------

class Canvas:
    """One page of ``width`` x ``height`` points at ``dpi``. Colours are
    RGBA tuples; ``alpha``, where given, replaces the colour's alpha."""

    def __init__(self, width: float, height: float, dpi: float = 100.0):
        self.width, self.height = float(width), float(height)
        self.dpi = float(dpi)
        self.px_w = int(round(self.width / 72.0 * self.dpi))
        self.px_h = int(round(self.height / 72.0 * self.dpi))
        self.sx = self.px_w / self.width
        self.sy = self.px_h / self.height
        #: RGBA in [0, 1], straight alpha
        self.page = np.zeros((self.px_h, self.px_w, 4), np.float32)
        self.clips: List[Tuple[float, float, float, float]] = [
            (0.0, 0.0, float(self.px_w), float(self.px_h))]

    def _px(self, pts) -> np.ndarray:
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        return np.stack([pts[:, 0] * self.sx,
                         (self.height - pts[:, 1]) * self.sy], axis=1)

    def _composite(self, polys, color, a: float):
        if a <= 0 or not polys:
            return
        cx0, cy0, cx1, cy1 = self.clips[-1]
        box = (int(math.floor(cx0)), int(math.floor(cy0)),
               int(math.ceil(cx1)), int(math.ceil(cy1)))
        spans = _spans(polys, box)
        if spans is None:
            return
        sparse = sparse_coverage(spans)
        if sparse is not None:
            # an outline or a glyph: only the touched pixels
            r, q, k = sparse
            k = k * (self._clip_factor(q, cx0, cx1)
                     * self._clip_factor(r, cy0, cy1) * a).astype(np.float32)
            px = self.page[r, q]
            self._over(px, color, k)
            self.page[r, q] = px
            return
        cov, (x0, y0) = coverage(polys, box, spans)
        h, w = cov.shape
        fx = self._clip_factor(np.arange(x0, x0 + w), cx0, cx1)
        fy = self._clip_factor(np.arange(y0, y0 + h), cy0, cy1)
        k = cov * (fy[:, None] * fx[None, :] * a).astype(np.float32)
        self._over(self.page[y0:y0 + h, x0:x0 + w], color, k)

    @staticmethod
    def _clip_factor(pix: np.ndarray, lo: float, hi: float) -> np.ndarray:
        """The share of each pixel [i, i + 1) inside [lo, hi]: the clip
        rectangle's own fractional coverage, one axis."""
        pix = pix.astype(np.float64)
        return np.clip(np.minimum(pix + 1, hi) - np.maximum(pix, lo), 0, 1)

    def _fill_box(self, px0, py0, px1, py1, color, a: float):
        """Fill an axis-aligned pixel box: its coverage is the product of
        the two axes' fractional coverages (the clip's included)."""
        cx0, cy0, cx1, cy1 = self.clips[-1]
        lo_x, hi_x = max(px0, cx0), min(px1, cx1)
        lo_y, hi_y = max(py0, cy0), min(py1, cy1)
        if a <= 0 or hi_x <= lo_x or hi_y <= lo_y:
            return
        x0, x1 = int(math.floor(lo_x)), int(math.ceil(hi_x))
        y0, y1 = int(math.floor(lo_y)), int(math.ceil(hi_y))
        fx = self._clip_factor(np.arange(x0, x1), lo_x, hi_x)
        fy = self._clip_factor(np.arange(y0, y1), lo_y, hi_y)
        k = (fy[:, None] * fx[None, :] * a).astype(np.float32)
        self._over(self.page[y0:y1, x0:x1], color, k)

    @staticmethod
    def _over(dst: np.ndarray, color, k: np.ndarray):
        """Source-over of ``color`` at coverage x alpha ``k`` onto RGBA
        ``dst`` in place: (rgb, a) += ((c, 1) - (rgb, a)) * k."""
        c = np.array([color[0], color[1], color[2], 1.0], np.float32)
        if k.ndim == dst.ndim - 1 and np.all(k == 1.0):
            dst[...] = c
            return
        dst += (c - dst) * k[..., None]

    def _paint(self, fill_polys, stroke_pts, close, fill, stroke, alpha,
               width, dash=None, round_ends=True):
        if fill is not None:
            a = alpha if alpha is not None else fill[3]
            if isinstance(fill_polys, tuple):       # an axis-aligned box
                self._fill_box(*fill_polys, fill, a)
            else:
                self._composite(fill_polys, fill, a)
        if stroke is not None:
            s = (self.sx + self.sy) / 2
            polys = []
            for pts in stroke_pts:
                polys += stroke_polygons(
                    self._px(pts), width * s / 2, close,
                    None if not dash else [v * s for v in dash], round_ends)
            self._composite(polys, stroke,
                            alpha if alpha is not None else stroke[3])

    def path(self, points: Sequence[Sequence[float]], close=False,
             fill=None, stroke=None, alpha=None, width=1.0, dash=None):
        pts = np.asarray(points, np.float64).reshape(-1, 2)
        if len(pts) < 2:
            return
        self._paint([self._px(pts)], [pts], close, fill, stroke, alpha,
                    width, dash)

    def rect(self, x, y, w, h, fill=None, stroke=None, alpha=None,
             width=1.0):
        pts = np.array([(x, y), (x + w, y), (x + w, y + h), (x, y + h)],
                       np.float64)
        px = self._px(pts)
        box = (px[:, 0].min(), px[:, 1].min(), px[:, 0].max(),
               px[:, 1].max())
        self._paint(box, [pts], True, fill, stroke, alpha, width)

    def circle(self, x, y, r, fill=None, stroke=None, alpha=None,
               width=1.0):
        n = int(min(128, max(16, math.ceil(2 * math.pi * r * self.sx / 2))))
        t = np.arange(n) * (2 * math.pi / n)
        pts = np.stack([x + r * np.cos(t), y + r * np.sin(t)], axis=1)
        self._paint([self._px(pts)], [pts], True, fill, stroke, alpha,
                    width)

    def hatch(self, x, y, w, h, color, spacing=6.0, width=1.0):
        """Diagonal lines ('/') every ``spacing`` points, clipped to the
        rectangle; their ends lie on its edges, where the PDF's round caps
        are clipped away but for slivers under a pixel: drawn without."""
        if w <= 0 or h <= 0:
            return
        self.push_clip(x, y, w, h)
        lines, k = [], -h
        while k < w:
            lines.append(np.array([(x + k, y), (x + k + h, y + h)]))
            k += spacing
        self._paint([], lines, False, None, color, None, width,
                    round_ends=False)
        self.pop_clip()

    def push_clip(self, x, y, w, h):
        (px0, py1), (px1, py0) = self._px([(x, y), (x + w, y + h)])
        cx0, cy0, cx1, cy1 = self.clips[-1]
        self.clips.append((max(cx0, min(px0, px1)), max(cy0, min(py0, py1)),
                           min(cx1, max(px0, px1)), min(cy1, max(py0, py1))))

    def pop_clip(self):
        if len(self.clips) == 1:
            raise ValueError("pop_clip without push_clip")
        self.clips.pop()

    def text(self, x, y, text: str, size: float, color, halign="left",
             valign="baseline", rotation=0.0):
        """``text`` in DejaVu Sans at ``size`` points, its anchor
        (``halign`` along DejaVu's advance, ``valign`` across it by the
        layout's ascent and descent) at (x, y), turned by ``rotation``
        degrees counter-clockwise."""
        if not text:
            return
        f = font()
        scale = size / f.upem
        w = text_width(text, size)
        dx = -w * {"left": 0.0, "center": 0.5, "right": 1.0}[halign]
        dy = size / 1000.0 * {"baseline": 0.0, "bottom": _DESCENT,
                              "top": -_ASCENT,
                              "center": -(_ASCENT - _DESCENT) / 2}[valign]
        t = math.radians(rotation)
        cs, sn = math.cos(t), math.sin(t)
        # the string's origin on a whole pixel, as Agg places a text image
        origin = self._px([(x + cs * dx - sn * dy, y + sn * dx + cs * dy)])
        shift = np.round(origin) - origin
        polys, pen = [], 0.0
        for ch, adv in zip(text, f.advances_of(text)):
            for contour in f.outline(f.glyph_id(ch)):
                u = (contour[:, 0] + pen) * scale + dx
                v = contour[:, 1] * scale + dy
                polys.append(self._px(np.stack(
                    [x + cs * u - sn * v, y + sn * u + cs * v], axis=1))
                    + shift)
            pen += adv
        self._composite(polys, color, color[3])

    def pixels(self) -> np.ndarray:
        """The page as uint8 RGBA [height px, width px, 4]."""
        out = np.clip(self.page, 0.0, 1.0) * 255.0
        out += 0.5
        return out.astype(np.uint8)


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path: str, canvas: Canvas) -> int:
    """Write ``canvas`` to ``path`` as an RGBA 8-bit PNG; returns its size
    in bytes."""
    rgba = canvas.pixels()
    h, w = rgba.shape[:2]
    raw = np.zeros((h, 1 + 4 * w), np.uint8)      # filter byte 0: none
    raw[:, 1:] = rgba.reshape(h, -1)
    ppm = int(round(canvas.dpi / 0.0254))
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"pHYs", struct.pack(">IIB", ppm, ppm, 1))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
