"""A PDF 1.4 writer for the port's figures, and a structural reader.

:class:`Canvas` collects one page's drawing (paths, rectangles, circles,
hatching, text, clipping) as PDF content-stream operators in points, the
origin at the bottom left. :func:`write_pdf` writes canvases as pages of
one file: each content stream compressed with ``/FlateDecode``, the font
the base-14 ``/Helvetica`` in ``/WinAnsiEncoding`` (no embedded font),
alpha through ``/ExtGState`` entries (``/ca`` fill, ``/CA`` stroke), and
an exact ``xref`` table, trailer and ``startxref``.

:func:`read_pdf` checks a file's structure (the header, every ``xref``
offset, every stream's ``/Length``, ``startxref``) and returns its page
count, the strings that ``Tj`` shows and a count of each path operator.
"""
import collections
import math
import re
import zlib
from typing import Dict, List, Optional, Sequence

#: Helvetica's ascent and descent (1/1000 em) as the text anchors use them
_ASCENT, _DESCENT = 718, 207
#: the operators that construct or paint a path
PATH_OPS = ("m", "l", "c", "v", "y", "h", "re", "S", "s", "f", "F", "f*",
            "B", "B*", "b", "b*", "n")
#: the operators that paint one
PAINT_OPS = ("S", "s", "f", "F", "f*", "B", "B*", "b", "b*")
#: WinAnsi stand-ins for the characters the figures' labels may hold
_STAND_INS = {"−": "-", "–": "-", "—": "-", "×": "x"}


def _num(v: float) -> str:
    s = f"{v:.3f}".rstrip("0").rstrip(".")
    return "0" if s in ("-0", "") else s


def _escape(text: str) -> bytes:
    text = "".join(_STAND_INS.get(ch, ch) for ch in text)
    raw = text.encode("cp1252", errors="replace")
    return raw.replace(b"\\", b"\\\\").replace(b"(", b"\\(").replace(
        b")", b"\\)")


class Canvas:
    """One page of ``width`` x ``height`` points. Colours are RGBA tuples;
    ``alpha``, where given, replaces the colour's alpha."""

    def __init__(self, width: float, height: float):
        self.width, self.height = float(width), float(height)
        self.ops: List[bytes] = []
        self.alphas: Dict[str, tuple] = {}

    def _gs(self, fill_a: float, stroke_a: float) -> Optional[bytes]:
        if fill_a >= 1.0 and stroke_a >= 1.0:
            return None
        key = (round(fill_a, 4), round(stroke_a, 4))
        for name, val in self.alphas.items():
            if val == key:
                return f"/{name} gs".encode()
        name = f"GS{len(self.alphas)}"
        self.alphas[name] = key
        return f"/{name} gs".encode()

    def _paint(self, construct: List[str], fill=None, stroke=None,
               alpha=None, width=1.0, dash=None):
        if fill is None and stroke is None:
            return
        fa = (alpha if alpha is not None else fill[3]) if fill else 1.0
        sa = (alpha if alpha is not None else stroke[3]) if stroke else 1.0
        if (fill is None or fa <= 0) and (stroke is None or sa <= 0):
            return
        out = [b"q"]
        gs = self._gs(fa, sa)
        if gs:
            out.append(gs)
        if fill is not None:
            out.append(" ".join(_num(v) for v in fill[:3]).encode()
                       + b" rg")
        if stroke is not None:
            out.append(" ".join(_num(v) for v in stroke[:3]).encode()
                       + b" RG")
            out.append(f"{_num(width)} w 1 J 1 j".encode())
            if dash:
                out.append(("[" + " ".join(_num(d) for d in dash)
                            + "] 0 d").encode())
        out.extend(s.encode() for s in construct)
        op = "B" if fill is not None and stroke is not None else \
            "f" if fill is not None else "S"
        out.append(op.encode())
        out.append(b"Q")
        self.ops.append(b"\n".join(out))

    def path(self, points: Sequence[Sequence[float]], close=False,
             fill=None, stroke=None, alpha=None, width=1.0, dash=None):
        pts = [(float(x), float(y)) for x, y in points]
        if len(pts) < 2:
            return
        cons = [f"{_num(pts[0][0])} {_num(pts[0][1])} m"]
        cons += [f"{_num(x)} {_num(y)} l" for x, y in pts[1:]]
        if close:
            cons.append("h")
        self._paint(cons, fill, stroke, alpha, width, dash)

    def rect(self, x, y, w, h, fill=None, stroke=None, alpha=None,
             width=1.0):
        self._paint([f"{_num(x)} {_num(y)} {_num(w)} {_num(h)} re"], fill,
                    stroke, alpha, width)

    def circle(self, x, y, r, fill=None, stroke=None, alpha=None,
               width=1.0):
        k = 0.5522847498 * r
        cons = [f"{_num(x + r)} {_num(y)} m"]
        for (ax, ay), (bx, by), (cx, cy) in (
                ((r, k), (k, r), (0, r)), ((-k, r), (-r, k), (-r, 0)),
                ((-r, -k), (-k, -r), (0, -r)), ((k, -r), (r, -k), (r, 0))):
            cons.append(f"{_num(x + ax)} {_num(y + ay)} {_num(x + bx)} "
                        f"{_num(y + by)} {_num(x + cx)} {_num(y + cy)} c")
        cons.append("h")
        self._paint(cons, fill, stroke, alpha, width)

    def hatch(self, x, y, w, h, color, spacing=6.0, width=1.0):
        """Diagonal lines ('/') every ``spacing`` points, clipped to the
        rectangle."""
        if w <= 0 or h <= 0:
            return
        self.push_clip(x, y, w, h)
        cons = []
        k = -h
        while k < w:
            cons.append(f"{_num(x + k)} {_num(y)} m {_num(x + k + h)} "
                        f"{_num(y + h)} l")
            k += spacing
        self._paint(cons, None, color, None, width)
        self.pop_clip()

    def push_clip(self, x, y, w, h):
        self.ops.append(f"q {_num(x)} {_num(y)} {_num(w)} {_num(h)} re W n"
                        .encode())

    def pop_clip(self):
        self.ops.append(b"Q")

    def text(self, x, y, text: str, size: float, color, halign="left",
             valign="baseline", rotation=0.0):
        """``text`` in Helvetica at ``size`` points, its anchor (``halign``
        along the text, ``valign`` across it) at (x, y), turned by
        ``rotation`` degrees counter-clockwise."""
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
        out = [b"q"]
        gs = self._gs(color[3], 1.0)
        if gs:
            out.append(gs)
        out.append(" ".join(_num(v) for v in color[:3]).encode() + b" rg")
        out.append(f"BT /F1 {_num(size)} Tf {_num(cs)} {_num(sn)} "
                   f"{_num(-sn)} {_num(cs)} {_num(ox)} {_num(oy)} Tm"
                   .encode())
        out.append(b"(" + _escape(text) + b") Tj ET Q")
        self.ops.append(b"\n".join(out))

    def content(self) -> bytes:
        return b"\n".join(self.ops) + b"\n"


def write_pdf(path: str, pages: Sequence[Canvas]) -> int:
    """Write ``pages`` to ``path`` as one PDF 1.4 file; returns its size
    in bytes."""
    objects: List[bytes] = []          # object i + 1's body
    kids = []
    objects.append(b"<< /Type /Catalog /Pages 2 0 R >>")
    objects.append(b"")                 # the page tree, filled below
    objects.append(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica "
                   b"/Encoding /WinAnsiEncoding >>")
    for page in pages:
        data = zlib.compress(page.content(), 6)
        objects.append(b"<< /Length %d /Filter /FlateDecode >>\nstream\n"
                       % len(data) + data + b"\nendstream")
        content_id = len(objects)
        gstates = " ".join(f"/{n} << /ca {_num(a)} /CA {_num(b)} >>"
                           for n, (a, b) in page.alphas.items())
        objects.append((
            f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
            f"{_num(page.width)} {_num(page.height)}] /Resources << /Font "
            f"<< /F1 3 0 R >> /ExtGState << {gstates} >> >> /Contents "
            f"{content_id} 0 R >>").encode())
        kids.append(len(objects))
    refs = " ".join(f"{k} 0 R" for k in kids)
    objects[1] = (f"<< /Type /Pages /Kids [{refs}] /Count {len(kids)} >>"
                  .encode())
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, xref))
    with open(path, "wb") as f:
        f.write(bytes(out))
    return len(out)


_TOKEN = re.compile(rb"\s*(?:(\()|(\[|\]|<<|>>)|(/[^\s/\[\]()<>]*)|"
                    rb"([+-]?(?:\d+\.?\d*|\.\d+))|"
                    rb"([A-Za-z*'\"][A-Za-z*0-9]*))")


def _string(data: bytes, i: int):
    """The literal string starting after '(' at ``i``: (text, next)."""
    out, depth = bytearray(), 1
    while True:
        ch = data[i:i + 1]
        if not ch:
            raise ValueError("content stream: an unterminated string")
        i += 1
        if ch == b"\\":
            nxt = data[i:i + 1]
            i += 1
            out += {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                    b"f": b"\f"}.get(nxt, nxt)
        elif ch == b"(":
            depth += 1
            out += ch
        elif ch == b")":
            depth -= 1
            if depth == 0:
                return out.decode("cp1252", errors="replace"), i
            out += ch
        else:
            out += ch


def parse_content(data: bytes):
    """(``Tj`` strings, count of each operator) of a content stream."""
    strings, ops = [], collections.Counter()
    i, last = 0, None
    while i < len(data):
        if data[i:i + 1].isspace():
            i += 1
            continue
        m = _TOKEN.match(data, i)
        if not m or m.end() == i:
            raise ValueError(f"content stream: cannot read at byte {i}: "
                             f"{data[i:i + 20]!r}")
        if m.group(1):
            last, i = _string(data, m.end())
            continue
        i = m.end()
        if m.group(5):
            op = m.group(5).decode()
            ops[op] += 1
            if op == "Tj":
                if not isinstance(last, str):
                    raise ValueError("content stream: Tj without a string")
                strings.append(last)
            last = None
    return strings, ops


def read_pdf(path: str) -> Dict:
    """Check ``path``'s structure and read its drawing: the header, the
    ``startxref`` offset, every in-use ``xref`` entry's offset (object
    ``i 0 obj`` there), the trailer's ``/Size``, every stream's
    ``/Length`` (``endstream`` right after it). Returns {"pages",
    "strings" (what ``Tj`` shows, in order), "ops" (a count of each path
    operator), "painted" (paths stroked or filled), "bytes"}; a fault
    raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"%PDF-1."):
        raise ValueError(f"{path}: no PDF header")
    tail = data[-64:]
    m = re.search(rb"startxref\s+(\d+)\s+%%EOF\s*$", tail)
    if not m:
        raise ValueError(f"{path}: no startxref at the end")
    xref = int(m.group(1))
    if not data.startswith(b"xref", xref):
        raise ValueError(f"{path}: startxref {xref} does not point at xref")
    head = re.match(rb"xref\s+0\s+(\d+)\s*\n", data[xref:])
    if not head:
        raise ValueError(f"{path}: malformed xref header")
    n = int(head.group(1))
    pos = xref + head.end()
    offsets = []
    for i in range(n):
        entry = data[pos + 20 * i: pos + 20 * (i + 1)]
        em = re.match(rb"(\d{10}) (\d{5}) ([nf])[ \r\n]{2}", entry)
        if not em:
            raise ValueError(f"{path}: xref entry {i} malformed: {entry!r}")
        if em.group(3) == b"n":
            off = int(em.group(1))
            if not data.startswith(b"%d 0 obj" % i, off):
                raise ValueError(f"{path}: xref offset {off} of object {i} "
                                 "does not point at it")
            offsets.append((i, off))
    trailer = data[pos + 20 * n: len(data) - len(tail) + m.start()]
    sm = re.search(rb"/Size\s+(\d+)", trailer)
    if not sm or int(sm.group(1)) != n:
        raise ValueError(f"{path}: trailer /Size does not match xref ({n})")
    pages, strings, ops = 0, [], collections.Counter()
    for i, off in offsets:
        end = data.find(b"endobj", off)
        body = data[off:end]
        if re.search(rb"/Type\s*/Page(?![s\w])", body):
            pages += 1
        sm = re.search(rb"stream\r?\n", body)
        if sm and b"/Length" in body[:sm.start()]:
            lm = re.search(rb"/Length\s+(\d+)", body[:sm.start()])
            if not lm:
                raise ValueError(f"{path}: object {i}: indirect or missing "
                                 "/Length")
            start = off + sm.end()
            length = int(lm.group(1))
            stream = data[start:start + length]
            if not re.match(rb"\r?\nendstream", data[start + length:
                                                    start + length + 12]):
                raise ValueError(f"{path}: object {i}: /Length {length} "
                                 "does not end at endstream")
            if b"/FlateDecode" in body[:sm.start()]:
                stream = zlib.decompress(stream)
            s, o = parse_content(stream)
            strings += s
            ops += o
    return {"pages": pages, "strings": strings,
            "ops": {k: ops[k] for k in PATH_OPS if ops[k]},
            "painted": sum(ops[k] for k in PAINT_OPS), "bytes": len(data)}
