"""The tests' own check of a PDF the port wrote, apart from the port's
``utils/pdf.read_pdf``: the header, every xref offset points at its
object, every stream's /Length ends at endstream, startxref points at
xref. ``parse_pdf`` returns the strings its content streams show.
"""
import re
import zlib


def parse_pdf(path):
    """Check the file's bytes here, apart from ``read_pdf``: every xref
    offset points at its object, every stream's /Length ends at
    endstream, startxref points at xref. Returns the shown strings."""
    with open(path, "rb") as f:
        data = f.read()
    assert data.startswith(b"%PDF-1.4\n") and data.endswith(b"%%EOF\n")
    at = data.rindex(b"startxref")
    xref = int(data[at + len(b"startxref"):].split()[0])
    assert data[xref:xref + 5] == b"xref\n"
    rows = data[xref:].split(b"\n")
    first, count = map(int, rows[1].split())
    assert first == 0 and rows[2] == b"0000000000 65535 f "
    for i in range(1, count):
        off = int(rows[2 + i][:10])
        assert rows[2 + i].endswith(b" 00000 n "), rows[2 + i]
        assert data[off:].startswith(b"%d 0 obj\n" % i), i
    shown = []
    for m in re.finditer(rb"<< /Length (\d+) /Filter /FlateDecode >>\n"
                         rb"stream\n", data):
        n, start = int(m.group(1)), m.end()
        assert data[start + n:start + n + 10] == b"\nendstream", path
        content = zlib.decompress(data[start:start + n])
        shown += [s.replace(rb"\(", b"(").replace(rb"\)", b")")
                  .replace(rb"\\", b"\\").decode("cp1252")
                  for s in re.findall(rb"\(((?:[^()\\]|\\.)*)\) Tj", content)]
    return shown
