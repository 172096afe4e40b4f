"""Plain-text tables, as ``tabulate.tabulate(rows, headers)`` prints them.

The JAX package prints its tables (the damping table, the factor summary,
the FGSM sweep) with ``tabulate``'s default ``simple`` format; the card's
machine has no ``tabulate``, so :func:`tabulate` here reproduces that
format for cells of the kinds these tables hold: strings, Python and
numpy ints and floats, and ``None``. Its rules, as ``tabulate`` 0.10
applies them: an empty string (or ``None``) does not take part in a
column's type; a column is int if every other cell parses as an int,
float if every cell parses as a number (numeric strings included), else
str; float cells print as ``format(float(v), "g")``, int cells as
``format(v, "")``; numeric columns and their headers align right on the
decimal point, other columns left; a column is as wide as its widest
cell and at least its header plus 2; columns are joined by two spaces,
each line right-stripped, the header over a line of dashes.
"""
import math
import re
from typing import List, Sequence, Union

#: tabulate's thousands-separated numbers ("1,234", "1,234.5")
_THOUSANDS = re.compile(
    r"^(([+-]?[0-9]{1,3})(?:,([0-9]{3}))*)?(?(1)\.[0-9]*|\.[0-9]+)?$")


def _convertible(conv, v) -> bool:
    try:
        conv(v)
        return True
    except (ValueError, TypeError):
        return False


def _is_thousands(v) -> bool:
    return isinstance(v, str) and bool(_THOUSANDS.match(v)) and v != ""


def _is_number(v) -> bool:
    if type(v) in (float, int):
        return True
    if not _convertible(float, v):
        return False
    if not isinstance(v, (str, bytes)):
        return True
    f = float(v)
    return not (math.isinf(f) or math.isnan(f)) \
        or v.lower() in ("inf", "-inf", "nan")


def _is_int(v) -> bool:
    return (type(v) is int
            or ((hasattr(v, "is_integer") or hasattr(v, "__array__"))
                and str(type(v)).startswith("<class 'numpy.int"))
            or (isinstance(v, str) and _convertible(int, v)))


#: tabulate's order of generality: None < bool < int < float < str
_RANK = {type(None): 0, bool: 1, int: 2, float: 3, str: 5}


def _kind(v):
    if v is None or (isinstance(v, str) and not v):
        return type(None)
    if type(v) is bool or (isinstance(v, str) and v in ("True", "False")):
        return bool
    if _is_int(v) or (_is_thousands(v) and "." not in v):
        return int
    if _is_number(v) or _is_thousands(v):
        return float
    return str


def _column_kind(cells):
    rank = max([_RANK[bool]] + [_RANK[_kind(v)] for v in cells])
    return {r: k for k, r in _RANK.items()}[rank]


def _format(v, kind) -> str:
    if v is None or (isinstance(v, str) and not v):
        return ""
    if kind is int:
        return format(v, "")
    if kind is float:
        if isinstance(v, str) and "," in v:
            v = v.replace(",", "")
        return format(float(v), "g")
    return f"{v}"


def _after_point(s: str) -> int:
    """Characters after the decimal point (or the exponent's "e"), -1
    for an int or a string that is no number."""
    if not (_is_number(s) or _is_thousands(s)) or _is_int(s):
        return -1
    pos = s.rfind(".")
    pos = s.lower().rfind("e") if pos < 0 else pos
    return len(s) - pos - 1 if pos >= 0 else -1


def tabulate(rows: Union[Sequence[Sequence], dict],
             headers: Union[Sequence[str], str]) -> str:
    """``rows`` (a list of rows, or a dict of columns with ``headers=
    "keys"``) under ``headers`` in tabulate's ``simple`` format."""
    if isinstance(rows, dict):
        if headers == "keys":
            headers = [str(k) for k in rows]
        width = max((len(c) for c in rows.values()), default=0)
        rows = [[c[i] if i < len(c) else None for c in rows.values()]
                for i in range(width)]
    headers = list(headers)
    cols = [list(c) for c in zip(*rows)] if rows else \
        [[] for _ in headers]
    lines_cols: List[List[str]] = []
    numeric, widths = [], []
    for header, cells in zip(headers, cols):
        kind = _column_kind(cells)
        text = [_format(v, kind) for v in cells]
        is_num = kind in (int, float)
        if is_num:
            points = [_after_point(s) for s in text]
            most = max(points, default=-1)
            text = [s + (most - p) * " " for s, p in zip(text, points)]
        else:
            text = [s.strip() for s in text]
        width = max([len(s) for s in text] + [len(header) + 2])
        lines_cols.append([s.rjust(width) if is_num else s.ljust(width)
                           for s in text])
        numeric.append(is_num)
        widths.append(width)
    head = [h.rjust(w) if num else h.ljust(w)
            for h, w, num in zip(headers, widths, numeric)]
    lines = ["  ".join(head).rstrip(),
             "  ".join("-" * w for w in widths).rstrip()]
    lines += ["  ".join(r).rstrip() for r in zip(*lines_cols)]
    return "\n".join(lines)
