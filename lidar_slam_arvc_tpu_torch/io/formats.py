"""CSV tables and a YAML subset, in numpy and the standard library.

The JAX package reads and writes these files with pandas and PyYAML; the
port runs where neither is installed, so it carries its own:

* ``write_csv`` produces the bytes of pandas ``DataFrame.to_csv`` for
  int64 and float64 columns: an optional unnamed RangeIndex column, float
  values as numpy's shortest round-trip ``str`` (what pandas emits with no
  ``float_format``), minimal quoting, ``\\n`` line ends.
* ``read_csv`` returns ``{column: ndarray}``: int64 where every cell is an
  integer, float64 where every cell is a number, str otherwise.
* ``load_yaml`` reads block mappings, nested by indentation, whose leaves
  are scalars (numbers, strings, ``null``, booleans) or block lists of
  scalars: the dataset's flat parameter files and the reference's nested
  ``icp_parameters.yaml``; ``dump_yaml`` writes the flat ones.  Both follow
  PyYAML's ``safe_load``/``safe_dump`` resolution and formatting for those
  values.
"""

from __future__ import annotations

import csv
import math
import os
import re

import numpy as np


# ------------------------------------------------------------------- CSV

def _column_strings(values) -> list[str]:
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        return list(arr.astype(np.float64).astype(str))
    if arr.dtype.kind in "iub":
        return [str(int(v)) for v in arr]
    return [str(v) for v in arr]


def write_csv(path: str, columns: dict, index: bool = True) -> None:
    """Write equal-length columns as pandas ``DataFrame(columns).to_csv``."""
    names = list(columns)
    cols = [_column_strings(columns[k]) for k in names]
    n = len(cols[0]) if cols else 0
    if any(len(c) != n for c in cols):
        raise ValueError("write_csv: columns differ in length")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index else []) + names)
        for i in range(n):
            w.writerow(([str(i)] if index else []) + [c[i] for c in cols])


def _parse_column(cells: list[str]) -> np.ndarray:
    try:
        return np.array([int(c) for c in cells], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(c) for c in cells], dtype=np.float64)
    except ValueError:
        return np.array(cells, dtype=str)


def read_csv(path: str) -> dict:
    """``{column name: ndarray}`` from a CSV file with a header row.

    An unnamed first column (the index ``to_csv`` writes) is returned as
    ``"Unnamed: 0"``, as pandas names it.
    """
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path}: empty CSV file")
    header = [h if h else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    body = rows[1:]
    return {name: _parse_column([r[j] for r in body])
            for j, name in enumerate(header)}


# ------------------------------------------------------------- YAML subset

# PyYAML's implicit resolvers (YAML 1.1) for the scalars the subset takes
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def _scalar(text: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return -math.inf if s[0] == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    return s


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start of the line or after
    whitespace, outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _yaml_lines(text: str) -> list[tuple[int, str, str]]:
    """(indent, content, raw line) of each line that holds something."""
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"YAML subset: tab in indentation: {raw!r}")
        out.append((len(line) - len(line.lstrip()), line.strip(), raw))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _yaml_list(lines, i: int, indent: int):
    """The block list of scalars whose items start at ``indent``."""
    items = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        items.append(_scalar(lines[i][1][1:]))
        i += 1
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"YAML subset: only lists of scalars: {lines[i][2]!r}")
    return items, i


def _yaml_mapping(lines, i: int, indent: int):
    """The block mapping whose keys start at ``indent``; returns it and the
    index of the first line after it."""
    out: dict = {}
    while i < len(lines):
        ind, content, raw = lines[i]
        if ind < indent:
            break
        if ind > indent or _is_item(content):
            raise ValueError(f"YAML subset: unexpected line: {raw!r}")
        k, sep, v = content.partition(":")
        if not sep:
            raise ValueError(f"YAML subset: expected 'key: value': {raw!r}")
        i += 1
        if v.strip():
            out[k.strip()] = _scalar(v)
            continue
        # a bare key opens a block list (at its own indent or deeper), a
        # nested mapping (deeper), or is null if neither follows
        value = None
        if i < len(lines) and _is_item(lines[i][1]) and lines[i][0] >= indent:
            value, i = _yaml_list(lines, i, lines[i][0])
        elif i < len(lines) and lines[i][0] > indent:
            value, i = _yaml_mapping(lines, i, lines[i][0])
        out[k.strip()] = value
    return out, i


def load_yaml(text: str) -> dict:
    """Parse a block mapping, nested by indentation, whose leaves are
    scalars or block lists of scalars."""
    lines = _yaml_lines(text)
    if lines and _is_item(lines[0][1]):
        raise ValueError(f"YAML subset: list item outside a list: {lines[0][2]!r}")
    out, i = _yaml_mapping(lines, 0, lines[0][0] if lines else 0)
    if i < len(lines):
        raise ValueError(f"YAML subset: unexpected line: {lines[i][2]!r}")
    return out


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(float(v)).lower()
        if "." not in s and "e" in s:
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        if v and _scalar(v) == v and re.match(r"^[A-Za-z_/][\w./-]*$", v):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"YAML subset: cannot represent {type(v).__name__}")


def dump_yaml(mapping: dict) -> str:
    """``yaml.safe_dump`` output (sorted keys) for a flat mapping."""
    lines = []
    for k in sorted(mapping):
        v = mapping[k]
        if isinstance(v, (list, tuple)):
            lines.append(f"{k}:")
            lines.extend(f"- {_dump_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_dump_scalar(v)}")
    return "\n".join(lines) + "\n"
