"""Op-graph YAML in the reference's schema.

Counterpart of the JAX package's ``ir_io.py``.  The reference defines every
model as a YAML list of op maps (``template/op_template.yaml:1-19``): OP_NO,
COMP_TYPE, TYPE, ORDER, INPUT (input_g_list, input_g_num, input_nong_list,
input_nong_num, input_size, feature_number, size_per_feature) and OUTPUT
(output_list, output_number, size_per_feature, feature_number), sizes in
bytes (features x 4).  What the reference never carried and execution
needs (weight shapes, special-function names, constants) rides in an
``EXTRA`` map that reference consumers ignore; a file without it imports
with weight names made from op ids.

The port needs no YAML package: it writes and reads the subset of YAML this
schema uses itself: block lists and maps by indentation, the empty flow
forms ``[]`` and ``{}``, and plain or quoted scalars (ints, floats, bools,
null, strings) as PyYAML's ``safe_dump`` writes them and ``safe_load``
reads them.  Its text loads under PyYAML to the JAX package's structure.
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from . import ir

_KIND_TO_REF = {ir.SCATTER: "scatter", ir.GATHER: "gather",
                ir.APPLY_EDGE: "applyedge", ir.APPLY_NODE: "applynode"}
_REF_TO_KIND = {v: k for k, v in _KIND_TO_REF.items()}
BYTES = 4


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?$")
_NULL = ("", "~", "null", "Null", "NULL")
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
_SPECIAL = {".inf": math.inf, "+.inf": math.inf, "-.inf": -math.inf,
            ".nan": math.nan}


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        t = repr(v).lower()
        if "." not in t and "e" in t:
            t = t.replace("e", ".0e")       # PyYAML's float form
        return t
    s = str(v)
    plain = (s and not s[0].isspace() and not s[-1].isspace()
             and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
             and ": " not in s and " #" not in s and "\n" not in s
             and _parse_scalar(s) == s)
    return s if plain else "'" + s.replace("'", "''") + "'"


def _parse_scalar(t: str) -> Any:
    if t in _NULL:
        return None
    if t in _BOOL:
        return _BOOL[t]
    if t.lower() in _SPECIAL:
        return _SPECIAL[t.lower()]
    if t.startswith("'") and t.endswith("'") and len(t) >= 2:
        return t[1:-1].replace("''", "'")
    if t.startswith('"') and t.endswith('"') and len(t) >= 2:
        return t[1:-1].encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if t == "[]":
        return []
    if t == "{}":
        return {}
    if t.startswith("[") and t.endswith("]"):
        return [_parse_scalar(p.strip()) for p in t[1:-1].split(",")]
    return t


def _dump(v: Any, indent: int, out: List[str]) -> None:
    """Append the block lines of the list or map ``v`` at ``indent``."""
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar_text(k)
            if isinstance(x, dict) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent + 2, out)
            elif isinstance(x, list) and x:
                out.append(f"{pad}{key}:")
                _dump(x, indent, out)      # PyYAML's indentless sequence
            else:
                out.append(f"{pad}{key}: {_flow(x)}")
        return
    for x in v:
        if isinstance(x, dict) and x:
            sub: List[str] = []
            _dump(x, indent + 2, sub)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out.extend(sub[1:])
        elif isinstance(x, list) and x:
            raise ValueError("ir_io: nested lists are not in the schema")
        else:
            out.append(f"{pad}- {_flow(x)}")


def _flow(x: Any) -> str:
    if isinstance(x, (list, tuple)):
        if x:
            raise ValueError("ir_io: a non-empty list in flow position")
        return "[]"
    if isinstance(x, dict):
        return "{}"
    return _scalar_text(x)


def dump_yaml(data: Any) -> str:
    """Block YAML of a list or map of the schema's values, in the form
    PyYAML's ``safe_dump(sort_keys=False)`` writes."""
    out: List[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"


def _lines(text: str) -> List[Tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        s = raw.rstrip()
        body = s.lstrip(" ")
        if not body or body.startswith("#") or body in ("---", "..."):
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("ir_io: tab indentation")
        out.append((len(s) - len(body), body))
    return out


def _split_key(body: str) -> Optional[Tuple[str, str]]:
    """(key, rest) of a ``key: value`` or ``key:`` line, else None."""
    if body.startswith(("'", '"')):
        q = body[0]
        end = body.find(q, 1)
        while q == "'" and end + 1 < len(body) and body[end + 1] == "'":
            end = body.find(q, end + 2)
        if end < 0 or not body[end + 1:].startswith(":"):
            return None
        key, rest = body[: end + 1], body[end + 2:]
    else:
        m = re.match(r"([^:#]+?):(\s|$)", body)
        if m is None:
            return None
        key, rest = m.group(1), body[m.end():]
    return key, rest.strip()


def _parse_block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """The list or map whose lines start at ``lines[i]``, at ``indent``."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        out: List[Any] = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][2:].strip()
            if not rest:
                if i + 1 < len(lines) and lines[i + 1][0] > indent:
                    v, i = _parse_block(lines, i + 1, lines[i + 1][0])
                else:
                    v, i = None, i + 1
                out.append(v)
            elif _split_key(rest) is not None:
                # a map whose first key shares the dash's line
                sub = [(indent + 2, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                v, _ = _parse_block(sub, 0, indent + 2)
                out.append(v)
                i = j
            else:
                out.append(_parse_scalar(rest))
                i += 1
        return out, i
    out_map: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"ir_io: cannot read line {lines[i][1]!r}")
        key, rest = _parse_scalar(kv[0]), kv[1]
        i += 1
        if rest:
            out_map[key] = _parse_scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out_map[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out_map[key] = None
    return out_map, i


def load_yaml(text: str) -> Any:
    """Read the YAML subset :func:`dump_yaml` writes, as PyYAML's
    ``safe_load`` reads it."""
    lines = _lines(text)
    if not lines:
        return None
    v, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"ir_io: cannot read line {lines[i][1]!r}")
    return v


# ---------------------------------------------------------------------------
# the op graph
# ---------------------------------------------------------------------------


def to_yaml(graph: ir.OpGraph, n_node: int = 0, n_edge: int = 0) -> str:
    """The graph in the reference's op-list schema."""
    ops_out: List[Dict[str, Any]] = []
    consumers: Dict[int, List[int]] = {op.op_id: [] for op in graph.ops}
    for u, v in graph.edges():
        consumers[u].append(v)
    for oid in graph.topo_order():
        op = graph.by_id[oid]
        g_list = [i for i in op.inputs if i >= 0]
        nong = [i for i in op.inputs if i < 0]
        rows_in = n_node if op.in_domain == ir.NODE else n_edge
        rows_out = n_node if op.out_domain == ir.NODE else n_edge
        in_w = sum(graph.width_of(i) for i in op.inputs) if op.inputs \
            else graph.in_width
        d = {
            "OP_NO": op.op_id,
            "COMP_TYPE": op.compute,
            "TYPE": _KIND_TO_REF[op.kind],
            "ORDER": op.order,
            "INPUT": {
                "input_g_list": g_list,
                "input_g_num": len(g_list),
                "input_nong_list": nong,
                "input_nong_num": len(nong),
                "input_size": rows_in * in_w * BYTES,
                "feature_number": in_w,
                "size_per_feature": rows_in * BYTES,
            },
            "OUTPUT": {
                "output_list": sorted(consumers[oid]),
                "output_number": len(consumers[oid]),
                "size_per_feature": rows_out * BYTES,
                "feature_number": op.out_width,
            },
        }
        if op.extra:
            extra = dict(op.extra)
            if "weight" in extra:
                extra["weight"] = list(extra["weight"])
            d["EXTRA"] = extra
        ops_out.append(d)
    return dump_yaml(ops_out)


def from_yaml(text: str, name: str = "imported",
              in_width: Optional[int] = None) -> ir.OpGraph:
    """Read the reference's op-list schema into an OpGraph.  Files without
    EXTRA (the reference's own) get weight specs for MM ops (widths from
    the feature counts) and relu for special functions."""
    raw = load_yaml(text)
    ops: List[ir.Op] = []
    for d in raw:
        kind = _REF_TO_KIND[d["TYPE"].strip().lower()]
        compute = d["COMP_TYPE"].strip().upper()
        inp = d.get("INPUT", {})
        outp = d.get("OUTPUT", {})
        inputs = list(inp.get("input_g_list", []) or [])
        inputs += list(inp.get("input_nong_list", []) or [])
        out_w = outp.get("feature_number")
        if out_w is None:
            out_w = max(int(outp.get("size_per_feature", BYTES)) // BYTES, 1)
        extra = dict(d.get("EXTRA", {}) or {})
        if "weight" in extra:
            extra["weight"] = tuple(extra["weight"])
        elif compute == ir.MM:
            iw = int(inp.get("feature_number", out_w))
            extra["weight"] = (f"{name}_w{d['OP_NO']}", iw, int(out_w))
        if compute == ir.SF and "sf" not in extra:
            extra["sf"] = "relu"
        ops.append(ir.Op(
            op_id=int(d["OP_NO"]), kind=kind, compute=compute,
            order=d.get("ORDER", "R"), inputs=inputs,
            out_width=int(out_w), extra=extra))
    if in_width is None:
        first = [o for o in ops if ir.X_INPUT in o.inputs]
        in_width = int(raw[0]["INPUT"].get("feature_number", 1)) if raw else 1
        if first:
            in_width = int(
                raw[[o.op_id for o in ops].index(first[0].op_id)]
                ["INPUT"].get("feature_number", in_width))
    return ir.OpGraph(name=name, ops=ops, in_width=in_width)


def save(graph: ir.OpGraph, path: str, n_node: int = 0, n_edge: int = 0):
    with open(path, "w") as f:
        f.write(to_yaml(graph, n_node, n_edge))


def load(path: str, name: Optional[str] = None,
         in_width: Optional[int] = None) -> ir.OpGraph:
    with open(path) as f:
        return from_yaml(f.read(),
                         name or os.path.splitext(os.path.basename(path))[0],
                         in_width)
