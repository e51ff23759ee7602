"""SELECT-over-JSON/CSV evaluation for needle contents.

The port's copy of seaweedfs_tpu/query/engine.py.

Reference: weed/query/json/query_json.go (gjson path filtering +
projection) and the CSV input surface of volume_server.proto's
QueryRequest (the reference left its CSV branch empty —
volume_grpc_query.go:38; this build implements it).

A filter is (field, operand, value); operands: = != < <= > >=.
Comparison is numeric when both sides parse as numbers, else string —
the same dual behavior gjson's queryMatches gives the reference.
Fields address nested JSON with dotted paths ("a.b.c"); projections
select fields into the emitted records.
"""

from __future__ import annotations

import csv
import io
import json


def _lookup(doc, dotted: str):
    """Resolve a dotted path inside parsed JSON; None when absent."""
    node = doc
    for part in dotted.split("."):
        if isinstance(node, list):
            try:
                node = node[int(part)]
                continue
            except (ValueError, IndexError):
                return None
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _compare(value, op: str, target: str) -> bool:
    if value is None:
        return False
    if not op:
        return True  # existence check
    # numeric when both sides are numbers, else lexicographic
    try:
        left = float(value) if not isinstance(value, bool) else None
        right = float(target)
    except (TypeError, ValueError):
        left = right = None
    if left is None or right is None:
        left, right = str(value), target
        if isinstance(value, bool):
            left = "true" if value else "false"
    if op == "=":
        return left == right
    if op == "!=":
        return left != right
    if op == "<":
        return left < right
    if op == "<=":
        return left <= right
    if op == ">":
        return left > right
    if op == ">=":
        return left >= right
    return False


def query_json_lines(data: bytes, selections: list[str],
                     field: str = "", op: str = "", value: str = "",
                     document: bool = False) -> bytes:
    """Evaluate the filter over JSON lines (or one document); emit
    newline-delimited JSON records of the selected fields (all fields
    when no selection)."""
    text = data.decode("utf-8", errors="replace")
    lines = [text] if document else text.splitlines()
    out = io.StringIO()
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if field and not _compare(_lookup(doc, field), op, value):
            continue
        if selections:
            record = {s: _lookup(doc, s) for s in selections}
        else:
            record = doc
        out.write(json.dumps(record, separators=(",", ":")))
        out.write("\n")
    return out.getvalue().encode()


def query_csv_lines(data: bytes, selections: list[str],
                    field: str = "", op: str = "", value: str = "",
                    header: str = "USE", delimiter: str = ",",
                    comment: str = "#") -> bytes:
    """Evaluate the filter over CSV rows.

    header=USE names columns from the first row (fields address columns
    by name); NONE/IGNORE address them positionally as _1, _2, ...
    Output rows contain the selected columns, CSV-encoded.
    """
    text = data.decode("utf-8", errors="replace")
    reader = csv.reader(io.StringIO(text), delimiter=delimiter or ",")
    rows = [r for r in reader
            if r and not (comment and r[0].startswith(comment))]
    if not rows:
        return b""
    if (header or "USE").upper() == "USE":
        columns = rows[0]
        rows = rows[1:]
    else:
        columns = [f"_{i + 1}" for i in range(len(rows[0]))]
        if (header or "").upper() == "IGNORE":
            rows = rows[1:]
    index = {c: i for i, c in enumerate(columns)}
    out = io.StringIO()
    writer = csv.writer(out, delimiter=delimiter or ",",
                        lineterminator="\n")
    # unknown selected columns emit empty cells so output stays aligned
    # with the requested selections (json emits null for the same case)
    sel_idx = [index.get(s) for s in selections]
    for row in rows:
        if field:
            i = index.get(field)
            cell = row[i] if i is not None and i < len(row) else None
            if not _compare(cell, op, value):
                continue
        if selections:
            writer.writerow([
                row[i] if i is not None and i < len(row) else ""
                for i in sel_idx])
        else:
            writer.writerow(row)
    return out.getvalue().encode()
