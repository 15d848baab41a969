"""Select over JSON lines: keep only the fields a query reads.

The port of minio_tpu/s3select/fastjson.py in its stdlib form (the JAX
module's native scanner, native/njson.cc, has no port): when a query
provably touches only top-level fields (`referenced_fields`), each
record is parsed with `json.loads` and keeps just those fields, as the
JAX scanner's records do; a query that is not eligible (SELECT *, a
whole-record reference, an alias used as a value) reads whole records.
"""

from __future__ import annotations

import json


def referenced_fields(query) -> list[str] | None:
    """Top-level record fields a parsed Query touches, or None when
    the query isn't provably top-level (fast path ineligible)."""
    from . import sql

    fields: set[str] = set()

    def walk(node) -> bool:
        if node is None or isinstance(node, sql.Literal):
            return True
        if isinstance(node, sql.Column):
            name = node.name
            if name.lower() == "s3object" or name in query.aliases:
                return False                 # whole-record reference
            fields.add(name)
            fields.add(name.lower())
            return True
        if isinstance(node, sql.Path):
            if (node.head in query.aliases
                    or node.head.lower() == "s3object"):
                if not node.steps or node.steps[0][0] != "key":
                    return False
                fields.add(node.steps[0][1])
                fields.add(str(node.steps[0][1]).lower())
            else:
                fields.add(node.head)
                fields.add(node.head.lower())
            return True
        if isinstance(node, sql.Func):
            return all(walk(a) for a in node.args)
        if isinstance(node, sql.Agg):
            return node.arg is None or walk(node.arg)
        # generic operator nodes: walk every child Node attribute
        kids = [v for v in vars(node).values()]
        flat = []
        for v in kids:
            if isinstance(v, sql.Node):
                flat.append(v)
            elif isinstance(v, (list, tuple)):
                flat.extend(x for x in v if isinstance(x, sql.Node))
        if not flat and not isinstance(node, sql.Node):
            return False
        return all(walk(k) for k in flat)

    if query.star:
        return None
    for _, node in query.projections:
        if not walk(node):
            return None
    if query.where is not None and not walk(query.where):
        return None
    return sorted(fields)


def read_json_lines_fields(data: bytes, fields: list[str]) -> list[dict]:
    """NDJSON -> a dict per object line holding only those of `fields`
    it has (a line that is not an object is skipped)."""
    keep = set(fields)
    out = []
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if isinstance(obj, dict):
            out.append({k: v for k, v in obj.items() if k in keep})
    return out
