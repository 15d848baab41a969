"""S3 Select I/O: CSV/JSON readers+writers and AWS event-stream framing.

The port of minio_tpu/s3select/engine.py (the internal/s3select role):
input readers turn object bytes into
record dicts (CSV with/without header, JSON lines), output writers
serialize result rows, and the response rides the AWS event-stream
binary framing (prelude + headers + payload + CRCs) with Records /
Stats / End events — the same wire format the reference emits
(internal/s3select/message.go).
"""

from __future__ import annotations

import csv
import io
import json
import struct
import xml.etree.ElementTree as ET
import zlib

from .sql import SQLError, parse, run_query


# -- input readers -----------------------------------------------------------

def read_csv(data: bytes, *, header: bool = True,
             delimiter: str = ",") -> list[dict]:
    text = data.decode("utf-8", "replace")
    rows = list(csv.reader(io.StringIO(text), delimiter=delimiter))
    if not rows:
        return []
    if header:
        names = rows[0]
        return [dict(zip(names, r)) for r in rows[1:] if r]
    return [{f"_{i + 1}": v for i, v in enumerate(r)} for r in rows if r]


def read_json_lines(data: bytes) -> list[dict]:
    out = []
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        obj = json.loads(line)
        if isinstance(obj, dict):
            out.append(obj)
    return out


def read_parquet(data: bytes) -> list[dict]:
    """Parquet input (the internal/s3select/parquet role): decoded by
    pyarrow into the same record-dict rows the CSV/JSON readers produce.
    Without pyarrow a Parquet request fails with an error that names it,
    never with an empty result."""
    try:
        import pyarrow.parquet as pq
    except ImportError:
        raise SQLError("Parquet input needs the 'pyarrow' package, which "
                       "is not installed") from None
    return pq.read_table(io.BytesIO(data)).to_pylist()


# -- output writers ----------------------------------------------------------

def write_csv(rows: list[dict], delimiter: str = ",") -> bytes:
    if not rows:
        return b""
    buf = io.StringIO()
    w = csv.writer(buf, delimiter=delimiter, lineterminator="\n")
    for row in rows:
        w.writerow(["" if v is None else v for v in row.values()])
    return buf.getvalue().encode()


def _json_default(v):
    """Non-JSON-native values from richer inputs (Parquet carries
    datetime/Decimal/bytes columns routinely) serialize instead of
    500ing the Select."""
    import base64
    import datetime
    import decimal
    if isinstance(v, (datetime.datetime, datetime.date, datetime.time)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return float(v)
    if isinstance(v, (bytes, bytearray)):
        return base64.b64encode(bytes(v)).decode()
    return str(v)


def write_json_lines(rows: list[dict]) -> bytes:
    return b"".join(json.dumps(r, default=_json_default).encode() + b"\n"
                    for r in rows)


# -- AWS event-stream framing ------------------------------------------------

def _header(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode()
    return (struct.pack(">B", len(nb)) + nb + b"\x07"
            + struct.pack(">H", len(vb)) + vb)


def event_message(event_type: str, payload: bytes = b"",
                  content_type: str = "") -> bytes:
    headers = _header(":message-type", "event") + \
        _header(":event-type", event_type)
    if content_type:
        headers += _header(":content-type", content_type)
    total = 12 + len(headers) + len(payload) + 4
    prelude = struct.pack(">II", total, len(headers))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + headers + payload
    return body + struct.pack(">I", zlib.crc32(body))


def select_response(result_payload: bytes, bytes_scanned: int,
                    bytes_returned: int) -> bytes:
    """Records + Stats + End event stream."""
    out = b""
    if result_payload:
        out += event_message("Records", result_payload,
                             "application/octet-stream")
    stats = (f"<Stats><BytesScanned>{bytes_scanned}</BytesScanned>"
             f"<BytesProcessed>{bytes_scanned}</BytesProcessed>"
             f"<BytesReturned>{bytes_returned}</BytesReturned>"
             f"</Stats>").encode()
    out += event_message("Stats", stats, "text/xml")
    out += event_message("End")
    return out


def decode_event_stream(data: bytes) -> list[tuple[str, bytes]]:
    """Client-side decoder (tests): -> [(event_type, payload)]."""
    out = []
    pos = 0
    while pos < len(data):
        total, hlen = struct.unpack(">II", data[pos:pos + 8])
        headers = data[pos + 12:pos + 12 + hlen]
        payload = data[pos + 12 + hlen:pos + total - 4]
        etype = ""
        hp = 0
        while hp < len(headers):
            nlen = headers[hp]
            name = headers[hp + 1:hp + 1 + nlen].decode()
            hp += 1 + nlen + 1           # skip type byte (always 7)
            (vlen,) = struct.unpack(">H", headers[hp:hp + 2])
            value = headers[hp + 2:hp + 2 + vlen].decode()
            hp += 2 + vlen
            if name == ":event-type":
                etype = value
        out.append((etype, payload))
        pos += total
    return out


# -- request handling --------------------------------------------------------

def parse_select_request(body: bytes) -> dict:
    """SelectObjectContentRequest XML -> options dict."""
    root = ET.fromstring(body)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    expr = root.findtext("Expression") or ""
    in_ser = root.find("InputSerialization")
    out_ser = root.find("OutputSerialization")
    opts = {"expression": expr, "input": "csv", "header": True,
            "delimiter": ",", "output": "csv", "out_delimiter": ","}
    if in_ser is not None:
        if in_ser.find("JSON") is not None:
            opts["input"] = "json"
        if in_ser.find("Parquet") is not None:
            opts["input"] = "parquet"
        csv_el = in_ser.find("CSV")
        if csv_el is not None:
            opts["header"] = (csv_el.findtext("FileHeaderInfo", "USE")
                              .upper() != "NONE")
            opts["delimiter"] = csv_el.findtext("FieldDelimiter", ",")
    if out_ser is not None and out_ser.find("JSON") is not None:
        opts["output"] = "json"
    elif out_ser is not None:
        csv_el = out_ser.find("CSV")
        if csv_el is not None:
            opts["out_delimiter"] = csv_el.findtext("FieldDelimiter", ",")
    return opts


def execute_select(data: bytes, opts: dict) -> bytes:
    """Run the query; returns the full event-stream response body."""
    query = parse(opts["expression"])
    if opts["input"] == "parquet":
        records = read_parquet(data)
    elif opts["input"] == "json":
        # When the query provably touches only top-level fields, each
        # record keeps just those (s3select/fastjson.py); else whole.
        from .fastjson import read_json_lines_fields, referenced_fields
        fields = referenced_fields(query)
        records = (read_json_lines(data) if fields is None
                   else read_json_lines_fields(data, fields))
    else:
        records = read_csv(data, header=opts["header"],
                           delimiter=opts["delimiter"])
    rows = run_query(query, records)
    if opts["output"] == "json":
        payload = write_json_lines(rows)
    else:
        payload = write_csv(rows, delimiter=opts["out_delimiter"])
    return select_response(payload, len(data), len(payload))
