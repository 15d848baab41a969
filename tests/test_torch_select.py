"""S3 Select of the port, held to the JAX package on the CPU.

Every query of tests/test_sse_select.py's TestSelectSQL, TestSelectR4
and TestParquetSelect goes through both packages' `execute_select` on
the same bytes (CSV, JSON lines, Parquet) and must give the same
event-stream body, byte for byte; so must the SQL errors.  A hypothesis
test does the same over seeded CSV and NDJSON rows, and a Select over
HTTP reads a sealed, compressed object through the port server.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import minio_tpu.s3select.engine as jax_engine
import minio_tpu.s3select.sql as jax_sql
import minio_tpu_torch.s3select.engine as port_engine
import minio_tpu_torch.s3select.sql as port_sql
from test_sse_select import CSV_DATA, SELECT_REQ

#: TestSelectSQL's queries over CSV_DATA (header, delimiter).
SQL_CSV = [
    ("SELECT name, salary FROM S3Object WHERE dept = 'eng'", True),
    ("SELECT * FROM S3Object WHERE salary > 95", True),
    ("SELECT count(*) AS n, avg(salary) AS a, max(salary) AS mx "
     "FROM S3Object WHERE dept = 'sales'", True),
    ("SELECT name FROM S3Object WHERE name LIKE '%a%' LIMIT 2", True),
    ("SELECT s.name, s.salary * 2 AS double_pay FROM S3Object s "
     "WHERE s.salary < 95", True),
]
HEADERLESS = (b"alice,eng,120\nbob,eng,100\n",
              "SELECT _1 FROM S3Object WHERE _3 > 100")
JSON_LINES = b'{"a": 1, "b": "x"}\n{"a": 5, "b": "y"}\n'

#: TestSelectR4's queries, each over its records.
R4_PATHS = [{"a": {"b": [{"c": 1}, {"c": 2}, {"c": 3}]}, "name": "row1"},
            {"a": {"b": [{"c": 9}]}, "name": "row2"}]
R4 = [
    ("SELECT s.a.b[1].c AS v FROM S3Object s", R4_PATHS),
    ("SELECT s.name FROM S3Object s WHERE s.a.b[0].c = 9", R4_PATHS),
    ("SELECT s.name FROM S3Object s WHERE s.a.missing IS NULL", R4_PATHS),
    ("SELECT CAST(n AS int) AS i, CAST(f AS float) AS x, "
     "CAST(b AS bool) AS t, CAST(s AS string) AS st FROM S3Object",
     [{"n": "42", "f": "2.5", "b": "true", "s": 7}]),
    ("SELECT LOWER(s) AS lo, UPPER(s) AS up, TRIM(s) AS t, "
     "CHAR_LENGTH(TRIM(s)) AS n, SUBSTRING(TRIM(s), 1, 5) AS sub, "
     "SUBSTRING(TRIM(s) FROM 7) AS tail FROM S3Object",
     [{"s": "  Hello World  "}]),
    ("SELECT TRIM(LEADING 'x' FROM v) AS t FROM S3Object",
     [{"v": "xxabcxx"}]),
    ("SELECT COALESCE(a, b, 'dflt') AS c, NULLIF(x, 5) AS nf "
     "FROM S3Object", [{"b": "bee", "x": 5}]),
    ("SELECT EXTRACT(year FROM TO_TIMESTAMP(ts)) AS y, "
     "EXTRACT(month FROM TO_TIMESTAMP(ts)) AS m, "
     "EXTRACT(day FROM TO_TIMESTAMP(ts)) AS d, "
     "EXTRACT(hour FROM TO_TIMESTAMP(ts)) AS h FROM S3Object",
     [{"ts": "2024-03-15T10:30:00Z"}]),
    ("SELECT DATE_ADD(month, 2, TO_TIMESTAMP(ts)) AS plus FROM S3Object",
     [{"ts": "2024-03-15T10:30:00Z"}]),
    ("SELECT DATE_DIFF(day, TO_TIMESTAMP(a), TO_TIMESTAMP(b)) AS dd "
     "FROM S3Object",
     [{"a": "2024-01-01T00:00:00Z", "b": "2024-01-31T00:00:00Z"}]),
    ("SELECT v FROM S3Object WHERE "
     "EXTRACT(year FROM TO_TIMESTAMP(ts)) = 2024",
     [{"ts": "2023-06-01T00:00:00Z", "v": 1},
      {"ts": "2024-06-01T00:00:00Z", "v": 2}]),
    ("select * from s3object s where s.Location like '%United States%'",
     [{"Location": "Seattle, United States"},
      {"Location": "Paris, France"}]),
    ("SELECT s.user.tags[2] AS tag FROM S3Object s "
     "WHERE CAST(s.n AS int) >= 3",
     [{"user": {"name": f"u{i}", "tags": ["a", "b", f"t{i}"]}, "n": i}
      for i in range(5)]),
]
BAD_SQL = ["SELECT FROM WHERE", "SELECT * FROM othertable",
           "SELECT CAST(n AS int) FROM S3Object"]


def opts(expression, input_="csv", output="csv", header=True):
    return {"expression": expression, "input": input_, "header": header,
            "delimiter": ",", "output": output, "out_delimiter": ","}


def ndjson(records) -> bytes:
    return b"\n".join(json.dumps(r).encode() for r in records) + b"\n"


def both(data: bytes, o: dict) -> bytes:
    want = jax_engine.execute_select(data, dict(o))
    got = port_engine.execute_select(data, dict(o))
    assert got == want, o["expression"]
    return got


def payloads(body: bytes) -> bytes:
    return b"".join(p for t, p in port_engine.decode_event_stream(body)
                    if t == "Records")


@pytest.mark.parametrize("output", ["csv", "json"])
@pytest.mark.parametrize("sql,header", SQL_CSV)
def test_sql_queries_match_jax(sql, header, output):
    body = both(CSV_DATA, opts(sql, output=output, header=header))
    assert [t for t, _ in port_engine.decode_event_stream(body)] == [
        "Records", "Stats", "End"]


@pytest.mark.parametrize("output", ["csv", "json"])
def test_headerless_and_json_input_match_jax(output):
    assert payloads(both(HEADERLESS[0], opts(
        HEADERLESS[1], output=output, header=False))) in (
        b"alice\n", b'{"_1": "alice"}\n')
    assert payloads(both(JSON_LINES, opts(
        "SELECT b FROM S3Object WHERE a >= 5", "json", output))) in (
        b"y\n", b'{"b": "y"}\n')


@pytest.mark.parametrize("output", ["csv", "json"])
@pytest.mark.parametrize("i", range(len(R4)))
def test_r4_queries_match_jax(i, output):
    sql, records = R4[i]
    both(ndjson(records), opts(sql, "json", output))


@pytest.mark.parametrize("sql", BAD_SQL)
def test_sql_errors_match_jax(sql):
    data = ndjson([{"n": "not-a-number"}])
    errs = []
    for eng, mod in ((jax_engine, jax_sql), (port_engine, port_sql)):
        with pytest.raises(mod.SQLError) as ei:
            eng.execute_select(data, opts(sql, "json"))
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


def _parquet(table: dict) -> bytes:
    import pyarrow as pa
    import pyarrow.parquet as pq
    buf = io.BytesIO()
    pq.write_table(pa.table(table), buf)
    return buf.getvalue()


PARQUET = {"name": ["ada", "bob", "cat"], "score": [90, 60, 75],
           "team": ["x", "y", "x"]}


@pytest.mark.parametrize("sql,output", [
    ("SELECT name FROM S3Object s WHERE s.score > 70", "csv"),
    ("SELECT s.name, s.score FROM S3Object s WHERE s.team = 'x'", "csv"),
    ("SELECT * FROM S3Object", "json")])
def test_parquet_queries_match_jax(sql, output):
    body = both(_parquet(PARQUET), opts(sql, "parquet", output))
    assert b"ada" in body


def test_parquet_rich_types_match_jax():
    import datetime
    import decimal
    data = _parquet({"ts": [datetime.datetime(2024, 5, 1, 12, 0)],
                     "amount": [decimal.Decimal("1.25")],
                     "blob": [b"\x00\x01"], "name": ["row1"]})
    body = both(data, opts("SELECT * FROM S3Object", "parquet", "json"))
    assert b"2024-05-01" in body and b"1.25" in body


def test_parquet_without_pyarrow_names_it(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name.startswith("pyarrow"):
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(port_sql.SQLError, match="pyarrow"):
        port_engine.execute_select(b"PAR1", opts("SELECT * FROM S3Object",
                                                 "parquet"))


def test_select_request_parses_as_jax():
    for body in (SELECT_REQ, SELECT_REQ.replace(
            b"<CSV/></OutputSerialization>",
            b"<JSON/></OutputSerialization>").replace(
            b"<CSV><FileHeaderInfo>USE</FileHeaderInfo></CSV>",
            b"<JSON><Type>LINES</Type></JSON>")):
        assert port_engine.parse_select_request(body) == \
            jax_engine.parse_select_request(body)


#: The JAX tests' queries the hypothesis rows are run through.
_QUERIES = [q for q, _ in SQL_CSV] + [
    "SELECT name FROM S3Object WHERE dept = 'ops' OR salary >= 150",
    "SELECT count(*) FROM S3Object"]

_rows = st.lists(st.tuples(
    st.sampled_from(["alice", "bob", "carol", "dave", "erin", "ann"]),
    st.sampled_from(["eng", "sales", "ops"]),
    st.integers(min_value=0, max_value=300)), min_size=0, max_size=40)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(rows=_rows, q=st.sampled_from(_QUERIES),
       fmt=st.sampled_from(["csv", "json"]),
       output=st.sampled_from(["csv", "json"]))
def test_seeded_rows_match_jax(rows, q, fmt, output):
    if fmt == "csv":
        data = b"name,dept,salary\n" + b"".join(
            b"%s,%s,%d\n" % (n.encode(), d.encode(), s) for n, d, s in rows)
    else:
        data = ndjson([{"name": n, "dept": d, "salary": s}
                       for n, d, s in rows])
    both(data, opts(q, fmt, output))


def test_select_over_http_on_a_sealed_compressed_object(tmp_path):
    from minio_tpu_torch.crypto.kms import StaticKMS
    from test_torch_server import PORT, TIMEOUT, _port_pools, close_pools
    rng = np.random.default_rng(7)
    data = b"name,dept,salary\n" + b"".join(
        b"u%d,%s,%d\n" % (i, (b"eng", b"ops")[int(rng.integers(0, 2))],
                          int(rng.integers(50, 200))) for i in range(20_000))
    pools = _port_pools(tmp_path, "s")
    srv = PORT.S3Server(pools, PORT.sigv4.Credentials("seladmin",
                                                      "seladmin-secret"),
                        kms=StaticKMS(b"\x24" * 32),
                        compress_enabled=True).start()
    try:
        cli = PORT.S3Client(srv.endpoint, "seladmin", "seladmin-secret",
                            timeout=TIMEOUT)
        cli.make_bucket("selb")
        key = b"\x25" * 32
        ssec = {
            "x-amz-server-side-encryption-customer-algorithm": "AES256",
            "x-amz-server-side-encryption-customer-key":
                base64.b64encode(key).decode(),
            "x-amz-server-side-encryption-customer-key-md5":
                base64.b64encode(hashlib.md5(key).digest()).decode()}
        for obj, h in (("s3.csv", {"x-amz-server-side-encryption":
                                   "AES256"}), ("c.csv", ssec)):
            assert cli.request("PUT", f"/selb/{obj}", body=data,
                               headers=h)[0] == 200
            meta = pools.head_object("selb", obj).metadata
            assert meta["x-mtpu-internal-compression"] == "deflate"
            keyh = {k: v for k, v in h.items() if "customer" in k}
            for expr in ("SELECT name FROM S3Object WHERE dept = 'eng'",
                         "SELECT count(*) FROM S3Object"):
                req = SELECT_REQ.replace(
                    b"SELECT name FROM S3Object WHERE dept = 'eng'",
                    expr.encode())
                st_, _, body = cli.request(
                    "POST", f"/selb/{obj}",
                    query={"select": "", "select-type": "2"}, body=req,
                    headers=keyh)
                assert st_ == 200, body
                assert body == jax_engine.execute_select(
                    data, jax_engine.parse_select_request(req))
        st_, _, body = cli.request("POST", "/selb/c.csv", query={
            "select": "", "select-type": "2"}, body=SELECT_REQ)
        assert st_ == 403                             # no SSE-C key
        st_, _, body = cli.request("POST", "/selb/s3.csv", query={
            "select": "", "select-type": "2"},
            body=SELECT_REQ.replace(b"SELECT name", b"SELECT FROM"))
        assert st_ == 400 and b"SelectParseError" in body
    finally:
        srv.shutdown()
        close_pools(pools)
