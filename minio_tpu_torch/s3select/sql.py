"""S3 Select SQL: tokenizer + recursive-descent parser + evaluator.

The port of minio_tpu/s3select/sql.py (the internal/s3select/sql role;
the reference parses with
participle and walks an AST the same way): the supported dialect is the
S3 Select core —

  SELECT */column-list/aggregates FROM S3Object[s] [alias]
  [WHERE expr] [LIMIT n]

with comparisons, AND/OR/NOT, arithmetic, LIKE, IN, IS [NOT] NULL,
JSON path expressions (s.a.b[2].c), CAST, the scalar string functions
(LOWER/UPPER/SUBSTRING/TRIM/CHAR_LENGTH), COALESCE/NULLIF, the
timestamp family (TO_TIMESTAMP/UTCNOW/EXTRACT/DATE_ADD/DATE_DIFF —
cf. internal/s3select/sql/funceval.go), aggregates COUNT/SUM/AVG/MIN/
MAX, and dynamic typing (numeric strings compare numerically, like the
reference's value coercion).
"""

from __future__ import annotations

import re


class SQLError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<number>\d+\.\d+|\d+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*|"[^"]+")
    | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|\*|,|\+|-|/|%|\.|\[|\])
    )""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "limit", "and", "or", "not",
             "like", "in", "is", "null", "as", "between", "escape",
             "cast", "for", "leading", "trailing", "both"}


def tokenize(sql: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(sql):
        if sql[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SQLError(f"bad token at {sql[pos:pos + 10]!r}")
        pos = m.end()
        if m.lastgroup == "ident":
            text = m.group("ident")
            if text.lower() in _KEYWORDS:
                out.append(("kw", text.lower()))
            else:
                out.append(("ident", text))
        else:
            out.append((m.lastgroup, m.group(m.lastgroup)))
    return out


# -- AST nodes ---------------------------------------------------------------

class Node:
    pass


class Literal(Node):
    def __init__(self, value):
        self.value = value


class Column(Node):
    def __init__(self, name: str):
        self.name = name


class Path(Node):
    """Nested access: s.a.b[2].c -> steps after the (stripped) head.
    steps: list of ("key", name) | ("index", int)."""

    def __init__(self, head: str, steps: list):
        self.head = head
        self.steps = steps


class Func(Node):
    def __init__(self, fn: str, args: list):
        self.fn, self.args = fn, args


class BinOp(Node):
    def __init__(self, op, left, right):
        self.op, self.left, self.right = op, left, right


class UnaryOp(Node):
    def __init__(self, op, operand):
        self.op, self.operand = op, operand


class Agg(Node):
    def __init__(self, fn: str, arg):
        self.fn, self.arg = fn, arg


class Query:
    def __init__(self, projections, where, limit, star, aliases):
        self.projections = projections    # list[(name, Node)]
        self.where = where
        self.limit = limit
        self.star = star
        self.aliases = aliases
        self.has_aggregates = any(
            isinstance(n, Agg) for _, n in projections)


class Parser:
    _AGG_FNS = {"count", "sum", "avg", "min", "max"}

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, kind, value=None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1].lower() != value):
            raise SQLError(f"expected {value or kind}, got {t[1]!r}")
        return t

    # SELECT ... FROM S3Object [WHERE ...] [LIMIT n]
    def parse(self) -> Query:
        self.expect("kw", "select")
        star = False
        projections = []
        if self.peek() == ("op", "*"):
            self.next()
            star = True
        else:
            while True:
                node = self.parse_expr()
                name = f"_{len(projections) + 1}"
                if isinstance(node, Column):
                    name = node.name
                elif isinstance(node, Path):
                    keys = [s[1] for s in node.steps if s[0] == "key"]
                    name = keys[-1] if keys else node.head
                if self.peek() == ("kw", "as"):
                    self.next()
                    name = self.next()[1]
                projections.append((name, node))
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
        self.expect("kw", "from")
        table = self.next()
        if table[1].lower() not in ("s3object", "s3objects"):
            raise SQLError(f"FROM must be S3Object, got {table[1]!r}")
        alias = ""
        if self.peek()[0] == "ident":
            alias = self.next()[1]
        where = None
        limit = None
        if self.peek() == ("kw", "where"):
            self.next()
            where = self.parse_expr()
        if self.peek() == ("kw", "limit"):
            self.next()
            limit = int(self.expect("number")[1])
        if self.peek()[0] != "eof":
            raise SQLError(f"trailing tokens at {self.peek()[1]!r}")
        return Query(projections, where, limit, star, {alias} if alias
                     else set())

    # precedence: OR < AND < NOT < comparison < additive < multiplicative
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("kw", "or"):
            self.next()
            left = BinOp("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.peek() == ("kw", "and"):
            self.next()
            left = BinOp("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.peek() == ("kw", "not"):
            self.next()
            return UnaryOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self):
        left = self.parse_additive()
        t = self.peek()
        if t[0] == "op" and t[1] in ("=", "!=", "<>", "<", "<=", ">", ">="):
            op = self.next()[1]
            if op == "<>":
                op = "!="
            return BinOp(op, left, self.parse_additive())
        if t == ("kw", "like"):
            self.next()
            return BinOp("like", left, self.parse_additive())
        if t == ("kw", "between"):
            self.next()
            lo = self.parse_additive()
            self.expect("kw", "and")
            hi = self.parse_additive()
            return BinOp("and", BinOp(">=", left, lo),
                         BinOp("<=", left, hi))
        if t == ("kw", "in"):
            self.next()
            self.expect("op", "(")
            items = [self.parse_additive()]
            while self.peek() == ("op", ","):
                self.next()
                items.append(self.parse_additive())
            self.expect("op", ")")
            node = BinOp("=", left, items[0])
            for it in items[1:]:
                node = BinOp("or", node, BinOp("=", left, it))
            return node
        if t == ("kw", "is"):
            self.next()
            negate = False
            if self.peek() == ("kw", "not"):
                self.next()
                negate = True
            self.expect("kw", "null")
            node = UnaryOp("isnull", left)
            return UnaryOp("not", node) if negate else node
        return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            left = BinOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self):
        left = self.parse_primary()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            left = BinOp(op, left, self.parse_primary())
        return left

    _SCALAR_FNS = {"lower", "upper", "char_length", "character_length",
                   "coalesce", "nullif", "to_timestamp", "utcnow",
                   "date_add", "date_diff", "substring", "trim",
                   "extract"}
    _CAST_TYPES = {"int", "integer", "float", "decimal", "numeric",
                   "string", "char", "varchar", "bool", "boolean",
                   "timestamp"}

    def parse_primary(self):
        t = self.next()
        if t[0] == "number":
            return Literal(float(t[1]) if "." in t[1] else int(t[1]))
        if t[0] == "string":
            return Literal(t[1][1:-1].replace("''", "'"))
        if t == ("op", "("):
            node = self.parse_expr()
            self.expect("op", ")")
            return node
        if t == ("op", "-"):
            return BinOp("-", Literal(0), self.parse_primary())
        if t == ("kw", "cast"):
            # CAST(expr AS type)
            self.expect("op", "(")
            expr = self.parse_expr()
            self.expect("kw", "as")
            ty = self.next()[1].lower()
            if ty not in self._CAST_TYPES:
                raise SQLError(f"CAST to unknown type {ty!r}")
            self.expect("op", ")")
            return Func("cast", [expr, Literal(ty)])
        if t[0] == "ident":
            name = t[1].strip('"')
            low = name.lower()
            if low in self._AGG_FNS and self.peek() == ("op", "("):
                self.next()
                if self.peek() == ("op", "*"):
                    self.next()
                    arg = None
                else:
                    arg = self.parse_expr()
                self.expect("op", ")")
                return Agg(low, arg)
            if low in self._SCALAR_FNS and self.peek() == ("op", "("):
                self.next()
                return self.parse_func(low)
            return self.parse_path(name)
        if t == ("kw", "null"):
            return Literal(None)
        raise SQLError(f"unexpected token {t[1]!r}")

    def parse_path(self, head: str):
        """a.b[2].c — dotted keys + bracket indexes after an ident."""
        steps = []
        while True:
            t = self.peek()
            if t == ("op", "."):
                self.next()
                nxt = self.next()
                if nxt[0] not in ("ident", "kw"):
                    raise SQLError(f"bad path step {nxt[1]!r}")
                steps.append(("key", nxt[1].strip('"')))
            elif t == ("op", "["):
                self.next()
                idx = self.expect("number")[1]
                if "." in idx:
                    raise SQLError("array index must be an integer")
                self.expect("op", "]")
                steps.append(("index", int(idx)))
            else:
                break
        if not steps:
            return Column(head)
        return Path(head, steps)

    def parse_func(self, fn: str):
        """fn's '(' already consumed."""
        if fn == "utcnow":
            self.expect("op", ")")
            return Func(fn, [])
        if fn == "substring":
            # SUBSTRING(s FROM start [FOR len]) | SUBSTRING(s, start[, len])
            s = self.parse_expr()
            args = [s]
            if self.peek() == ("kw", "from"):
                self.next()
                args.append(self.parse_expr())
                if self.peek() == ("kw", "for"):
                    self.next()
                    args.append(self.parse_expr())
            else:
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.parse_expr())
            self.expect("op", ")")
            if len(args) not in (2, 3):
                raise SQLError("substring takes 2 or 3 arguments")
            return Func(fn, args)
        if fn == "trim":
            # TRIM([LEADING|TRAILING|BOTH] [chars] FROM s) | TRIM(s)
            mode = "both"
            t = self.peek()
            if t[0] == "kw" and t[1] in ("leading", "trailing", "both"):
                mode = self.next()[1]
            chars = None
            if self.peek()[0] == "string":
                chars = self.parse_primary()
            if self.peek() == ("kw", "from"):
                self.next()
                s = self.parse_expr()
            else:
                s = chars if chars is not None else self.parse_expr()
                chars = None
            self.expect("op", ")")
            return Func(fn, [s, Literal(mode),
                             chars if chars is not None else Literal(None)])
        if fn == "extract":
            # EXTRACT(part FROM ts)
            part = self.next()[1].lower()
            if part not in ("year", "month", "day", "hour", "minute",
                            "second", "timezone_hour", "timezone_minute"):
                raise SQLError(f"EXTRACT of unknown part {part!r}")
            self.expect("kw", "from")
            ts = self.parse_expr()
            self.expect("op", ")")
            return Func(fn, [Literal(part), ts])
        args = []
        if fn in ("date_add", "date_diff"):
            # first argument is a bare date-part symbol, not a column
            part = self.next()[1].lower()
            if part not in ("year", "month", "day", "hour", "minute",
                            "second"):
                raise SQLError(f"{fn} of unknown part {part!r}")
            args.append(Literal(part))
            self.expect("op", ",")
        if self.peek() != ("op", ")"):
            args.append(self.parse_expr())
            while self.peek() == ("op", ","):
                self.next()
                args.append(self.parse_expr())
        self.expect("op", ")")
        arity = {"lower": 1, "upper": 1, "char_length": 1,
                 "character_length": 1, "nullif": 2, "to_timestamp": 1,
                 "date_add": 3, "date_diff": 3}
        if fn in arity and len(args) != arity[fn]:
            raise SQLError(f"{fn} takes {arity[fn]} arguments")
        if fn == "coalesce" and not args:
            raise SQLError("coalesce needs at least one argument")
        return Func(fn, args)


def parse(sql: str) -> Query:
    return Parser(tokenize(sql)).parse()


# -- evaluation --------------------------------------------------------------

def _coerce(v):
    """Numeric strings act as numbers (the reference's dynamic typing)."""
    if isinstance(v, str):
        try:
            return float(v) if "." in v or "e" in v.lower() else int(v)
        except ValueError:
            return v
    return v


def _like(value, pattern) -> bool:
    if not isinstance(value, str) or not isinstance(pattern, str):
        return False
    rx = re.escape(pattern).replace("%", ".*").replace("_", ".")
    return re.fullmatch(rx, value, re.DOTALL) is not None


def _parse_ts(v):
    """ISO-8601 (and RFC3339 Z) timestamp -> datetime; None on failure."""
    import datetime as _dt
    if isinstance(v, _dt.datetime):
        return v
    if not isinstance(v, str):
        return None
    s = v.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    try:
        return _dt.datetime.fromisoformat(s)
    except ValueError:
        return None


def eval_func(fn: str, args: list, record: dict, aliases: set):
    import datetime as _dt
    if fn == "coalesce":
        # lazy: later arguments must not evaluate (or fail) once an
        # earlier one is non-NULL
        for a in args:
            v = eval_node(a, record, aliases)
            if v is not None:
                return v
        return None
    ev = [eval_node(a, record, aliases) for a in args]
    if fn == "cast":
        v, ty = ev
        if v is None:
            return None
        try:
            if ty in ("int", "integer"):
                return int(float(v)) if isinstance(v, str) else int(v)
            if ty in ("float", "decimal", "numeric"):
                return float(v)
            if ty in ("string", "char", "varchar"):
                if isinstance(v, _dt.datetime):
                    return v.isoformat()
                return str(v)
            if ty in ("bool", "boolean"):
                if isinstance(v, str):
                    if v.lower() in ("true", "1"):
                        return True
                    if v.lower() in ("false", "0"):
                        return False
                    raise ValueError(v)
                return bool(v)
            if ty == "timestamp":
                ts = _parse_ts(v)
                if ts is None:
                    raise ValueError(v)
                return ts
        except (TypeError, ValueError):
            raise SQLError(
                f"CastFailed: cannot CAST {v!r} to {ty}") from None
    if fn == "lower":
        return ev[0].lower() if isinstance(ev[0], str) else ev[0]
    if fn == "upper":
        return ev[0].upper() if isinstance(ev[0], str) else ev[0]
    if fn in ("char_length", "character_length"):
        return len(ev[0]) if isinstance(ev[0], str) else None
    if fn == "nullif":
        return None if ev[0] == ev[1] else ev[0]
    if fn == "substring":
        s = ev[0]
        if not isinstance(s, str):
            return None
        # SQL NULL semantics: a NULL position/length yields NULL, not
        # a query-aborting TypeError
        if len(ev) < 2 or ev[1] is None or (len(ev) >= 3
                                            and ev[2] is None):
            return None
        start = int(ev[1])
        # SQL 1-based; non-positive start extends from the beginning
        begin = max(start - 1, 0)
        if len(ev) >= 3:
            length = int(ev[2]) + min(start - 1, 0)
            if length < 0:
                return ""
            return s[begin:begin + length]
        return s[begin:]
    if fn == "trim":
        s, mode, chars = ev
        if not isinstance(s, str):
            return None
        chars = chars if isinstance(chars, str) and chars else None
        if mode == "leading":
            return s.lstrip(chars)
        if mode == "trailing":
            return s.rstrip(chars)
        return s.strip(chars)
    if fn == "to_timestamp":
        ts = _parse_ts(ev[0])
        if ts is None:
            raise SQLError(f"CastFailed: bad timestamp {ev[0]!r}")
        return ts
    if fn == "utcnow":
        return _dt.datetime.now(_dt.timezone.utc)
    if fn == "extract":
        part, v = ev
        ts = _parse_ts(v)
        if ts is None:
            return None
        if part == "timezone_hour":
            off = ts.utcoffset()
            return int(off.total_seconds() // 3600) if off else 0
        if part == "timezone_minute":
            off = ts.utcoffset()
            return int((off.total_seconds() % 3600) // 60) if off else 0
        return getattr(ts, part)
    if fn == "date_add":
        part, n, v = ev[0], ev[1], ev[2]
        ts = _parse_ts(v)
        if ts is None or n is None:
            return None
        n = int(n)
        if part in ("year", "month"):
            month = ts.month - 1 + (n if part == "month" else 0)
            year = ts.year + (n if part == "year" else 0) + month // 12
            month = month % 12 + 1
            import calendar
            day = min(ts.day, calendar.monthrange(year, month)[1])
            return ts.replace(year=year, month=month, day=day)
        delta = {"day": _dt.timedelta(days=n),
                 "hour": _dt.timedelta(hours=n),
                 "minute": _dt.timedelta(minutes=n),
                 "second": _dt.timedelta(seconds=n)}.get(part)
        if delta is None:
            raise SQLError(f"DATE_ADD of unknown part {part!r}")
        return ts + delta
    if fn == "date_diff":
        part = ev[0]
        a, b = _parse_ts(ev[1]), _parse_ts(ev[2])
        if a is None or b is None:
            return None
        if part == "year":
            return b.year - a.year
        if part == "month":
            return (b.year - a.year) * 12 + (b.month - a.month)
        secs = (b - a).total_seconds()
        div = {"day": 86400, "hour": 3600, "minute": 60,
               "second": 1}.get(part)
        if div is None:
            raise SQLError(f"DATE_DIFF of unknown part {part!r}")
        return int(secs // div)
    raise SQLError(f"unknown function {fn!r}")


def eval_node(node: Node, record: dict, aliases: set):
    if isinstance(node, Literal):
        return node.value
    if isinstance(node, Column):
        name = node.name
        if name.lower() == "s3object" or name in aliases:
            return record
        if name in record:
            return record[name]
        return record.get(name.lower())
    if isinstance(node, Path):
        head = node.head
        steps = node.steps
        if head in aliases or head.lower() == "s3object":
            cur = record
        else:
            cur = record.get(head, record.get(head.lower()))
        for kind, step in steps:
            if cur is None:
                return None
            if kind == "key":
                if not isinstance(cur, dict):
                    return None
                cur = cur.get(step, cur.get(step.lower())
                              if isinstance(step, str) else None)
            else:
                if not isinstance(cur, (list, tuple)) \
                        or not 0 <= step < len(cur):
                    return None
                cur = cur[step]
        return cur
    if isinstance(node, Func):
        return eval_func(node.fn, node.args, record, aliases)
    if isinstance(node, UnaryOp):
        if node.op == "not":
            return not eval_node(node.operand, record, aliases)
        if node.op == "isnull":
            return eval_node(node.operand, record, aliases) is None
    if isinstance(node, BinOp):
        if node.op == "and":
            return bool(eval_node(node.left, record, aliases)) and \
                bool(eval_node(node.right, record, aliases))
        if node.op == "or":
            return bool(eval_node(node.left, record, aliases)) or \
                bool(eval_node(node.right, record, aliases))
        lv = _coerce(eval_node(node.left, record, aliases))
        rv = _coerce(eval_node(node.right, record, aliases))
        try:
            if node.op == "=":
                return lv == rv
            if node.op == "!=":
                return lv != rv
            if node.op == "<":
                return lv < rv
            if node.op == "<=":
                return lv <= rv
            if node.op == ">":
                return lv > rv
            if node.op == ">=":
                return lv >= rv
            if node.op == "+":
                return lv + rv
            if node.op == "-":
                return lv - rv
            if node.op == "*":
                return lv * rv
            if node.op == "/":
                return lv / rv
            if node.op == "%":
                return lv % rv
            if node.op == "like":
                return _like(lv, rv)
        except TypeError:
            return None
    raise SQLError(f"cannot evaluate {node!r}")


class AggState:
    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def update(self, v):
        self.count += 1
        if v is None:
            return
        v = _coerce(v)
        if isinstance(v, (int, float)):
            self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v


def run_query(query: Query, records) -> list[dict]:
    """records: iterable of dicts -> list of output row dicts."""
    out = []
    aggs: dict[int, AggState] = {}
    n = 0
    for record in records:
        if query.where is not None and \
                not eval_node(query.where, record, query.aliases):
            continue
        if query.has_aggregates:
            for i, (_, node) in enumerate(query.projections):
                if isinstance(node, Agg):
                    st = aggs.setdefault(i, AggState())
                    st.update(None if node.arg is None
                              else eval_node(node.arg, record,
                                             query.aliases))
            continue
        if query.star:
            out.append(dict(record))
        else:
            row = {}
            for name, node in query.projections:
                row[name] = eval_node(node, record, query.aliases)
            out.append(row)
        n += 1
        if query.limit is not None and n >= query.limit:
            break
    if query.has_aggregates:
        row = {}
        for i, (name, node) in enumerate(query.projections):
            st = aggs.get(i, AggState())
            if node.fn == "count":
                row[name] = st.count
            elif node.fn == "sum":
                row[name] = st.sum
            elif node.fn == "avg":
                row[name] = st.sum / st.count if st.count else None
            elif node.fn == "min":
                row[name] = st.min
            elif node.fn == "max":
                row[name] = st.max
        return [row]
    return out
