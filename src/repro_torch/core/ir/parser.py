"""Mini Cypher / Gremlin front-ends → GraphIR logical plans (paper §5.1).

The supported subsets cover the paper's running examples (Fig. 5 and the
fraud-detection query of §8): linear MATCH path patterns with inline
property maps, WHERE with conjunctions / arithmetic over vertex & edge
properties / IN lists, WITH aggregation, RETURN projection, ORDER BY,
LIMIT; Gremlin V()/hasLabel/has/out/in/both/values/where chains.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir.dag import (MAX_VAR_HOPS, Agg, BinExpr, Const, Expand,
                               ExpandVar, GetVertex, InsertEdge, Limit,
                               LogicalPlan, OrderBy, Param, Pred,
                               ProcedureCall, Project, PropRef, Scan, Select,
                               SetProp, ShortestPath, With)
from repro_torch.storage.generators import EDGE_NAMES, LABEL_NAMES


# ------------------------------------------------------------- expressions
_TOKEN = re.compile(r"""
    (?P<num>-?\d+\.?\d*)
  | (?P<list>\[[^\]]*\])
  | (?P<str>'[^']*'|"[^\"]*")
  | (?P<param>\$[A-Za-z_]\w*)
  | (?P<prop>[A-Za-z_]\w*\.[A-Za-z_]\w*)
  | (?P<ident>[A-Za-z_]\w*)
  | (?P<op><=|>=|<>|!=|==?|<|>|\+|-|\*|/|\(|\))
  | (?P<ws>\s+)
""", re.X)

_CMP = {"=": "==", "==": "==", "!=": "!=", "<>": "!=", "<": "<", "<=": "<=",
        ">": ">", ">=": ">="}


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            raise SyntaxError(f"bad token at {s[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group()))
    return out


class _ExprParser:
    """Precedence: or < and < cmp/IN < add < mul < atom."""

    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self):
        t = self.peek()
        self.i += 1
        return t

    def parse(self):
        return self._or()

    def _or(self):
        left = self._and()
        while self.peek() == ("ident", "OR"):
            self.take()
            left = BinExpr("or", left, self._and())
        return left

    def _and(self):
        left = self._cmp()
        while self.peek() == ("ident", "AND"):
            self.take()
            left = BinExpr("and", left, self._cmp())
        return left

    def _cmp(self):
        left = self._add()
        kind, val = self.peek()
        if kind == "op" and val in _CMP:
            self.take()
            return BinExpr(_CMP[val], left, self._add())
        if (kind, val) == ("ident", "IN"):
            self.take()
            return BinExpr("in", left, self._add())
        return left

    def _add(self):
        left = self._mul()
        while True:
            kind, val = self.peek()
            if kind == "op" and val in ("+", "-"):
                self.take()
                left = BinExpr(val, left, self._mul())
            else:
                return left

    def _mul(self):
        left = self._atom()
        while True:
            kind, val = self.peek()
            if kind == "op" and val in ("*", "/"):
                self.take()
                left = BinExpr(val, left, self._atom())
            else:
                return left

    def _atom(self):
        kind, val = self.take()
        if kind == "num":
            return Const(float(val) if "." in val else int(val))
        if kind == "str":
            return Const(val[1:-1])
        if kind == "param":
            return Param(val[1:])             # placeholder; bound later
        if kind == "list":
            items = [x.strip() for x in val[1:-1].split(",") if x.strip()]
            return Const(np.array([float(x) if "." in x else int(x)
                                   for x in items]))
        if kind == "prop":
            alias, prop = val.split(".")
            return PropRef(alias, prop)
        if kind == "ident":
            return PropRef(val, None)
        if (kind, val) == ("op", "("):
            e = self.parse()
            k, v = self.take()
            assert (k, v) == ("op", ")"), "unbalanced parens"
            return e
        raise SyntaxError(f"unexpected {kind} {val!r}")


def parse_expr(s: str):
    # normalize keywords
    s = re.sub(r"\b(and)\b", "AND", s, flags=re.I)
    s = re.sub(r"\b(or)\b", "OR", s, flags=re.I)
    s = re.sub(r"\b(in)\b", "IN", s, flags=re.I)
    return _ExprParser(_tokenize(s)).parse()


# ------------------------------------------------------------------ Cypher
_NODE = re.compile(r"\(\s*(?P<alias>\w+)?\s*(?::(?P<label>\w+))?"
                   r"\s*(?P<props>\{[^}]*\})?\s*\)")
_EDGE = re.compile(r"(?P<l><)?-\s*(?:\[\s*(?P<alias>\w+)?\s*(?::(?P<label>\w+))?"
                   r"\s*(?P<var>\*[^\]{]*)?"
                   r"\s*(?P<props>\{[^}]*\})?\s*\])?\s*-(?P<r>>)?")

# ``*``, ``*k``, ``*a..b``, ``*..b`` — anything else is malformed
_RANGE = re.compile(r"^(?P<lo>-?\d+)?(?P<dots>\.\.)?(?P<hi>-?\d+)?$")


def _parse_range(var: str, where: str) -> Tuple[int, int]:
    """Validate one ``*min..max`` var-length quantifier → (min, max).

    Rejects — rather than silently mis-parsing — empty ranges (``*3..1``),
    unbounded forms (``*``, ``*a..``, ``*..``: the fragment lowering
    unrolls the range, so an explicit upper bound is mandatory), negative
    bounds, non-numeric text, and bounds above ``MAX_VAR_HOPS``."""
    body = var[1:].strip()
    m = _RANGE.match(body)
    if not m:
        raise SyntaxError(f"malformed var-length range {var!r} in {where}")
    lo_s, dots, hi_s = m.group("lo"), m.group("dots"), m.group("hi")
    if not dots:
        if lo_s is None:
            raise SyntaxError(
                f"unbounded var-length {var!r} in {where}: an explicit "
                f"upper bound is required (e.g. *1..3, max {MAX_VAR_HOPS})")
        lo = hi = int(lo_s)
    else:
        if hi_s is None:
            raise SyntaxError(
                f"unbounded var-length range {var!r} in {where}: an "
                f"explicit upper bound is required (e.g. *1..3, "
                f"max {MAX_VAR_HOPS})")
        lo = int(lo_s) if lo_s is not None else 1
        hi = int(hi_s)
    if lo < 0 or hi < 0:
        raise SyntaxError(f"negative var-length bounds {var!r} in {where}")
    if lo > hi:
        raise SyntaxError(f"empty var-length range {var!r} in {where}: "
                          f"min {lo} > max {hi}")
    if hi > MAX_VAR_HOPS:
        raise SyntaxError(f"var-length upper bound {hi} exceeds the cap "
                          f"{MAX_VAR_HOPS} in {where}")
    return lo, hi


def _check_var_edge(em, pattern: str) -> Tuple[int, int]:
    """Shared validation for a var-length relationship match: no edge
    alias (each walk traverses many edges — there is no single edge id to
    bind), no inline edge property map (per-edge predicates over repeated
    hops are unsupported)."""
    if em.group("alias"):
        raise SyntaxError(
            f"var-length relationship cannot bind an edge alias "
            f"{em.group('alias')!r} in {pattern!r} (a walk has no single "
            f"edge id)")
    if em.group("props"):
        raise SyntaxError(
            f"var-length relationship cannot carry an edge property map "
            f"in {pattern!r}")
    return _parse_range(em.group("var"), repr(pattern))


def _props_to_pred(alias: str, props: Optional[str]):
    if not props:
        return None
    inner = props.strip()[1:-1]
    parts = []
    for kv in inner.split(","):
        if not kv.strip():
            continue
        k, v = kv.split(":")
        v = v.strip()
        if v.startswith("$"):
            value = Param(v[1:])             # stored-procedure parameter
        elif v[0] in "'\"":
            value = Const(v[1:-1])
        else:
            value = Const(float(v) if "." in v else int(v))
        parts.append(BinExpr("==", PropRef(alias, k.strip()), value))
    out = parts[0]
    for p in parts[1:]:
        out = BinExpr("and", out, p)
    return Pred(out)


def _props_to_items(props: Optional[str]) -> Tuple:
    """``{date: $d, rating: 5}`` → ((name, Expr), …) — the property map of
    a CREATE edge. Values are full expressions (``$params``, literals,
    arithmetic over matched aliases' properties)."""
    if not props:
        return ()
    inner = props.strip()[1:-1]
    items = []
    for kv in inner.split(","):
        if not kv.strip():
            continue
        k, v = kv.split(":", 1)
        items.append((k.strip(), parse_expr(v.strip())))
    return tuple(items)


def _node_info(m, anon_counter: List[int]):
    """(alias, label, props-pred) of one matched ``_NODE`` group."""
    alias = m.group("alias")
    if alias is None:
        anon_counter[0] += 1
        alias = f"_v{anon_counter[0]}"
    label = LABEL_NAMES.get(m.group("label")) if m.group("label") else None
    return alias, label, _props_to_pred(alias, m.group("props"))


# optional path binding (``p = shortestPath(...)``) is accepted and
# discarded: only the target alias and ``dist`` column are addressable
_SHORTEST = re.compile(r"^(?:\w+\s*=\s*)?shortestPath\s*\(", re.I)


def _parse_shortest(inner: str, seen: set, anon_counter: List[int]) -> List:
    """``shortestPath((a)-[:KNOWS*..4]->(b))`` → Scan + ShortestPath. The
    source may be already bound (its label/props become filters); the
    target must be fresh and receives one row per reachable vertex with
    the walk length in the ``dist`` column."""
    ops: List = []
    nm = _NODE.match(inner)
    if not nm:
        raise SyntaxError(
            f"shortestPath pattern must start with a node: {inner!r}")
    alias, label, pred = _node_info(nm, anon_counter)
    if alias not in seen:
        ops.append(Scan(alias, label, pred))
        seen.add(alias)
    else:
        if label is not None:
            ops.append(Select(Pred(BinExpr(
                "==", PropRef(alias, "__label__"), Const(label)))))
        if pred is not None:
            ops.append(Select(pred))
    em = _EDGE.match(inner, nm.end())
    if not em:
        raise SyntaxError(f"shortestPath needs a relationship: {inner!r}")
    if em.group("var") is None:
        raise SyntaxError(
            f"shortestPath needs an explicit *..max bound in {inner!r} "
            f"(e.g. [:KNOWS*..4])")
    lo, hi = _check_var_edge(em, inner)
    if lo > 1:
        raise SyntaxError(
            f"shortestPath min hops must be 0 or 1, got {lo} in {inner!r}")
    direction = "in" if em.group("l") else "out"
    e_label = (EDGE_NAMES.get(em.group("label"))
               if em.group("label") else None)
    nm2 = _NODE.match(inner, em.end())
    if not nm2:
        raise SyntaxError(
            f"expected node after shortestPath edge at {inner[em.end():]!r}")
    if nm2.end() != len(inner):
        raise SyntaxError(
            f"unparsed shortestPath segment {inner[nm2.end():]!r} "
            f"(shortestPath covers a single var-length relationship)")
    t_alias, t_label, t_pred = _node_info(nm2, anon_counter)
    if t_alias in seen:
        raise SyntaxError(
            f"shortestPath target {t_alias!r} is already bound in "
            f"{inner!r}; it must be a fresh alias")
    ops.append(ShortestPath(src=alias, alias=t_alias, edge_label=e_label,
                            direction=direction, min_hops=lo, max_hops=hi,
                            dist="dist", vertex_label=t_label,
                            vertex_pred=t_pred))
    seen.add(t_alias)
    seen.add("dist")
    return ops


def _parse_pattern(pattern: str, seen: set, anon_counter: List[int]) -> List:
    """One comma-separated MATCH pattern → list of Scan/Expand+GetVertex."""
    sm = _SHORTEST.match(pattern)
    if sm:
        if not pattern.endswith(")"):
            raise SyntaxError(f"unbalanced shortestPath(...): {pattern!r}")
        return _parse_shortest(pattern[sm.end():-1].strip(), seen,
                               anon_counter)
    ops: List = []
    pos = 0
    m = _NODE.match(pattern, pos)
    if not m:
        raise SyntaxError(f"pattern must start with a node: {pattern!r}")

    def node_info(m):
        return _node_info(m, anon_counter)

    alias, label, pred = node_info(m)
    if alias not in seen:
        ops.append(Scan(alias, label, pred))
        seen.add(alias)
    else:
        # alias already bound (earlier pattern or a CALL … YIELD): apply the
        # node's label/props as filters instead of re-scanning
        if label is not None:
            ops.append(Select(Pred(BinExpr(
                "==", PropRef(alias, "__label__"), Const(label)))))
        if pred is not None:
            ops.append(Select(pred))
    prev = alias
    pos = m.end()
    while pos < len(pattern):
        em = _EDGE.match(pattern, pos)
        if not em:
            break
        direction = "in" if em.group("l") else "out"
        e_alias = em.group("alias")
        if e_alias is None:
            anon_counter[0] += 1
            e_alias = f"_e{anon_counter[0]}"
        e_label = (EDGE_NAMES.get(em.group("label"))
                   if em.group("label") else None)
        pos = em.end()
        nm = _NODE.match(pattern, pos)
        if not nm:
            raise SyntaxError(f"expected node after edge at {pattern[pos:]!r}")
        n_alias, n_label, n_pred = node_info(nm)
        pos = nm.end()
        if em.group("var") is not None:
            lo, hi = _check_var_edge(em, pattern)
            if n_alias in seen:
                # cycle-close: land the walk on a fresh alias and join it
                # back to the bound one
                anon_counter[0] += 1
                fresh = f"_j{anon_counter[0]}"
                ops.append(ExpandVar(src=prev, alias=fresh,
                                     edge_label=e_label, direction=direction,
                                     min_hops=lo, max_hops=hi,
                                     vertex_label=n_label, vertex_pred=None))
                ops.append(Select(Pred(BinExpr(
                    "==", PropRef(fresh, None), PropRef(n_alias, None)))))
                if n_pred is not None:
                    ops.append(Select(n_pred))
            else:
                ops.append(ExpandVar(src=prev, alias=n_alias,
                                     edge_label=e_label, direction=direction,
                                     min_hops=lo, max_hops=hi,
                                     vertex_label=n_label,
                                     vertex_pred=n_pred))
                seen.add(n_alias)
            prev = n_alias
            continue
        ops.append(Expand(src=prev, edge_label=e_label, direction=direction,
                          edge=e_alias))
        if em.group("props"):
            # inline edge property map: a filter on the edge alias (RBO
            # pushes it into the Expand as a storage-level predicate)
            ops.append(Select(_props_to_pred(e_alias, em.group("props"))))
        if n_alias in seen:
            # closing a cycle onto an already-bound alias (earlier pattern,
            # earlier hop, or a CALL-yielded vertex): materialize the head
            # under a fresh name and enforce the join equality, instead of
            # silently rebinding the column
            anon_counter[0] += 1
            fresh = f"_j{anon_counter[0]}"
            ops.append(GetVertex(edge=e_alias, alias=fresh, label=n_label,
                                 pred=None))
            ops.append(Select(Pred(BinExpr(
                "==", PropRef(fresh, None), PropRef(n_alias, None)))))
            if n_pred is not None:       # props map refs the bound alias
                ops.append(Select(n_pred))
        else:
            ops.append(GetVertex(edge=e_alias, alias=n_alias, label=n_label,
                                 pred=n_pred))
            seen.add(n_alias)
        prev = n_alias
    if pos < len(pattern) and pattern[pos:].strip():
        # silently dropping an unparseable suffix (e.g. a typo'd edge) is
        # the classic mis-parse hazard — reject with the exact leftover
        raise SyntaxError(f"unparsed pattern segment {pattern[pos:]!r} "
                          f"in {pattern!r}")
    return ops


def _parse_create(pattern: str, seen: set, anon_counter: List[int]) -> List:
    """One CREATE pattern → InsertEdge ops (DESIGN.md §11).

    ``CREATE (a)-[:KNOWS {since: $s}]->(b)`` appends one edge per row of
    the bound prefix when ``a``/``b`` were MATCHed; an *unbound* endpoint
    resolves through its own label / property map against existing
    vertices (``CREATE (x {id: $src})-[:KNOWS]->(y {id: $dst})``). There
    is no vertex allocation — GART's write surface is edges + vertex
    properties — so a CREATE pattern without an edge is rejected."""
    ops: List = []
    pos = 0
    m = _NODE.match(pattern, pos)
    if not m:
        raise SyntaxError(f"CREATE pattern must start with a node: "
                          f"{pattern!r}")

    def endpoint(nm):
        alias, label, pred = _node_info(nm, anon_counter)
        if alias in seen:
            if label is not None or pred is not None:
                raise SyntaxError(
                    f"CREATE endpoint {alias!r} is already bound; it "
                    f"cannot carry a label or property map")
            return alias, None, None
        if label is None and pred is None:
            # openCypher would allocate a new node here; this stack has
            # no vertex allocation, and resolving a bare alias against
            # every vertex would fan one CREATE into N edges
            raise SyntaxError(
                f"CREATE endpoint {alias!r} is unbound and carries no "
                f"label or property map to identify existing vertices "
                f"(vertex creation is not supported; DESIGN.md §11)")
        return alias, label, pred

    prev = endpoint(m)
    pos = m.end()
    made_edge = False
    while pos < len(pattern):
        em = _EDGE.match(pattern, pos)
        if not em:
            break
        if em.group("var") is not None:
            raise SyntaxError(
                f"CREATE cannot use a var-length relationship: {pattern!r}")
        raw_label = em.group("label")
        if raw_label is None:
            raise SyntaxError(f"CREATE edge needs a label: {pattern!r}")
        e_label = EDGE_NAMES.get(raw_label)
        if e_label is None:
            raise SyntaxError(f"unknown edge label {raw_label!r}; known: "
                              f"{sorted(EDGE_NAMES)}")
        props = _props_to_items(em.group("props"))
        pos = em.end()
        nm = _NODE.match(pattern, pos)
        if not nm:
            raise SyntaxError(f"expected node after CREATE edge at "
                              f"{pattern[pos:]!r}")
        cur = endpoint(nm)
        pos = nm.end()
        # `<-[:R]-` points the edge at prev; `-[:R]->` at cur
        (s_alias, s_label, s_pred), (d_alias, d_label, d_pred) = \
            ((cur, prev) if em.group("l") else (prev, cur))
        ops.append(InsertEdge(
            src=s_alias, dst=d_alias, edge_label=e_label, props=props,
            src_label=s_label, src_pred=s_pred,
            dst_label=d_label, dst_pred=d_pred))
        made_edge = True
        prev = cur
    if not made_edge:
        raise SyntaxError(
            "CREATE without an edge pattern is not supported (the store "
            "has no vertex allocation; see DESIGN.md §11)")
    return ops


_SET_ITEM = re.compile(r"(?P<alias>\w+)\.(?P<prop>\w+)\s*=\s*(?P<value>.+)$")


def _parse_set(body: str, seen: set) -> List:
    """``SET a.credits = $c, a.flag = 1`` → SetProp ops. The alias must
    be bound by the MATCH/CALL prefix — an unbound alias would silently
    update every vertex (a typo'd alias zeroing a whole column), so it is
    rejected; a deliberate whole-column backfill is ``MATCH (a) SET
    a.x = v`` (DESIGN.md §11)."""
    ops: List = []
    for item in body.split(","):
        m = _SET_ITEM.match(item.strip())
        if not m:
            raise SyntaxError(f"bad SET item {item!r}; expected "
                              f"alias.prop = <expr>")
        if m.group("alias") not in seen:
            raise SyntaxError(
                f"SET alias {m.group('alias')!r} is not bound by the "
                f"MATCH/CALL prefix (bound: {sorted(seen) or 'none'})")
        ops.append(SetProp(alias=m.group("alias"), prop=m.group("prop"),
                           value=parse_expr(m.group("value"))))
    return ops


# clause keywords split the query; the lookbehinds keep property accesses
# (`a.limit`) and parameters (`$set`) from being mistaken for clauses
_CLAUSE = re.compile(
    r"(?<![.$])\b(CALL|CREATE|MATCH|WHERE|WITH|RETURN|ORDER BY|LIMIT|SET)\b",
    re.I)

_CALL_BODY = re.compile(
    r"^(?P<name>[A-Za-z_][\w.]*)\s*\((?P<args>[^)]*)\)"
    r"(?:\s+YIELD\s+(?P<yields>.+))?$", re.I)


def _parse_call(body: str) -> ProcedureCall:
    """``algo.pagerank($d) YIELD v, rank`` → ProcedureCall. Args are full
    expressions (literals or ``$param``); YIELD defaults to
    ``v, <algorithm's result name>`` when omitted."""
    from repro_torch.engines.procedures import RESULT_NAMES, normalize_proc_name

    m = _CALL_BODY.match(body.strip())
    if not m:
        raise SyntaxError(f"bad CALL clause: {body!r}")
    name = normalize_proc_name(m.group("name"))
    raw_args = m.group("args").strip()
    args = tuple(parse_expr(a.strip())
                 for a in raw_args.split(",")) if raw_args else ()
    if m.group("yields"):
        yields = tuple(y.strip() for y in m.group("yields").split(","))
        if len(yields) != 2:
            raise SyntaxError(
                f"CALL must YIELD exactly (vertex, score), got {yields}")
    else:
        yields = ("v", RESULT_NAMES[name])
    return ProcedureCall(proc=name, args=args, yields=yields)


def parse_cypher(query: str) -> LogicalPlan:
    query = re.sub(r"/\*.*?\*/", "", query, flags=re.S)
    query = " ".join(query.split())
    # split into clauses
    parts = []
    idx = [(m.start(), m.group().upper()) for m in _CLAUSE.finditer(query)]
    for i, (start, name) in enumerate(idx):
        end = idx[i + 1][0] if i + 1 < len(idx) else len(query)
        body = query[start + len(name):end].strip()
        parts.append((name, body))

    ops: List = []
    seen: set = set()
    anon = [0]
    for name, body in parts:
        if name == "CALL":
            call = _parse_call(body)
            ops.append(call)
            seen.update(call.yields)     # YIELDed names are bound columns
        elif name == "MATCH":
            for pattern in _split_patterns(body):
                ops.extend(_parse_pattern(pattern, seen, anon))
        elif name == "CREATE":
            for pattern in _split_patterns(body):
                ops.extend(_parse_create(pattern, seen, anon))
        elif name == "SET":
            ops.extend(_parse_set(body, seen))
        elif name == "WHERE":
            ops.append(Select(Pred(parse_expr(body))))
        elif name == "WITH":
            keys: List[str] = []
            aggs: List[Agg] = []
            for item in body.split(","):
                item = item.strip()
                am = re.match(r"(COUNT|SUM|MIN|MAX|AVG)\s*\(\s*([\w\.\*]+)\s*\)"
                              r"\s+AS\s+(\w+)", item, re.I)
                if am:
                    fn = am.group(1).lower()
                    target = am.group(2)
                    expr = None if target == "*" else parse_expr(target)
                    aggs.append(Agg(fn, expr, am.group(3)))
                else:
                    keys.append(item)
            ops.append(With(tuple(keys), tuple(aggs)))
            seen |= {a.name for a in aggs}
        elif name == "RETURN":
            items = []
            for item in body.split(","):
                item = item.strip()
                am = re.match(r"(.+?)\s+AS\s+(\w+)$", item, re.I)
                if am:
                    items.append((parse_expr(am.group(1)), am.group(2)))
                else:
                    items.append((parse_expr(item), item.replace(".", "_")))
            ops.append(Project(tuple(items)))
        elif name == "ORDER BY":
            desc = bool(re.search(r"\bDESC\b", body, re.I))
            key = re.sub(r"\b(ASC|DESC)\b", "", body, flags=re.I).strip()
            ops.append(OrderBy(key.replace(".", "_"), desc))
        elif name == "LIMIT":
            ops.append(Limit(int(body)))
    return LogicalPlan(ops)


def _split_patterns(body: str) -> List[str]:
    """Split comma-separated patterns (commas inside () or {} don't count)."""
    out, depth, cur = [], 0, []
    for ch in body:
        if ch in "({[":
            depth += 1
        elif ch in ")}]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


# ----------------------------------------------------------------- Gremlin
# one nesting level in the args so ``repeat(out('KNOWS'))`` parses as a step
_GREMLIN_STEP = re.compile(r"\.(\w+)\(((?:[^()]|\([^()]*\))*)\)")
_REPEAT_BODY = re.compile(
    r"^(out|in_|in|both)\(\s*(?:'([^']*)'|\"([^\"]*)\")?\s*\)$")


def parse_gremlin(query: str) -> LogicalPlan:
    """g.V().hasLabel('X').has('p', v).out('E').in_('E').values('p')…

    The source step is either ``g.V()`` or the procedure bridge
    ``g.call('algo.pagerank', $d)`` (GIE's CALL in Gremlin clothing): the
    call yields every vertex as ``v0`` plus the algorithm's score column
    (e.g. ``rank``), which later ``where('rank > $t')`` / ``order_by`` /
    ``values`` steps consume like any traversal column."""
    query = query.strip()
    if not query.startswith("g."):
        raise SyntaxError("gremlin query must start with g.V() or g.call()")
    rest = query[1:]
    steps = list(_GREMLIN_STEP.finditer(rest))
    # steps must tile the query (whitespace between them is fine); anything
    # else is a silent-drop hazard, so reject with the exact leftover text
    pos = 0
    for m in steps:
        if rest[pos:m.start()].strip():
            raise SyntaxError(
                f"unparsed gremlin segment: {rest[pos:m.start()]!r}")
        pos = m.end()
    if rest[pos:].strip():
        raise SyntaxError(f"unparsed gremlin trailer: {rest[pos:]!r}")
    if not steps or steps[0].group(1) not in ("V", "call"):
        raise SyntaxError("gremlin query must start with g.V() or g.call()")
    ops: List = []
    anon = [0]
    cur_alias = "v0"
    head, head_args = steps[0].group(1), steps[0].group(2)
    if head == "V":
        if head_args.strip():
            raise SyntaxError("g.V(ids) is not supported")
        ops.append(Scan(cur_alias, None, None))
    else:
        from repro_torch.engines.procedures import RESULT_NAMES, normalize_proc_name

        raw = [a.strip() for a in head_args.split(",")] \
            if head_args.strip() else []
        if not raw:
            raise SyntaxError("g.call() needs an algorithm name")
        name = normalize_proc_name(raw[0].strip("'\""))
        args = tuple(parse_expr(a) for a in raw[1:])
        ops.append(ProcedureCall(proc=name, args=args,
                                 yields=(cur_alias, RESULT_NAMES[name])))
    n_v = 0
    pending_repeat = None      # (direction, edge_label) awaiting .times(n)
    emit_before = emit_after = False
    for m in steps[1:]:
        step, rawargs = m.group(1), m.group(2)
        args = [a.strip().strip("'\"") for a in rawargs.split(",")] \
            if rawargs.strip() else []
        if step == "hasLabel":
            label = LABEL_NAMES[args[0]]
            ops.append(Select(Pred(BinExpr(
                "==", PropRef(cur_alias, "__label__"), Const(label)))))
        elif step == "has":
            prop, value = args[0], args[1]
            if isinstance(value, str) and value.startswith("$"):
                value = Param(value[1:])
            else:
                try:
                    value = Const(float(value) if "." in value
                                  else int(value))
                except ValueError:
                    value = Const(value)
            ops.append(Select(Pred(BinExpr(
                "==", PropRef(cur_alias, prop), value))))
        elif step in ("out", "in_", "in", "both"):
            direction = "out" if step == "out" else "in"
            elabel = EDGE_NAMES.get(args[0]) if args else None
            anon[0] += 1
            e_alias = f"_e{anon[0]}"
            n_v += 1
            new_alias = f"v{n_v}"
            ops.append(Expand(src=cur_alias, edge_label=elabel,
                              direction=direction, edge=e_alias))
            ops.append(GetVertex(edge=e_alias, alias=new_alias))
            cur_alias = new_alias
        elif step == "repeat":
            # repeat(out('KNOWS')).times(3): var-length expansion — with
            # .emit() the intermediate depths are kept too (walk semantics,
            # DESIGN.md §13)
            if pending_repeat is not None:
                raise SyntaxError("repeat() without a closing times()")
            im = _REPEAT_BODY.match(rawargs.strip())
            if not im:
                raise SyntaxError(
                    f"repeat() supports a single out/in_/both traversal "
                    f"step, got {rawargs!r}")
            rlabel = im.group(2) or im.group(3)
            pending_repeat = ("out" if im.group(1) == "out" else "in",
                              EDGE_NAMES.get(rlabel) if rlabel else None)
        elif step == "emit":
            if rawargs.strip():
                raise SyntaxError("emit() takes no arguments")
            if pending_repeat is not None:
                emit_after = True        # .repeat().emit(): depths 1..n
            elif (ops and isinstance(ops[-1], ExpandVar)
                    and ops[-1].alias == cur_alias):
                # .repeat().times(n).emit(): also depths 1..n — rewrite the
                # just-closed expansion (min() keeps an earlier depth-0 emit)
                import dataclasses as _dc
                ops[-1] = _dc.replace(ops[-1],
                                      min_hops=min(ops[-1].min_hops, 1))
            else:
                emit_before = True       # .emit().repeat(): include depth 0
        elif step == "times":
            if pending_repeat is None:
                raise SyntaxError("times() without a preceding repeat()")
            try:
                n = int(rawargs.strip())
            except ValueError:
                raise SyntaxError(f"times() needs an integer, got "
                                  f"{rawargs!r}") from None
            if not 1 <= n <= MAX_VAR_HOPS:
                raise SyntaxError(f"times({n}) out of range [1, "
                                  f"{MAX_VAR_HOPS}]")
            lo = 0 if emit_before else (1 if emit_after else n)
            n_v += 1
            new_alias = f"v{n_v}"
            ops.append(ExpandVar(src=cur_alias, alias=new_alias,
                                 edge_label=pending_repeat[1],
                                 direction=pending_repeat[0],
                                 min_hops=lo, max_hops=n))
            cur_alias = new_alias
            pending_repeat = None
            emit_before = emit_after = False
        elif step == "values":
            ops.append(Project(((PropRef(cur_alias, args[0]), args[0]),)))
        elif step == "count":
            ops.append(With((), (Agg("count", None, "count"),)))
        elif step == "limit":
            ops.append(Limit(int(args[0])))
        elif step == "where":
            # where('rank > $t'): a full predicate expression over columns
            # (CALL score columns, aliases) and vertex properties
            ops.append(Select(Pred(parse_expr(rawargs.strip().strip("'\"")))))
        elif step == "order_by":
            desc = len(args) > 1 and args[1].lower() == "desc"
            ops.append(OrderBy(args[0].replace(".", "_"), desc))
        elif step == "add_e":
            # add_e('KNOWS', <dst>, [prop, value, ...]): append an edge
            # from every frontier vertex to the vertex whose internal id
            # the second argument evaluates to (DESIGN.md §11)
            raw = [p.strip() for p in rawargs.split(",")]
            if len(raw) < 2:
                raise SyntaxError("add_e needs (edge_label, dst_id)")
            label_name = raw[0].strip("'\"")
            if label_name not in EDGE_NAMES:
                raise SyntaxError(f"unknown edge label {label_name!r}; "
                                  f"known: {sorted(EDGE_NAMES)}")
            if len(raw[2:]) % 2:
                raise SyntaxError("add_e property args must be "
                                  "(name, value) pairs")
            props = tuple((raw[j].strip("'\""), parse_expr(raw[j + 1]))
                          for j in range(2, len(raw), 2))
            anon[0] += 1
            d_alias = f"_w{anon[0]}"
            ops.append(InsertEdge(
                src=cur_alias, dst=d_alias,
                edge_label=EDGE_NAMES[label_name], props=props,
                dst_pred=Pred(BinExpr("==", PropRef(d_alias, None),
                                      parse_expr(raw[1])))))
        elif step == "property":
            # property('credits', <expr>): set a vertex property on every
            # frontier vertex (DESIGN.md §11)
            raw = [p.strip() for p in rawargs.split(",")]
            if len(raw) != 2:
                raise SyntaxError("property needs (name, value)")
            ops.append(SetProp(alias=cur_alias, prop=raw[0].strip("'\""),
                               value=parse_expr(raw[1])))
        else:
            raise SyntaxError(f"unsupported gremlin step {step}")
    if pending_repeat is not None:
        raise SyntaxError("repeat() without a closing times()")
    if emit_before:
        raise SyntaxError("emit() without a repeat()/times() pair")
    return LogicalPlan(ops)
