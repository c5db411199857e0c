"""GraphIR — the unified intermediate representation (paper §5.1).

A query (Cypher or Gremlin) parses into a *logical plan*: a chain of graph
operators (SCAN, EXPAND_EDGE, GET_VERTEX) and relational operators (SELECT,
PROJECT, ORDER, GROUP, LIMIT) over the IR data model D: rows of named
columns whose types are vertices, edges (by id) or primitives.

The physical stage (after RBO/CBO) may contain the fused ExpandVertex
operator (EdgeVertexFusion) and predicates pushed into scans/expands
(FilterPushIntoMatch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


# --------------------------------------------------------------- expressions
@dataclasses.dataclass(frozen=True)
class PropRef:
    alias: str          # column (vertex or edge alias)
    prop: Optional[str]  # None = the id itself

    def refs(self):
        return {self.alias}


@dataclasses.dataclass(frozen=True)
class Const:
    value: Any

    def refs(self):
        return set()


@dataclasses.dataclass(frozen=True)
class Param:
    """An unbound ``$name`` placeholder (parameterized query / stored
    procedure). A dedicated node — not a ``Const`` string convention — so
    genuine string literals that happen to start with ``$`` are never
    mistaken for parameters."""

    name: str

    def refs(self):
        return set()


@dataclasses.dataclass(frozen=True)
class BinExpr:
    op: str             # + - * / == != < <= > >= in and or
    left: Union["BinExpr", PropRef, Const, Param]
    right: Union["BinExpr", PropRef, Const, Param]

    def refs(self):
        return self.left.refs() | self.right.refs()


Expr = Union[BinExpr, PropRef, Const, Param]


@dataclasses.dataclass(frozen=True)
class Pred:
    """A (possibly compound) boolean expression."""

    expr: Expr

    def refs(self):
        return self.expr.refs()


# ------------------------------------------------------------------ operators
@dataclasses.dataclass(frozen=True)
class Scan:
    alias: str
    label: Optional[int] = None
    pred: Optional[Pred] = None          # pushed-down vertex predicate


@dataclasses.dataclass(frozen=True)
class Expand:
    """EXPAND_EDGE: from ``src`` along ``edge_label``; edge alias ``edge``."""

    src: str
    edge_label: Optional[int]
    direction: str = "out"               # out|in
    edge: Optional[str] = None
    pred: Optional[Pred] = None          # pushed-down edge predicate
    fused_vertex: Optional[str] = None   # set by EdgeVertexFusion
    vertex_label: Optional[int] = None   # label filter on the fused vertex
    vertex_pred: Optional[Pred] = None


# Hard cap on var-length / shortestPath upper bounds: the fragment lowering
# unrolls hops into the jitted program, so an unbounded (or huge) range would
# compile without bound. Parsers and plan validation reject anything above it.
MAX_VAR_HOPS = 32


@dataclasses.dataclass(frozen=True)
class ExpandVar:
    """Variable-length expansion ``(src)-[:label*min..max]->(alias)`` —
    *walk* semantics: edges (and vertices) may repeat, one output row per
    distinct walk, so row multiplicity is the walk count. ``min_hops == 0``
    contributes the source row itself (alias = src). Intermediate vertices
    are unconstrained; ``vertex_label``/``vertex_pred`` filter only the
    final endpoint. The upper bound is mandatory and capped at
    ``MAX_VAR_HOPS`` (the lowering unrolls it)."""

    src: str
    alias: str
    edge_label: Optional[int]
    direction: str = "out"               # out|in
    min_hops: int = 1
    max_hops: int = 1
    vertex_label: Optional[int] = None
    vertex_pred: Optional[Pred] = None


@dataclasses.dataclass(frozen=True)
class ShortestPath:
    """``shortestPath((src)-[:label*..max]->(alias))`` — per source row,
    one output row for every reachable ``alias`` vertex, with the walk
    length bound to column ``dist``. ``min_hops`` ∈ {0, 1}: 0 includes the
    trivial zero-length path (alias = src, dist 0); 1 answers src→src only
    via an actual cycle. Runs as a min-plus (tropical) relaxation of the
    same frontier hop, so like ExpandVar the bound is mandatory and capped
    at ``MAX_VAR_HOPS``."""

    src: str
    alias: str
    edge_label: Optional[int]
    direction: str = "out"               # out|in
    min_hops: int = 1
    max_hops: int = 1
    dist: str = "dist"
    vertex_label: Optional[int] = None
    vertex_pred: Optional[Pred] = None


@dataclasses.dataclass(frozen=True)
class GetVertex:
    """Materialize the head vertex of the edge produced by prior Expand."""

    edge: str
    alias: str
    label: Optional[int] = None
    pred: Optional[Pred] = None


@dataclasses.dataclass(frozen=True)
class Select:
    pred: Pred


@dataclasses.dataclass(frozen=True)
class Project:
    items: Tuple[Tuple[Expr, str], ...]   # (expr, out name)


@dataclasses.dataclass(frozen=True)
class Agg:
    fn: str                               # count|sum|min|max|avg
    expr: Optional[Expr]                  # None for count(*)
    name: str


@dataclasses.dataclass(frozen=True)
class With:
    """Group by ``keys`` computing ``aggs`` (Cypher WITH ... , COUNT(..))."""

    keys: Tuple[str, ...]                 # aliases kept as group keys
    aggs: Tuple[Agg, ...]


@dataclasses.dataclass(frozen=True)
class GroupCount:
    key: Expr
    name: str = "count"


@dataclasses.dataclass(frozen=True)
class ProcedureCall:
    """``CALL algo.<proc>(args…) YIELD v, score`` — the query↔analytics
    bridge (DESIGN.md §7). Executes a GRAPE-backed built-in algorithm and
    sources the row table from its result: ``yields[0]`` becomes a vertex
    alias covering every vertex, ``yields[1]`` both a row column and a
    temporary vertex property holding the per-vertex score, so the rest of
    the plan (MATCH / WHERE / ORDER BY) composes over computed analytics.

    ``args`` are ordinary expressions, so ``$param`` placeholders inside
    CALL survive optimization and bind per request like any other plan
    parameter."""

    proc: str                            # algorithm name (namespace stripped)
    args: Tuple[Expr, ...] = ()
    yields: Tuple[str, ...] = ()         # (vertex alias, score column)


# ------------------------------------------------------------ mutation IR
@dataclasses.dataclass(frozen=True)
class InsertEdge:
    """``CREATE (a)-[:R {p: $x}]->(b)`` / gremlin ``add_e`` — append edges
    to a mutable store (DESIGN.md §11). Endpoints are vertex *aliases*:
    bound by the plan's MATCH prefix (row-aligned inserts, one edge per
    surviving row), or self-resolving via ``*_label``/``*_pred`` when the
    alias is unbound (the CREATE pattern's own label / property map
    identifies existing vertices — the stack has no vertex allocation).

    ``props`` values and the endpoint predicates are ordinary expressions,
    so ``$param`` placeholders bind per request through the plan cache
    exactly like read plans. The optimizers treat mutations as opaque
    sinks: RBO never fuses/pushes across them, CBO keeps them in the
    relational tail, and the serving router sends any plan containing one
    down the ``write`` path before the read-route predicates ever run."""

    src: str
    dst: str
    edge_label: int
    props: Tuple[Tuple[str, Expr], ...] = ()
    src_label: Optional[int] = None      # unbound-endpoint resolution
    src_pred: Optional[Pred] = None
    dst_label: Optional[int] = None
    dst_pred: Optional[Pred] = None


@dataclasses.dataclass(frozen=True)
class SetProp:
    """``SET a.prop = <expr>`` / gremlin ``property`` — update (or create)
    a vertex property column on a mutable store (DESIGN.md §11). ``alias``
    rows come from the bound MATCH prefix, or resolve via ``label``/
    ``pred`` when unbound. ``value`` is any expression over the prefix
    columns (``$params``, other aliases' properties, WITH aggregates)."""

    alias: str
    prop: str
    value: Expr
    label: Optional[int] = None          # unbound-alias resolution
    pred: Optional[Pred] = None


MUTATION_OPS = (InsertEdge, SetProp)


def plan_is_write(plan: "LogicalPlan") -> bool:
    """True when the plan contains any mutation operator — such plans only
    execute through the serving layer's ``write`` route (DESIGN.md §11)."""
    return any(isinstance(op, MUTATION_OPS) for op in plan.ops)


@dataclasses.dataclass(frozen=True)
class OrderBy:
    key: str
    desc: bool = False


@dataclasses.dataclass(frozen=True)
class Limit:
    n: int


Op = Union[Scan, Expand, ExpandVar, ShortestPath, GetVertex, Select, Project,
           With, GroupCount, ProcedureCall, InsertEdge, SetProp, OrderBy,
           Limit]


@dataclasses.dataclass
class LogicalPlan:
    ops: List[Op]

    def __iter__(self):
        return iter(self.ops)

    def pretty(self) -> str:
        return "\n".join(f"  {i}: {op}" for i, op in enumerate(self.ops))

    # ------------------------------------------------- parameterized queries
    def param_names(self) -> set:
        """Names of unbound ``$param`` placeholders anywhere in the plan."""
        out: set = set()

        def collect(e):
            _collect_expr(e, out)
            return e

        for op in self.ops:
            map_op_exprs(op, collect)
        return out

    def bind(self, params: Optional[Dict[str, Any]]) -> "LogicalPlan":
        """Substitute ``$name`` placeholders with ``params['name']`` values.

        Binding happens *after* RBO/CBO, so an optimized plan compiled once
        can be re-bound for every request (the serving-layer plan cache).
        Raises ``KeyError`` if any placeholder is left unbound.
        """
        missing = self.param_names() - set(params or {})
        if missing:
            raise KeyError(f"unbound parameters: {sorted(missing)}")
        if not params:
            return self
        return LogicalPlan([bind_op(op, params) for op in self.ops])


# ------------------------------------------------------- parameter binding
def bind_expr(expr: Expr, params: Dict[str, Any]) -> Expr:
    """Replace Param placeholders; returns ``expr`` itself when nothing
    changed (so callers can cheaply detect no-op binds)."""
    if isinstance(expr, Param):
        return Const(params[expr.name])
    if isinstance(expr, BinExpr):
        l = bind_expr(expr.left, params)
        r = bind_expr(expr.right, params)
        if l is expr.left and r is expr.right:
            return expr
        return BinExpr(expr.op, l, r)
    return expr


def _map_value(v, fn):
    """Apply ``fn`` to every expression nested in one field value
    (identity-preserving so callers can detect no-op rewrites)."""
    if isinstance(v, Pred):
        e = fn(v.expr)
        return v if e is v.expr else Pred(e)
    if isinstance(v, (BinExpr, PropRef, Const, Param)):
        return fn(v)
    if isinstance(v, Agg):
        if v.expr is None:
            return v
        e = fn(v.expr)
        return v if e is v.expr else Agg(v.fn, e, v.name)
    if isinstance(v, tuple):
        items = tuple(_map_value(x, fn) for x in v)
        return v if all(a is b for a, b in zip(items, v)) else items
    return v


def map_op_exprs(op: Op, fn) -> Op:
    """Rebuild ``op`` with ``fn`` applied to every expression-bearing
    field — the single traversal under parameter binding, collection, and
    HiActor's per-row column rewrite. Returns ``op`` itself when nothing
    changed."""
    changes = {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        nv = _map_value(v, fn)
        if nv is not v:
            changes[f.name] = nv
    return dataclasses.replace(op, **changes) if changes else op


def bind_op(op: Op, params: Dict[str, Any]) -> Op:
    """Bind every expression-bearing field of one operator."""
    return map_op_exprs(op, lambda e: bind_expr(e, params))


def _collect_expr(e, out: set):
    if isinstance(e, Param):
        out.add(e.name)
    elif isinstance(e, BinExpr):
        _collect_expr(e.left, out)
        _collect_expr(e.right, out)


# -------------------------------------------------------------- evaluation
import numpy as np  # noqa: E402


def eval_expr(expr: Expr, columns: Dict[str, np.ndarray],
              pg, edge_cols: Dict[str, np.ndarray]) -> np.ndarray:
    """Evaluate an expression over the row table. ``columns`` maps vertex
    aliases → vertex ids; ``edge_cols`` maps edge aliases → edge ids."""
    if isinstance(expr, Const):
        return expr.value
    if isinstance(expr, Param):
        raise ValueError(f"unbound parameter ${expr.name}: call "
                         f"LogicalPlan.bind(params) before execution")
    if isinstance(expr, PropRef):
        if expr.alias in edge_cols:
            eids = edge_cols[expr.alias]
            if expr.prop is None:
                return eids
            return pg.eprop(expr.prop)[eids]
        ids = columns[expr.alias]
        if expr.prop is None:
            return ids
        return pg.vprop(expr.prop)[ids]
    if isinstance(expr, BinExpr):
        l = eval_expr(expr.left, columns, pg, edge_cols)
        r = eval_expr(expr.right, columns, pg, edge_cols)
        op = expr.op
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "==":
            return l == r
        if op == "!=":
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "in":
            return np.isin(l, r)
        if op == "and":
            return np.logical_and(l, r)
        if op == "or":
            return np.logical_or(l, r)
        raise ValueError(f"unknown op {op}")
    raise TypeError(type(expr))
