"""Code generation: physical GraphIR DAG → executable operator pipeline
(paper §5.3). The same physical plan compiles to either engine:

- **Gaia** (OLAP): each operator is a vectorized dataflow stage over a row
  table (SOURCE/FLATMAP/MAP in the paper's mapping);
- **HiActor** (OLTP): the plan becomes a *stored procedure* parameterized by
  query arguments; many concurrent queries are batched into one table with
  a ``__qid__`` column and executed in a single pass (TPU adaptation of
  actor-level concurrency — see DESIGN.md §2);
- **fragment frontier** (OLAP, distributed): ``lower_to_frontier`` compiles
  the plan's match prefix (Scan → Expand* → head-only WHEREs) into dense
  frontier stages over the GRAPE fragment substrate — multi-source
  frontiers as ``[B, N]`` path-count matrices so a whole admission batch
  executes as one device program; ``finish_frontier`` hands the
  materialized (much smaller) row table back to the interpreter for the
  relational tail, which stays the semantic oracle (DESIGN.md §9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir.dag import (Agg, BinExpr, Const, Expand, ExpandVar,
                               GetVertex, GroupCount, Limit, LogicalPlan,
                               OrderBy, Param, Pred, ProcedureCall, Project,
                               Scan, Select, ShortestPath, With, bind_expr,
                               eval_expr)


@dataclasses.dataclass
class Table:
    """Row-aligned columns: vertex aliases → ids, edge aliases → edge ids,
    computed names → values."""

    columns: Dict[str, np.ndarray]
    edge_cols: Dict[str, np.ndarray]

    @property
    def n_rows(self) -> int:
        for c in self.columns.values():
            return len(c)
        for c in self.edge_cols.values():
            return len(c)
        return 0

    def gather(self, rows: np.ndarray) -> "Table":
        return Table({k: v[rows] for k, v in self.columns.items()},
                     {k: v[rows] for k, v in self.edge_cols.items()})

    def mask(self, m: np.ndarray) -> "Table":
        return Table({k: v[m] for k, v in self.columns.items()},
                     {k: v[m] for k, v in self.edge_cols.items()})


def _eval_pred(pred: Pred, table: Table, pg) -> np.ndarray:
    return np.asarray(
        eval_expr(pred.expr, _cols_with_labels(table, pg), pg,
                  table.edge_cols), dtype=bool)


def _cols_with_labels(table: Table, pg):
    """Expose __label__ pseudo-property lookups (used by gremlin hasLabel)."""
    return table.columns


class _LabelAwarePG:
    """Wraps PropertyGraph so PropRef(alias, '__label__') resolves."""

    def __init__(self, pg):
        self._pg = pg

    def vprop(self, name):
        if name == "__label__":
            return self._pg.vlabels
        return self._pg.vprop(name)

    def eprop(self, name):
        if name == "__label__":
            return self._pg.elabels
        return self._pg.eprop(name)

    def __getattr__(self, item):
        return getattr(self._pg, item)


def execute_plan(plan: LogicalPlan, pg, *,
                 params: Optional[Dict[str, Any]] = None,
                 table: Optional[Table] = None,
                 procedures=None) -> Dict[str, np.ndarray]:
    """Run a (physical) plan over a PropertyGraph. ``params`` substitutes
    Const placeholders of the form ``$name`` (stored procedures);
    ``procedures`` is the :class:`ProcedureRegistry` consulted by
    ``CALL algo.*`` plans (DESIGN.md §7)."""
    pg = _LabelAwarePG(pg)
    out: Dict[str, np.ndarray] = {}
    for op in plan.ops:
        op = _bind_params(op, params)
        if isinstance(op, ProcedureCall):
            table = _run_procedure(op, pg, procedures, table)
        elif isinstance(op, Scan):
            ids = pg.vertices(op.label)
            t = Table({op.alias: ids}, {})
            if table is not None and table.n_rows:
                # cartesian with existing rows is not supported; scans after
                # the first must be correlated via later Select
                raise NotImplementedError("multiple uncorrelated scans")
            if op.pred is not None:
                t = t.mask(_eval_pred(op.pred, t, pg))
            table = t
        elif isinstance(op, Expand):
            src_ids = table.columns[op.src]
            tails, heads, eids = pg.expand(
                src_ids, op.edge_label, op.direction)
            table = table.gather(tails)
            if op.edge is not None:
                table.edge_cols[op.edge] = eids
            if op.fused_vertex is not None:
                table.columns[op.fused_vertex] = heads
                if op.vertex_label is not None:
                    table = table.mask(
                        pg.vlabels[table.columns[op.fused_vertex]]
                        == op.vertex_label)
                if op.vertex_pred is not None:
                    table = table.mask(_eval_pred(op.vertex_pred, table, pg))
            else:
                table.columns["__head__" + (op.edge or "")] = heads
            if op.pred is not None:
                table = table.mask(_eval_pred(op.pred, table, pg))
        elif isinstance(op, ExpandVar):
            table = _expand_var(op, table, pg)
        elif isinstance(op, ShortestPath):
            table = _shortest_paths(op, table, pg)
        elif isinstance(op, GetVertex):
            heads = table.columns.pop("__head__" + op.edge)
            table.columns[op.alias] = heads
            if op.label is not None:
                table = table.mask(pg.vlabels[table.columns[op.alias]]
                                   == op.label)
            if op.pred is not None:
                table = table.mask(_eval_pred(op.pred, table, pg))
        elif isinstance(op, Select):
            table = table.mask(_eval_pred(op.pred, table, pg))
        elif isinstance(op, With):
            table = _group(op, table, pg)
        elif isinstance(op, Project):
            for expr, name in op.items:
                out[name] = np.asarray(
                    eval_expr(expr, table.columns, pg, table.edge_cols))
            continue
        elif isinstance(op, OrderBy):
            key = out.get(op.key)
            if key is None:
                key = table.columns[op.key]
            order = np.argsort(key, kind="stable")
            if op.desc:
                order = order[::-1]
            if out:
                out = {k: v[order] for k, v in out.items()}
            else:
                table = table.gather(order)
        elif isinstance(op, Limit):
            if out:
                out = {k: v[:op.n] for k, v in out.items()}
            else:
                table = table.gather(np.arange(min(op.n, table.n_rows)))
        elif isinstance(op, GroupCount):
            key = np.asarray(eval_expr(op.key, table.columns, pg,
                                       table.edge_cols))
            uniq, counts = np.unique(key, return_counts=True)
            out["key"] = uniq
            out[op.name] = counts
        else:
            from repro_torch.core.ir.dag import MUTATION_OPS
            if isinstance(op, MUTATION_OPS):
                raise NotImplementedError(
                    f"{type(op).__name__} is a mutation: write plans "
                    f"execute through the serving layer's write route "
                    f"(FlexSession.interactive(), DESIGN.md §11), not the "
                    f"read-only interpreter")
            raise NotImplementedError(op)
    if not out and table is not None:
        out = dict(table.columns)
    return out


def _run_procedure(op: ProcedureCall, pg, procedures,
                   table: Optional[Table]) -> Table:
    """CALL algo.* — run the GRAPE-backed procedure and source the row
    table from its result: every vertex under the yielded alias, the score
    both as a row column (`WHERE rank > $t`, `ORDER BY rank`) and as a
    temporary vertex property on the shared facade (`v.rank`,
    gremlin `values('rank')`). See DESIGN.md §7 for the lifetime rules."""
    if procedures is None:
        raise RuntimeError(
            "plan contains CALL but the executing engine has no "
            "ProcedureRegistry attached (pass procedures=…)")
    if table is not None and table.n_rows:
        raise NotImplementedError("CALL must be the source of the plan")
    argvals = []
    for a in op.args:
        if isinstance(a, Param):
            raise ValueError(f"unbound parameter ${a.name} in CALL "
                             f"{op.proc}: bind(params) before execution")
        if not isinstance(a, Const):
            raise ValueError(f"CALL {op.proc} args must be literals or "
                             f"$params, got {a}")
        argvals.append(a.value)
    scores = procedures.run(pg.grin.store, op.proc, tuple(argvals))
    v_alias, score_name = op.yields
    pg.set_temp_vprop(score_name, scores)
    ids = np.arange(pg.n_vertices, dtype=np.int64)
    return Table({v_alias: ids, score_name: np.asarray(scores)}, {})


def _group(op: With, table: Table, pg) -> Table:
    keys = [k for k in op.keys]
    if keys:
        key_cols = [np.asarray(table.columns[k] if k in table.columns
                               else table.edge_cols[k]) for k in keys]
        if all(np.issubdtype(c.dtype, np.integer) for c in key_cols):
            # mixed-radix combined key: one 1-D unique instead of a
            # lexsorted unique(axis=0) over the stacked columns
            combined = key_cols[0].astype(np.int64)
            for c in key_cols[1:]:
                span = int(c.max()) + 1 if len(c) else 1
                combined = combined * span + c.astype(np.int64)
            ukey, first_idx, inverse = np.unique(
                combined, return_index=True, return_inverse=True)
            uniq = np.stack([c[first_idx] for c in key_cols], axis=1)
        else:
            stacked = np.stack(key_cols, axis=1)
            uniq, first_idx, inverse = np.unique(
                stacked, axis=0, return_index=True, return_inverse=True)
        n_groups = len(uniq)
    else:
        inverse = np.zeros(table.n_rows, np.int64)
        n_groups = 1 if table.n_rows else 0
        uniq = None
        first_idx = np.zeros(n_groups, np.int64)
    new_cols: Dict[str, np.ndarray] = {}
    for i, k in enumerate(keys):
        new_cols[k] = uniq[:, i] if uniq is not None else np.zeros(0)
    # '$__name' columns are HiActor's per-row parameter bindings; they are
    # constant within a __qid__ group (always a key on that path), so the
    # group's first row carries them through the aggregation
    for name, col in table.columns.items():
        if name.startswith("$__") and name not in new_cols:
            new_cols[name] = np.asarray(col)[first_idx]
    for agg in op.aggs:
        if agg.fn == "count" and agg.expr is None:
            vals = np.bincount(inverse, minlength=n_groups)
        else:
            col = np.asarray(eval_expr(agg.expr, table.columns, pg,
                                       table.edge_cols), dtype=np.float64)
            if agg.fn == "count":
                vals = np.bincount(inverse, minlength=n_groups)
            elif agg.fn == "sum":
                vals = np.bincount(inverse, weights=col, minlength=n_groups)
            elif agg.fn == "avg":
                s = np.bincount(inverse, weights=col, minlength=n_groups)
                c = np.bincount(inverse, minlength=n_groups)
                vals = s / np.maximum(c, 1)
            elif agg.fn in ("min", "max"):
                fill = np.inf if agg.fn == "min" else -np.inf
                vals = np.full(n_groups, fill)
                fn = np.minimum if agg.fn == "min" else np.maximum
                getattr(np, f"{agg.fn}imum").at(vals, inverse, col)
            else:
                raise NotImplementedError(agg.fn)
        new_cols[agg.name] = vals
    return Table(new_cols, {})


def _expand_var(op: ExpandVar, table: Table, pg) -> Table:
    """Variable-length expansion, walk semantics: one output row per walk
    of length k ∈ [min_hops, max_hops] from each source row (the oracle
    for the powered frontier stages, DESIGN.md §13). ``min_hops == 0``
    contributes the source row itself; intermediate vertices are
    unconstrained; label/pred filter only the final endpoint."""
    src_ids = np.asarray(table.columns[op.src], np.int64)
    rows = np.arange(len(src_ids), dtype=np.int64)
    heads = src_ids
    out_rows: List[np.ndarray] = []
    out_heads: List[np.ndarray] = []
    if op.min_hops == 0:
        out_rows.append(rows)
        out_heads.append(heads)
    for k in range(1, op.max_hops + 1):
        if not len(heads):
            break
        tails, heads, _ = pg.expand(heads, op.edge_label, op.direction)
        rows = rows[tails]
        if k >= op.min_hops:
            out_rows.append(rows)
            out_heads.append(heads)
    all_rows = (np.concatenate(out_rows).astype(np.int64)
                if out_rows else np.zeros(0, np.int64))
    all_heads = (np.concatenate(out_heads).astype(np.int64)
                 if out_heads else np.zeros(0, np.int64))
    new = table.gather(all_rows)
    new.columns[op.alias] = all_heads
    if op.vertex_label is not None:
        new = new.mask(np.asarray(pg.vlabels)[
            np.asarray(new.columns[op.alias], np.int64)] == op.vertex_label)
    if op.vertex_pred is not None:
        new = new.mask(_eval_pred(op.vertex_pred, new, pg))
    return new


def _shortest_paths(op: ShortestPath, table: Table, pg) -> Table:
    """shortestPath() oracle: per source row, a numpy min-plus relaxation
    ``d ← min(d, relax(d))`` over the sliced adjacency — one output row per
    reachable target with the walk length in ``op.dist``. ``min_hops == 1``
    seeds from the first relaxation, so src→src is answered only by an
    actual cycle (DESIGN.md §13)."""
    src_ids = np.asarray(table.columns[op.src], np.int64)
    n = pg.n_vertices
    uniq, inv = np.unique(src_ids, return_inverse=True)
    indptr, indices = pg.sliced_csr(op.edge_label, op.direction)[:2]
    e_src = np.repeat(np.arange(n, dtype=np.int64),
                      np.diff(np.asarray(indptr)))
    e_dst = np.asarray(indices, np.int64)

    def relax(d):
        out = np.full_like(d, np.inf)
        if len(e_src):
            for u in range(len(d)):
                np.minimum.at(out[u], e_dst, d[u, e_src] + 1.0)
        return out

    seed = np.full((len(uniq), n), np.inf)
    if len(uniq):
        seed[np.arange(len(uniq)), uniq] = 0.0
    if op.min_hops == 0:
        d, iters = seed, op.max_hops
    else:
        d, iters = relax(seed), op.max_hops - 1
    for _ in range(max(0, iters)):
        d = np.minimum(d, relax(d))
    vmask = np.ones(n, bool)
    if op.vertex_label is not None:
        vmask &= np.asarray(pg.vlabels) == op.vertex_label
    reach = np.isfinite(d) & vmask[None, :]
    tgt = [np.nonzero(reach[u])[0].astype(np.int64)
           for u in range(len(uniq))]
    dst = [d[u, reach[u]].astype(np.int64) for u in range(len(uniq))]
    counts = np.array([len(t) for t in tgt], np.int64)
    rep = np.repeat(np.arange(len(src_ids), dtype=np.int64),
                    counts[inv] if len(src_ids) else 0)
    new = table.gather(rep)
    if len(src_ids):
        new.columns[op.alias] = np.concatenate(
            [tgt[u] for u in inv]) if len(inv) else np.zeros(0, np.int64)
        new.columns[op.dist] = np.concatenate(
            [dst[u] for u in inv]) if len(inv) else np.zeros(0, np.int64)
    else:
        new.columns[op.alias] = np.zeros(0, np.int64)
        new.columns[op.dist] = np.zeros(0, np.int64)
    if op.vertex_pred is not None:
        new = new.mask(_eval_pred(op.vertex_pred, new, pg))
    return new


def _bind_params(op, params: Optional[Dict[str, Any]]):
    if not params:
        return op
    from repro_torch.core.ir.dag import bind_op
    return bind_op(op, params)


# ===================================================================== #
# Frontier lowering — the fragment-substrate compiler (DESIGN.md §9)    #
# ===================================================================== #

@dataclasses.dataclass(frozen=True)
class FrontierHop:
    """One EXPAND stage lowered to a dense hop: multiply the [B, N]
    path-count matrix by the (edge_label, direction) adjacency, then mask
    by the head vertex's label/predicate."""

    edge_label: Optional[int]
    direction: str                       # out | in
    edge_pred: Optional[Pred]            # refs the edge alias only, no $params
    edge_alias: Optional[str]
    vertex_alias: str
    vertex_label: Optional[int]
    vertex_pred: Optional[Pred]          # refs vertex_alias only ($params ok)
    # var-length ranges (``*min..max``) run the same adjacency min..max
    # times, accumulating ``Σ_{k} X·A^k`` before the head mask applies;
    # a fixed hop is the 1..1 special case (DESIGN.md §13)
    min_hops: int = 1
    max_hops: int = 1

    @property
    def cache_key(self) -> Tuple:
        """Identity of the hop's adjacency arrays (edge preds are baked
        into the edge weights, so they are part of the key)."""
        return (self.edge_label, self.direction, repr(self.edge_pred))

    @property
    def is_var(self) -> bool:
        return (self.min_hops, self.max_hops) != (1, 1)


@dataclasses.dataclass(frozen=True)
class FrontierProgram:
    """A lowered match prefix plus the interpreter tail.

    The prefix executes as dense frontier algebra: ``X₀[b, v] = 1`` for
    every source vertex of query b, each hop is ``X ← (X·A_hop) ⊙ mask``,
    and after the last hop ``X[b, v]`` counts the matched paths of query b
    ending at v. ``finish_frontier`` re-materializes rows (vertex ids
    repeated by path count) and delegates ``tail`` to ``execute_plan`` —
    only the head alias survives, which ``lower_to_frontier`` guarantees is
    the only prefix column the tail reads."""

    source_alias: str
    source_label: Optional[int]
    source_pred: Optional[Pred]
    hops: Tuple[FrontierHop, ...]
    head: str                            # final vertex alias of the prefix
    tail: Tuple[Any, ...]                # ops for the interpreter
    # a shortestPath() prefix instead of count hops: the executor runs a
    # min-plus relaxation and ``finish_shortest`` materializes
    # (source, head, dist) rows — so unlike the counting path the tail may
    # also reference the source alias and the dist column
    shortest: Optional[ShortestPath] = None


def _expr_has_param(e) -> bool:
    if isinstance(e, Param):
        return True
    if isinstance(e, BinExpr):
        return _expr_has_param(e.left) or _expr_has_param(e.right)
    return False


def _conjoin_preds(a: Optional[Pred], b: Optional[Pred]) -> Optional[Pred]:
    if a is None:
        return b
    if b is None:
        return a
    return Pred(BinExpr("and", a.expr, b.expr))


def _op_column_refs(op) -> set:
    """Every row-table column an operator reads: expression refs plus the
    string-typed column fields (Expand.src, GetVertex.edge, With.keys,
    OrderBy.key) that ``Expr.refs()`` cannot see."""
    refs: set = set()

    def collect(e):
        refs.update(e.refs() if hasattr(e, "refs") else set())
        return e

    from repro_torch.core.ir.dag import InsertEdge, SetProp, map_op_exprs
    map_op_exprs(op, collect)
    if isinstance(op, (Expand, ExpandVar, ShortestPath)):
        refs.add(op.src)
    elif isinstance(op, GetVertex):
        refs.add(op.edge)
    elif isinstance(op, With):
        refs.update(op.keys)
    elif isinstance(op, OrderBy):
        refs.add(op.key)
    elif isinstance(op, InsertEdge):
        refs.update({op.src, op.dst})
    elif isinstance(op, SetProp):
        refs.add(op.alias)
    return refs


def _normalize_count_aggs(op):
    """``COUNT(expr)`` counts rows exactly like ``COUNT(*)`` (every row
    binds every column here — there are no NULLs in the IR data model), so
    drop the expression: a count over a consumed prefix alias then needs no
    materialized column."""
    if isinstance(op, With) and any(
            a.fn == "count" and a.expr is not None for a in op.aggs):
        return dataclasses.replace(op, aggs=tuple(
            Agg("count", None, a.name)
            if a.fn == "count" and a.expr is not None else a
            for a in op.aggs))
    return op


def lower_to_frontier(plan: LogicalPlan) -> Optional[FrontierProgram]:
    """Lower the longest supported match prefix to frontier stages, or
    return None when the plan has no fragment-executable prefix.

    Supported prefix ops: an anchoring Scan (predicate on its own alias,
    ``$params`` allowed), fused Expands forming a linear chain (edge
    predicates must reference only the edge alias and carry no ``$params``
    — they bake into static edge weights; head predicates may carry
    ``$params`` — they become per-query masks), and Selects on the current
    head. Everything after the prefix runs on the interpreter over the
    materialized table, so the tail must reference no prefix alias other
    than the head, define no new Scan, and must exist whenever the prefix
    binds more than one alias (the interpreter's implicit all-columns
    result cannot be reproduced from a path-count matrix).

    A tail that references the *anchor* instead of the head (e.g. the CBO
    flipped the chain and the WITH groups by the original source) lowers
    via the reversed chain: path-count multisets are direction-invariant,
    so executing the flipped physical chain yields identical results with
    the referenced alias as the head."""
    prog = _lower_chain(list(plan.ops))
    if prog is not None:
        return prog
    from repro_torch.core.ir.cbo import _chain_segments, _reverse_chain
    chain, tail = _chain_segments(plan)
    if not chain or not isinstance(chain[0], Scan):
        return None
    rev = _reverse_chain(chain)
    if rev is None:
        return None
    return _lower_chain(list(rev) + list(tail))


def _lower_chain(ops: List) -> Optional[FrontierProgram]:
    if not ops or not isinstance(ops[0], Scan):
        return None
    scan = ops[0]
    if scan.pred is not None and not scan.pred.refs() <= {scan.alias}:
        return None
    source_pred = scan.pred
    hops: List[FrontierHop] = []
    shortest: Optional[ShortestPath] = None
    head = scan.alias
    i = 1
    while i < len(ops):
        op = ops[i]
        if isinstance(op, ExpandVar):
            if (shortest is not None or op.src != head
                    or op.direction not in ("out", "in")):
                break
            if op.vertex_pred is not None and \
                    not op.vertex_pred.refs() <= {op.alias}:
                break
            hops.append(FrontierHop(
                edge_label=op.edge_label, direction=op.direction,
                edge_pred=None, edge_alias=None, vertex_alias=op.alias,
                vertex_label=op.vertex_label, vertex_pred=op.vertex_pred,
                min_hops=op.min_hops, max_hops=op.max_hops))
            head = op.alias
            i += 1
        elif isinstance(op, ShortestPath):
            # only as the sole expansion: sources come straight from the
            # anchor scan (a path-count frontier has no per-row identity to
            # seed per-source distances from), and nothing expands past it
            # (the dist column would not survive another dense hop)
            if shortest is not None or hops or op.src != head \
                    or op.direction not in ("out", "in"):
                break
            if op.vertex_pred is not None and \
                    not op.vertex_pred.refs() <= {op.alias}:
                break
            shortest = op
            head = op.alias
            i += 1
        elif isinstance(op, Expand):
            if (shortest is not None or op.fused_vertex is None
                    or op.src != head
                    or op.direction not in ("out", "in")):
                break
            if op.pred is not None and (
                    not op.pred.refs() <= {op.edge}
                    or _expr_has_param(op.pred.expr)):
                break
            if op.vertex_pred is not None and \
                    not op.vertex_pred.refs() <= {op.fused_vertex}:
                break
            hops.append(FrontierHop(
                edge_label=op.edge_label, direction=op.direction,
                edge_pred=op.pred, edge_alias=op.edge,
                vertex_alias=op.fused_vertex, vertex_label=op.vertex_label,
                vertex_pred=op.vertex_pred))
            head = op.fused_vertex
            i += 1
        elif isinstance(op, Select) and op.pred.refs() <= {head}:
            if shortest is not None:
                shortest = dataclasses.replace(
                    shortest,
                    vertex_pred=_conjoin_preds(shortest.vertex_pred, op.pred))
            elif hops:
                h = hops[-1]
                hops[-1] = dataclasses.replace(
                    h, vertex_pred=_conjoin_preds(h.vertex_pred, op.pred))
            else:
                source_pred = _conjoin_preds(source_pred, op.pred)
            i += 1
        else:
            break
    tail = [_normalize_count_aggs(op) for op in ops[i:]]
    prefix_aliases = {scan.alias}
    for h in hops:
        prefix_aliases.add(h.vertex_alias)
        if h.edge_alias is not None:
            prefix_aliases.add(h.edge_alias)
    if shortest is not None:
        prefix_aliases.add(shortest.alias)
        # finish_shortest materializes all three columns, so the tail (and
        # the implicit all-columns result when there is no tail) may read
        # any of them
        allowed = {scan.alias, shortest.alias, shortest.dist}
    else:
        allowed = {head}
        if not tail and len(prefix_aliases) > 1:
            return None
    for op in tail:
        if isinstance(op, (Scan, ProcedureCall)):
            return None
        if _op_column_refs(op) & (prefix_aliases - allowed):
            return None
    return FrontierProgram(
        source_alias=scan.alias, source_label=scan.label,
        source_pred=source_pred, hops=tuple(hops), head=head,
        tail=tuple(tail), shortest=shortest)


# --------------------------------------------------------------------- #
# Device tail — lowering the relational tail into the same jitted        #
# program as the match prefix (DESIGN.md §14)                            #
# --------------------------------------------------------------------- #

class TailDataFallback(Exception):
    """The tail lowered structurally but the *data* cannot ride float32
    exactly (property dtype/magnitude, a parameter value that is not
    float32-representable, or a runtime arithmetic peak ≥ 2²⁴). The
    executor catches this internally and finishes through the interpreter
    tail — the prefix counts are still valid, so unlike OverflowError this
    never escapes to the serving layer."""


@dataclasses.dataclass(frozen=True)
class DeviceTail:
    """A relational tail compiled to dense ops over the [B, N] path-count
    matrix. Three shapes:

    - ``rows``: no With — the result is head rows (repeated by path count)
      optionally filtered upstream, ordered, limited, and projected;
    - ``group``: ``WITH head, agg… AS name`` — one row per distinct head
      vertex, aggregates as [B, N] lane values (count = the path counts
      themselves, sum = count·expr, min/max/avg = expr);
    - ``scalar``: ``WITH agg… AS name`` (no keys) — one output row per
      query, aggregates as per-row dense reductions.

    ``having`` are Select exprs applied after the With (device-evaluated
    for ``group``, host-evaluated on the ≤1-row table for ``scalar``);
    ``order_key`` is the resolved ORDER BY expression (None = natural
    order); ``project`` is the original RETURN items, evaluated on the
    host over the assembled (already ordered/limited) rows. ``prop_refs``
    and ``param_names`` are what the device program must prefetch."""

    kind: str                                    # rows | group | scalar
    aggs: Tuple[Agg, ...]
    having: Tuple[Any, ...]
    order_key: Optional[Any]
    order_desc: bool
    limit: Optional[int]
    project: Optional[Tuple[Tuple[Any, str], ...]]
    prop_refs: Tuple[str, ...]
    param_names: Tuple[str, ...]


_F32_INT_LIMIT = 2 ** 24


def f32_exact_scalar(v) -> bool:
    """True when ``v`` is a finite real that float32 represents exactly —
    the admission bar for Const/Param values entering the device tail
    (comparisons against an inexact constant could flip)."""
    if isinstance(v, bool) or not isinstance(
            v, (int, float, np.integer, np.floating)):
        return False
    f = float(v)
    return np.isfinite(f) and float(np.float32(f)) == f


def _device_expr_type(e, head: str, agg_names: frozenset,
                      props: set, pars: set) -> Optional[str]:
    """Type-check an expression for device evaluation: returns "num" /
    "bool", or None when any node cannot lower exactly (division, bool
    arithmetic, non-f32-exact constants, refs outside head ∪ agg names).
    Collects the property and parameter names the device program needs."""
    from repro_torch.core.ir.dag import PropRef
    if isinstance(e, PropRef):
        if e.prop is not None:
            if e.alias != head:
                return None
            props.add(e.prop)
            return "num"
        if e.alias == head or e.alias in agg_names:
            return "num"
        return None
    if isinstance(e, Const):
        return "num" if f32_exact_scalar(e.value) else None
    if isinstance(e, Param):
        pars.add(e.name)
        return "num"
    if isinstance(e, BinExpr):
        lt = _device_expr_type(e.left, head, agg_names, props, pars)
        if lt is None:
            return None
        if e.op == "in":
            if lt != "num" or not isinstance(e.right, Const):
                return None
            vals = e.right.value
            if not isinstance(vals, (list, tuple)):
                return None
            return "bool" if all(f32_exact_scalar(v) for v in vals) else None
        rt = _device_expr_type(e.right, head, agg_names, props, pars)
        if rt is None:
            return None
        if e.op in ("+", "-", "*"):
            return "num" if (lt, rt) == ("num", "num") else None
        if e.op in ("==", "!=", "<", "<=", ">", ">="):
            return "bool" if (lt, rt) == ("num", "num") else None
        if e.op in ("and", "or"):
            return "bool" if (lt, rt) == ("bool", "bool") else None
        return None                                  # "/" stays on the host
    return None


_TAIL_AGG_FNS = ("count", "sum", "min", "max", "avg")


def lower_tail(program: FrontierProgram) -> Optional[DeviceTail]:
    """Decide whether a FrontierProgram's interpreter tail lowers to the
    device, and compile it to a :class:`DeviceTail` if so (None = keep
    ``finish_frontier`` exactly as today).

    Eligible shape: ``[With?] Select* [Project] [OrderBy] Limit*`` where
    every expression references only the head alias (and, after a With,
    the aggregate names), lowers under :func:`_device_expr_type`, and the
    ordering is expressible as sort-then-cut (a Limit *before* an OrderBy
    truncates in natural order first — that stays on the interpreter).
    Exactness is data-dependent (float32 carries integers only below
    2²⁴), so structural eligibility here is completed by runtime peak
    tracking in the executor: any overflow raises
    :class:`TailDataFallback` and the query finishes on the interpreter."""
    if program.shortest is not None or not program.tail:
        return None
    head = program.head
    ops = list(program.tail)
    kind = "rows"
    aggs: Tuple[Agg, ...] = ()
    agg_names: frozenset = frozenset()
    props: set = set()
    pars: set = set()
    i = 0
    if isinstance(ops[0], With):
        w = ops[0]
        if any(k != head for k in w.keys) or len(w.keys) > 1:
            return None
        names = set()
        for a in w.aggs:
            if a.fn not in _TAIL_AGG_FNS or a.name == head or a.name in names:
                return None
            if a.fn == "count":
                if a.expr is not None:       # _normalize_count_aggs ran
                    return None
            elif _device_expr_type(a.expr, head, frozenset(),
                                   props, pars) != "num":
                return None
            names.add(a.name)
        kind = "group" if w.keys else "scalar"
        if kind == "scalar" and not w.aggs:
            return None                      # 0/1 no-column rows: degenerate
        aggs, agg_names = w.aggs, frozenset(names)
        i = 1
    cols = ({head} | agg_names) if kind == "group" else (
        set(agg_names) if kind == "scalar" else {head})
    having: List[Any] = []
    order_key = None
    order_desc = False
    limit: Optional[int] = None
    project: Optional[Tuple[Tuple[Any, str], ...]] = None
    seen_order = False
    for op in ops[i:]:
        if isinstance(op, Select):
            # interpreter Selects mask the table: after a Project the out
            # dict is already built (mask is a no-op on it) and after an
            # OrderBy the limit interplay shifts — both stay interpreted
            if (kind == "rows" or project is not None or seen_order
                    or limit is not None):
                return None
            if not op.pred.refs() <= cols:
                return None
            if kind == "group":
                if _device_expr_type(op.pred.expr, head, agg_names,
                                     props, pars) != "bool":
                    return None
            having.append(op.pred.expr)      # scalar: host-eval on ≤1 row
        elif isinstance(op, Project):
            if project is not None:          # accumulating Projects: host
                return None
            refs: set = set()
            for expr, _name in op.items:
                refs |= expr.refs()
            if not refs <= cols:
                return None
            project = op.items
        elif isinstance(op, OrderBy):
            if seen_order or limit is not None:
                return None                  # Limit-then-OrderBy: host
            seen_order = True
            order_desc = op.desc
            key_expr = None
            if project is not None:          # projected names shadow table
                for pe, pname in reversed(project):
                    if pname == op.key:      # dict semantics: last wins
                        key_expr = pe
                        break
            if key_expr is None:
                if op.key not in cols:
                    return None              # interpreter raises KeyError
                from repro_torch.core.ir.dag import PropRef
                key_expr = PropRef(op.key, None)
            if kind == "scalar":
                order_key = None             # ≤1 row: sort is the identity
            else:
                if _device_expr_type(key_expr, head, agg_names,
                                     props, pars) != "num":
                    return None
                order_key = key_expr
        elif isinstance(op, Limit):
            limit = op.n if limit is None else min(limit, op.n)
        else:
            return None
    return DeviceTail(
        kind=kind, aggs=tuple(aggs), having=tuple(having),
        order_key=order_key, order_desc=order_desc, limit=limit,
        project=project, prop_refs=tuple(sorted(props)),
        param_names=tuple(sorted(pars)))


def finish_device_tail(program: FrontierProgram, tail: DeviceTail,
                       view: Dict[str, Any], pg,
                       params: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, np.ndarray]:
    """One query's device-tail outputs → result dict, matching
    ``finish_frontier`` + ``execute_plan`` bit-for-bit on eligible tails.

    ``view`` is the per-query slice of the jitted program's outputs
    (numpy, already off-device): ``counts`` [N]; for rows/group kinds
    ``cand`` [N] bool (post-having candidacy) and, when ordering,
    ``order`` [N] (stable ascending argsort of the masked key — masked
    lanes sort last, so the first ``cand.sum()`` entries are the result
    in ascending key order; DESC reverses them, reproducing the
    interpreter's reversed-stable-sort tie order); for group/scalar
    kinds ``aggs`` {name: [N] | scalar}. Only the final top-``limit``
    row *assembly* happens here — selection, ordering, filtering and
    reduction all happened on device."""
    head = program.head
    lpg = pg if isinstance(pg, _LabelAwarePG) else _LabelAwarePG(pg)
    limit = tail.limit
    agg_fn = {a.name: a.fn for a in tail.aggs}
    if tail.kind == "scalar":
        n_rows = 1 if bool(view["has_rows"]) else 0
        cnt = int(round(float(view["cnt"]))) if n_rows else 0
        cols: Dict[str, np.ndarray] = {}
        for a in tail.aggs:
            if a.fn == "count":
                col = np.array([cnt], np.int64)
            elif a.fn == "avg":
                col = np.array([float(view["aggs"][a.name])
                                / max(cnt, 1)], np.float64)
            else:
                col = np.array([float(view["aggs"][a.name])], np.float64)
            cols[a.name] = col[:n_rows]
        table = Table(cols, {})
        for hx in tail.having:
            e = bind_expr(hx, params) if params else hx
            keep = np.asarray(eval_expr(e, table.columns, lpg, {}), bool)
            table = table.mask(np.broadcast_to(keep, (table.n_rows,)))
        if limit is not None:
            table = Table({k: v[:max(limit, 0)]
                           for k, v in table.columns.items()}, {})
    else:
        counts = np.asarray(view["counts"])
        cand = np.asarray(view["cand"], bool)
        if tail.order_key is not None:
            n_cand = int(np.count_nonzero(cand))
            sel = np.asarray(view["order"], np.int64)[:n_cand]
            if tail.order_desc:
                sel = sel[::-1]
        else:
            sel = np.nonzero(cand)[0].astype(np.int64)
        if tail.kind == "group":
            if limit is not None:
                sel = sel[:max(limit, 0)]
            cols = {head: sel}
            for a in tail.aggs:
                if a.fn == "count":
                    cols[a.name] = np.round(counts[sel]).astype(np.int64)
                else:
                    cols[a.name] = np.asarray(
                        view["aggs"][a.name], np.float64)[sel]
            table = Table(cols, {})
        else:
            mult = np.round(counts[sel]).astype(np.int64)
            if limit is not None:
                if limit <= 0:
                    sel, mult = sel[:0], mult[:0]
                else:
                    cum = np.cumsum(mult)
                    k = int(np.searchsorted(cum, limit, side="left"))
                    if k < len(cum):         # cut inside vertex k's rows
                        sel, mult = sel[:k + 1], mult[:k + 1].copy()
                        mult[-1] -= int(cum[k]) - limit
            table = Table({head: np.repeat(sel, mult)}, {})
    if tail.project is not None:
        out: Dict[str, np.ndarray] = {}
        for expr, name in tail.project:
            e = bind_expr(expr, params) if params else expr
            out[name] = np.asarray(eval_expr(e, table.columns, lpg, {}))
        return out
    return dict(table.columns)


def frontier_vertex_mask(alias: str, label: Optional[int],
                         pred: Optional[Pred], pg,
                         params: Optional[Dict[str, Any]] = None
                         ) -> np.ndarray:
    """[N] bool mask of vertices passing a stage's label + predicate,
    evaluated once over the whole vertex range (``$params`` bound from
    ``params``)."""
    lpg = pg if isinstance(pg, _LabelAwarePG) else _LabelAwarePG(pg)
    n = lpg.n_vertices
    mask = np.ones(n, bool)
    if label is not None:
        mask &= lpg.vlabels == label
    if pred is not None:
        expr = bind_expr(pred.expr, params) if params else pred.expr
        ids = np.arange(n, dtype=np.int64)
        mask &= np.asarray(eval_expr(expr, {alias: ids}, lpg, {}), bool)
    return mask


def finish_frontier(program: FrontierProgram, counts: np.ndarray, pg,
                    params: Optional[Dict[str, Any]] = None,
                    procedures=None) -> Dict[str, np.ndarray]:
    """One query's path-count row [N] → result dict: re-materialize the
    head column (vertex ids repeated by path count) and run the relational
    tail through the interpreter.

    Path counts ride float32 (the TPU-native dtype): integers are exact
    only below 2²⁴, so a hub vertex that accumulates more paths than that
    would silently round. Refuse loudly instead — the serving layer
    catches OverflowError and re-runs the batch on the interpreter. The
    guard is dtype-aware: any float width gets its own exact-integer
    ceiling (2^(mantissa bits + 1)), integer/bool counts are exact by
    construction, and anything else is a contract violation (TypeError) —
    no fallback path can hand in a dtype that silently bypasses the
    serving layer's interpreter-rerun contract."""
    counts = np.asarray(counts)
    if np.issubdtype(counts.dtype, np.floating):
        exact_limit = 2 ** (np.finfo(counts.dtype).nmant + 1)
        if counts.max(initial=0.0) >= exact_limit:
            raise OverflowError(
                f"path counts exceed {counts.dtype} integer range "
                f"(max {counts.max():.3g} ≥ 2^"
                f"{np.finfo(counts.dtype).nmant + 1}); fragment-path "
                f"multiplicities would be inexact — fall back to the "
                f"interpreter")
    elif not (np.issubdtype(counts.dtype, np.integer)
              or counts.dtype == np.bool_):
        raise TypeError(
            f"path counts must be a real numeric array, got dtype "
            f"{counts.dtype} — the frontier substrate produces "
            f"float32/float64 or integer counts only")
    nz = np.nonzero(counts > 0.5)[0]
    mult = np.round(counts[nz]).astype(np.int64)
    ids = np.repeat(nz.astype(np.int64), mult)
    table = Table({program.head: ids}, {})
    return execute_plan(LogicalPlan(list(program.tail)), pg, params=params,
                        table=table, procedures=procedures)


def finish_shortest(program: FrontierProgram, srcs: np.ndarray,
                    dists: np.ndarray, pg,
                    params: Optional[Dict[str, Any]] = None,
                    procedures=None) -> Dict[str, np.ndarray]:
    """One query's min-plus solution → result dict. ``srcs`` is the [S]
    source vertex ids the query anchored on, ``dists`` the [S, N] distance
    matrix (``inf`` = unreachable, head label/pred already masked to inf).
    Materializes one (source, head, dist) row per finite entry and runs the
    relational tail through the interpreter. Distances are ≤ MAX_VAR_HOPS,
    so the float32 → int64 round is always exact."""
    sp = program.shortest
    dists = np.asarray(dists)
    rr, vv = np.nonzero(np.isfinite(dists))
    table = Table({program.source_alias: np.asarray(srcs, np.int64)[rr],
                   sp.alias: vv.astype(np.int64),
                   sp.dist: np.round(dists[rr, vv]).astype(np.int64)}, {})
    return execute_plan(LogicalPlan(list(program.tail)), pg, params=params,
                        table=table, procedures=procedures)
