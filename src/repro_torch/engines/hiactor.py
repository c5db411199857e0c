"""HiActor — high-throughput OLTP engine (paper §5.3, [57]).

The real HiActor gets throughput from actor-level concurrency over many
small queries. TPU/vectorized adaptation (DESIGN.md §2): queries of the same
*stored procedure* are batched into one row table with a ``__qid__`` column;
the whole batch executes the plan **once** — per-query work becomes
row-parallel work. Parameter references (``$name``) bind to per-row columns,
aggregations implicitly group by ``__qid__``, and the initial scan resolves
through a hash/sorted index (stored procedures always anchor on an indexed
property — the paper's parameterized-query pattern).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ir.cbo import Catalog, apply_cbo, find_indexed_anchor
from repro_torch.core.ir.codegen import Table, execute_plan, _LabelAwarePG, _eval_pred
from repro_torch.core.ir.dag import (Agg, BinExpr, Const, Expand, GetVertex,
                               LogicalPlan, Param, Pred, Project, PropRef,
                               Scan, Select, With, map_op_exprs)
from repro_torch.core.ir.parser import parse_cypher
from repro_torch.core.ir.rbo import apply_rbo
from repro_torch.storage.lpg import PropertyGraph


@dataclasses.dataclass
class Procedure:
    name: str
    plan: LogicalPlan
    scan_alias: str
    index_prop: Optional[str]       # equality-indexed property of the scan
    index_param: Optional[str]      # the $param bound to it
    scan_label: Optional[int]


def _strip_param_binding(expr, param_cols: set):
    """Replace Param('p') with PropRef('$__p', None) row-column refs —
    applied through every expression-bearing field via map_op_exprs, so a
    ``$param`` anywhere in the plan (predicates, projections, aggregates)
    becomes a per-row column reference."""
    if isinstance(expr, Param):
        param_cols.add(expr.name)
        return PropRef(f"$__{expr.name}", None)
    if isinstance(expr, BinExpr):
        l = _strip_param_binding(expr.left, param_cols)
        r = _strip_param_binding(expr.right, param_cols)
        if l is expr.left and r is expr.right:
            return expr
        return BinExpr(expr.op, l, r)
    return expr


class HiActorEngine:
    def __init__(self, store, catalog: Optional[Catalog] = None,
                 procedures=None):
        self.pg = store if isinstance(store, PropertyGraph) \
            else PropertyGraph(store)
        self.catalog = catalog or Catalog.build(self.pg)
        self._procs: Dict[str, Procedure] = {}
        self._indexes: Dict[Tuple[Optional[int], str],
                            Tuple[np.ndarray, np.ndarray]] = {}
        # CALL algo.* registry for stored procedures that embed a
        # ProcedureCall (executed per-query: analytics plans do not ride
        # the __qid__-batched pass — the fixpoint memo does the sharing)
        self.procedures = procedures

    # ------------------------------------------------------------ procedures
    def register(self, name: str, cypher: str) -> Procedure:
        plan = apply_rbo(parse_cypher(cypher))
        plan = apply_cbo(plan, self.catalog)
        return self.register_plan(name, plan)

    def register_plan(self, name: str, plan: LogicalPlan) -> Procedure:
        """Register an already-compiled (post-RBO/CBO) plan as a stored
        procedure — the serving layer's plan cache hands plans in directly,
        so a cache hit never re-parses or re-optimizes."""
        info = find_indexed_anchor(plan)
        if info is None:
            proc = Procedure(name, plan, plan.ops[0].alias
                             if isinstance(plan.ops[0], Scan) else "?",
                             None, None, None)
        else:
            alias, prop, param, label = info
            self._build_index(label, prop)
            try:   # equality selectivity for the adaptive dispatcher
                self.catalog.add_prop_stats(self.pg, label, prop)
            except KeyError:
                pass
            proc = Procedure(name, plan, alias, prop, param, label)
        self._procs[name] = proc
        return proc

    def has_procedure(self, name: str) -> bool:
        return name in self._procs

    def unregister(self, name: str) -> None:
        """Drop a stored procedure (property indexes are schema-bounded
        and shared across procedures, so they stay)."""
        self._procs.pop(name, None)

    def _build_index(self, label: Optional[int], prop: str):
        key = (label, prop)
        if key in self._indexes:
            return
        ids = self.pg.vertices(label)
        vals = self.pg.vprop(prop)[ids]
        order = np.argsort(vals, kind="stable")
        self._indexes[key] = (vals[order], ids[order])

    # -------------------------------------------------------------- submit
    def submit(self, name: str, params: Dict[str, Any]) -> Dict[str, np.ndarray]:
        outs = self.submit_batch(name, [params])
        return {k: v[0] if len(v) else v for k, v in outs.items()} \
            if isinstance(outs, dict) else outs[0]

    def submit_batch(self, name: str, params_list: Sequence[Dict[str, Any]]
                     ) -> List[Dict[str, np.ndarray]]:
        """Execute Q queries of one procedure as a single vectorized pass."""
        proc = self._procs[name]
        Q = len(params_list)
        if proc.index_prop is None:
            return [execute_plan(proc.plan, self.pg, params=p,
                                 procedures=self.procedures)
                    for p in params_list]

        sorted_vals, sorted_ids = self._indexes[(proc.scan_label,
                                                 proc.index_prop)]
        keys = np.array([p[proc.index_param] for p in params_list])
        lo = np.searchsorted(sorted_vals, keys, side="left")
        hi = np.searchsorted(sorted_vals, keys, side="right")
        counts = hi - lo                       # non-unique keys: all matches
        qids = np.repeat(np.arange(Q), counts)
        total = int(counts.sum())
        offs = (np.repeat(lo, counts)
                + np.arange(total)
                - np.repeat(np.cumsum(counts) - counts, counts))
        starts = sorted_ids[offs]

        table = Table({proc.scan_alias: starts, "__qid__": qids}, {})
        # bind every $param as a per-row column
        param_cols: set = set()
        plan_ops = []
        for op in proc.plan.ops[1:]:
            op = map_op_exprs(
                op, lambda e: _strip_param_binding(e, param_cols))
            if isinstance(op, With):
                op = dataclasses.replace(
                    op, keys=tuple(["__qid__"] + list(op.keys)))
            plan_ops.append(op)
        for pname in param_cols:
            vals = np.array([p[pname] for p in params_list])
            table.columns[f"$__{pname}"] = vals[qids]
        # projections must carry __qid__ through
        plan_ops = [_qid_project(op) for op in plan_ops]

        result = execute_plan(LogicalPlan(plan_ops), self.pg, table=table)
        return _split_by_qid(result, Q)

    # naive per-query path (the baseline in the throughput benchmark)
    def submit_serial(self, name: str, params_list: Sequence[Dict[str, Any]]):
        proc = self._procs[name]
        return [execute_plan(proc.plan, self.pg, params=p,
                             procedures=self.procedures)
                for p in params_list]

    def submit_auto(self, name: str, params_list: Sequence[Dict[str, Any]],
                    row_threshold: float = 2e4):
        """Adaptive dispatch: short reads (low CBO-estimated cardinality)
        batch into one vectorized pass; heavy analytical procedures run
        per-query, whose working set stays cache-resident. The estimate
        comes from the GLogue-lite catalog (§5.2)."""
        from repro_torch.core.ir.cbo import plan_cost

        est = plan_cost(self._procs[name].plan, self.catalog)
        if est <= row_threshold:
            return self.submit_batch(name, params_list)
        return self.submit_serial(name, params_list)


def _qid_project(op):
    if isinstance(op, Project):
        items = tuple(op.items) + ((PropRef("__qid__", None), "__qid__"),)
        return Project(items)
    return op


def _split_by_qid(result: Dict[str, np.ndarray], Q: int
                  ) -> List[Dict[str, np.ndarray]]:
    if "__qid__" not in result:
        return [result]
    qid = result["__qid__"].astype(np.int64)
    order = np.argsort(qid, kind="stable")
    qid_s = qid[order]
    bounds = np.searchsorted(qid_s, np.arange(Q + 1))
    cols = {k: v[order] for k, v in result.items() if k != "__qid__"}
    return [{k: v[bounds[q]:bounds[q + 1]] for k, v in cols.items()}
            for q in range(Q)]
