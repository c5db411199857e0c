"""Rule-Based Optimization over GraphIR (paper §5.2).

Implemented rules (the two the paper highlights, plus a trivial cleanup):

- **EdgeVertexFusion** — EXPAND_EDGE immediately followed by GET_VERTEX on
  the same edge alias fuses into one ExpandVertex operator *when no later
  operator references the edge alias* (paper: fusion is not always legal,
  e.g. when edge property retrieval is needed downstream).
- **FilterPushIntoMatch** — conjuncts of a SELECT that reference a single
  vertex/edge alias are pushed into the producing Scan/Expand/GetVertex as
  storage-level predicates (enables GRIN predicate pushdown).
- **DeadSelectElimination** — empty SELECTs left by pushdown are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple

from repro_torch.core.ir.dag import (BinExpr, Expand, ExpandVar, GetVertex,
                               InsertEdge, LogicalPlan, Op, Pred, PropRef,
                               Scan, Select, SetProp, ShortestPath)


def _conjuncts(expr) -> List:
    if isinstance(expr, BinExpr) and expr.op == "and":
        return _conjuncts(expr.left) + _conjuncts(expr.right)
    return [expr]


def _conjoin(parts: List):
    out = parts[0]
    for p in parts[1:]:
        out = BinExpr("and", out, p)
    return out


def _later_refs(ops: List[Op], start: int) -> Set[str]:
    refs: Set[str] = set()
    for op in ops[start:]:
        for field in dataclasses.fields(op):
            v = getattr(op, field.name)
            if isinstance(v, Pred):
                refs |= v.refs()
            elif hasattr(v, "refs") and not isinstance(v, str):
                refs |= v.refs()
            elif isinstance(v, tuple):
                for item in v:
                    if hasattr(item, "refs"):
                        refs |= item.refs()
                    elif isinstance(item, tuple):
                        for sub in item:
                            if hasattr(sub, "refs"):
                                refs |= sub.refs()
        if isinstance(op, Select):
            refs |= op.pred.refs()
        # mutation sinks reference aliases through plain string fields the
        # generic walk above cannot see (DESIGN.md §11: opaque to RBO)
        if isinstance(op, InsertEdge):
            refs |= {op.src, op.dst}
        elif isinstance(op, SetProp):
            refs.add(op.alias)
        elif isinstance(op, (ExpandVar, ShortestPath)):
            refs.add(op.src)
    return refs


def edge_vertex_fusion(plan: LogicalPlan) -> LogicalPlan:
    ops = list(plan.ops)
    out: List[Op] = []
    i = 0
    while i < len(ops):
        op = ops[i]
        if (isinstance(op, Expand) and i + 1 < len(ops)
                and isinstance(ops[i + 1], GetVertex)
                and ops[i + 1].edge == (op.edge or "")
                and op.edge is not None):
            gv = ops[i + 1]
            # legality: edge alias must not be referenced later
            if op.edge not in _later_refs(ops, i + 2):
                out.append(dataclasses.replace(
                    op, fused_vertex=gv.alias, vertex_label=gv.label,
                    vertex_pred=gv.pred, edge=op.edge))
                i += 2
                continue
        out.append(op)
        i += 1
    return LogicalPlan(out)


def filter_push_into_match(plan: LogicalPlan) -> LogicalPlan:
    ops = list(plan.ops)
    # producer map: alias -> op index able to absorb a predicate
    for i, op in enumerate(ops):
        if not isinstance(op, Select):
            continue
        keep = []
        for conj in _conjuncts(op.pred.expr):
            refs = conj.refs() if hasattr(conj, "refs") else set()
            pushed = False
            if len(refs) == 1:
                alias = next(iter(refs))
                for j in range(i - 1, -1, -1):
                    tgt = ops[j]
                    if isinstance(tgt, Scan) and tgt.alias == alias:
                        newp = (conj if tgt.pred is None
                                else _conjoin([tgt.pred.expr, conj]))
                        ops[j] = dataclasses.replace(tgt, pred=Pred(newp))
                        pushed = True
                        break
                    if isinstance(tgt, GetVertex) and tgt.alias == alias:
                        newp = (conj if tgt.pred is None
                                else _conjoin([tgt.pred.expr, conj]))
                        ops[j] = dataclasses.replace(tgt, pred=Pred(newp))
                        pushed = True
                        break
                    if isinstance(tgt, Expand) and tgt.edge == alias:
                        newp = (conj if tgt.pred is None
                                else _conjoin([tgt.pred.expr, conj]))
                        ops[j] = dataclasses.replace(tgt, pred=Pred(newp))
                        pushed = True
                        break
                    if isinstance(tgt, Expand) and tgt.fused_vertex == alias:
                        newp = (conj if tgt.vertex_pred is None
                                else _conjoin([tgt.vertex_pred.expr, conj]))
                        ops[j] = dataclasses.replace(tgt, vertex_pred=Pred(newp))
                        pushed = True
                        break
                    # var-length/shortest endpoint predicates mask only the
                    # final frontier — exactly a SELECT's semantics here
                    if isinstance(tgt, (ExpandVar, ShortestPath)) \
                            and tgt.alias == alias:
                        newp = (conj if tgt.vertex_pred is None
                                else _conjoin([tgt.vertex_pred.expr, conj]))
                        ops[j] = dataclasses.replace(tgt, vertex_pred=Pred(newp))
                        pushed = True
                        break
            if not pushed:
                keep.append(conj)
        ops[i] = Select(Pred(_conjoin(keep))) if keep else None
    return LogicalPlan([op for op in ops if op is not None])


def apply_rbo(plan: LogicalPlan, fusion: bool = True,
              pushdown: bool = True) -> LogicalPlan:
    if fusion:
        plan = edge_vertex_fusion(plan)
    if pushdown:
        plan = filter_push_into_match(plan)
        if fusion:
            plan = edge_vertex_fusion(plan)   # pushdown can expose fusions
    return plan
