"""Cost-Based Optimization — GLogue-lite (paper §5.2, [54]).

The catalog tracks pattern frequencies from single vertices up to 2-paths
(label, edge_label, label): exactly the small-k version of GLogue's pattern
lattice. The CBO reorders a linear match chain so expansion starts from the
most selective anchor and proceeds by smallest estimated frequency —
reproducing the paper's example of collapsing a bifurcated logical DAG into
a linear physical chain anchored at the cheaper side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir.dag import (Const, BinExpr, Expand, ExpandVar, GetVertex,
                               Limit, LogicalPlan, Param, Pred, PropRef,
                               Scan, Select, ShortestPath, plan_is_write)

# Admission-threshold discount for plans whose relational tail lowers to
# the device (no Python re-materialization to amortize): the fragment
# route pays off at ~4× smaller cost estimates (DESIGN.md §14).
FRAGMENT_TAIL_DISCOUNT = 0.25


@dataclasses.dataclass
class Catalog:
    """Pattern-frequency statistics over a PropertyGraph."""

    n_vertices: int
    label_counts: Dict[int, int]
    edge_label_counts: Dict[int, int]
    # (src_label, edge_label, dst_label, direction) -> count
    path2: Dict[Tuple[int, int, int, str], int]
    # (label, prop) -> n_distinct (equality selectivity)
    distinct: Dict[Tuple[int, str], int]
    # (src_label, edge_label, direction) -> size-biased fanout E[d²]/E[d]
    # (a frontier reached *via edges* samples vertices ∝ degree — the
    # mean-field fanout wildly underestimates zipf joins)
    size_biased: Dict[Tuple[int, int, str], float] = dataclasses.field(
        default_factory=dict)
    # sufficient statistics behind ``size_biased`` so :meth:`advance` can
    # update it in O(delta): per (edge_label, direction) the typed degree
    # vector, per (src_label, edge_label, direction) the exact integer
    # (Σd, Σd²). ``None`` for hand-built catalogs — advance() then refuses
    # and the caller falls back to a full build.
    sb_state: Optional[Dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    @staticmethod
    def build(pg) -> "Catalog":
        vlab = pg.vlabels
        elab = pg.elabels
        indptr, indices = pg.indptr, pg.indices
        src = np.repeat(np.arange(pg.n_vertices), np.diff(indptr))
        lc = {int(k): int(v) for k, v in
              zip(*np.unique(vlab, return_counts=True))}
        ec = {int(k): int(v) for k, v in
              zip(*np.unique(elab, return_counts=True))}
        path2: Dict[Tuple[int, int, int, str], int] = {}
        trip = np.stack([vlab[src], elab, vlab[indices]], axis=1)
        uniq, counts = np.unique(trip, axis=0, return_counts=True)
        for (sl, el, dl), c in zip(uniq, counts):
            path2[(int(sl), int(el), int(dl), "out")] = int(c)
            path2[(int(dl), int(el), int(sl), "in")] = int(c)

        sb: Dict[Tuple[int, int, str], float] = {}
        degs: Dict[Tuple[int, str], np.ndarray] = {}
        sums: Dict[Tuple[int, int, str], Tuple[int, int]] = {}
        n = pg.n_vertices
        for el in ec:
            m = elab == el
            for direction, vcol in (("out", src[m]), ("in", indices[m])):
                deg = np.bincount(vcol, minlength=n).astype(np.int64)
                degs[(int(el), direction)] = deg
                for sl in lc:
                    d = deg[vlab == sl]
                    tot = int(d.sum())
                    if tot > 0:
                        s2 = int((d * d).sum())
                        sums[(int(sl), int(el), direction)] = (tot, s2)
                        sb[(int(sl), int(el), direction)] = float(s2 / tot)
        return Catalog(pg.n_vertices, lc, ec, path2, {}, sb,
                       sb_state={"deg": degs, "sums": sums})

    def advance(self, pg, delta) -> Optional["Catalog"]:
        """A new catalog over ``pg`` (the delta-extended graph), updated
        from this one in O(delta) instead of a full O(E) rebuild
        (DESIGN.md §15): edge/path2 counts bump by the delta's typed edge
        counts; ``size_biased`` updates through its exact integer
        sufficient statistics (a vertex going d → d+c adds 2dc + c² to
        Σd² — bit-identical to a fresh build because the sums are integer
        all the way); ``distinct`` entries whose property the window
        touched are recomputed on the new columns, untouched ones carry.
        Returns ``None`` when this catalog lacks the sufficient-statistics
        state (hand-built) — the caller must fall back to
        :meth:`build`."""
        if self.sb_state is None:
            return None
        vlab = pg.vlabels
        ec = dict(self.edge_label_counts)
        path2 = dict(self.path2)
        degs = dict(self.sb_state["deg"])
        sums = dict(self.sb_state["sums"])
        sb = dict(self.size_biased)
        if delta.n_edges:
            labs = delta.labels.astype(np.int64)
            trip = np.stack([vlab[delta.src], labs, vlab[delta.dst]], axis=1)
            uniq, counts = np.unique(trip, axis=0, return_counts=True)
            for (sl, el, dl), c in zip(uniq, counts):
                ec[int(el)] = ec.get(int(el), 0) + int(c)
                k = (int(sl), int(el), int(dl), "out")
                path2[k] = path2.get(k, 0) + int(c)
                k = (int(dl), int(el), int(sl), "in")
                path2[k] = path2.get(k, 0) + int(c)
            for el in (int(e) for e in np.unique(labs)):
                m = labs == el
                for direction, vcol in (("out", delta.src[m]),
                                        ("in", delta.dst[m])):
                    dkey = (el, direction)
                    deg = degs.get(dkey)
                    deg = (np.zeros(self.n_vertices, np.int64)
                           if deg is None else deg.copy())
                    verts, cnts = np.unique(vcol, return_counts=True)
                    d_old = deg[verts]
                    dd2 = 2 * d_old * cnts + cnts * cnts
                    for sl in (int(s) for s in np.unique(vlab[verts])):
                        msl = vlab[verts] == sl
                        skey = (sl, el, direction)
                        tot, s2 = sums.get(skey, (0, 0))
                        tot += int(cnts[msl].sum())
                        s2 += int(dd2[msl].sum())
                        sums[skey] = (tot, s2)
                        sb[skey] = float(s2 / tot)
                    deg[verts] = d_old + cnts
                    degs[dkey] = deg
        new = Catalog(self.n_vertices, dict(self.label_counts), ec, path2,
                      dict(self.distinct), sb,
                      sb_state={"deg": degs, "sums": sums})
        for (label, prop) in list(new.distinct):
            if prop in delta.vprop_names:
                new.add_prop_stats(pg, label, prop)
        return new

    def add_prop_stats(self, pg, label: int, prop: str):
        ids = pg.vertices(label)
        self.distinct[(label, prop)] = max(
            1, len(np.unique(pg.vprop(prop)[ids])))

    # ------------------------------------------------------------ estimates
    def scan_card(self, label: Optional[int], pred: Optional[Pred]) -> float:
        base = (self.label_counts.get(label, self.n_vertices)
                if label is not None else self.n_vertices)
        if pred is not None:
            base *= self._pred_selectivity(label, pred)
        return max(base, 1e-3)

    def _pred_selectivity(self, label, pred: Pred) -> float:
        # equality on a tracked prop: 1/n_distinct; otherwise 0.1 heuristic
        expr = pred.expr
        if (isinstance(expr, BinExpr) and expr.op == "=="
                and isinstance(expr.left, PropRef)
                and isinstance(expr.right, (Const, Param))):
            nd = self.distinct.get((label, expr.left.prop))
            if nd:
                return 1.0 / nd
            return 0.01
        return 0.1

    def expand_fanout(self, src_label: Optional[int], edge_label: Optional[int],
                      dst_label: Optional[int], direction: str) -> float:
        """Average out-edges per source vertex for this typed expansion."""
        if src_label is None or edge_label is None:
            e = (self.edge_label_counts.get(edge_label,
                                            sum(self.edge_label_counts.values()))
                 if edge_label is not None
                 else sum(self.edge_label_counts.values()))
            return max(e / max(self.n_vertices, 1), 1e-3)
        key = (src_label, edge_label, dst_label, direction)
        if dst_label is None:
            total = sum(v for (sl, el, dl, d), v in self.path2.items()
                        if sl == src_label and el == edge_label and d == direction)
        else:
            total = self.path2.get(key, 0)
        n_src = max(self.label_counts.get(src_label, self.n_vertices), 1)
        return max(total / n_src, 1e-3)


def find_indexed_anchor(plan: LogicalPlan):
    """``(alias, prop, param, label)`` when the plan anchors on a single
    ``prop == $param`` equality — the stored-procedure pattern HiActor can
    resolve through a hash/sorted index instead of a full scan."""
    scan = plan.ops[0] if plan.ops else None
    if not isinstance(scan, Scan) or scan.pred is None:
        return None
    e = scan.pred.expr
    if (isinstance(e, BinExpr) and e.op == "==" and
            isinstance(e.left, PropRef) and isinstance(e.right, Param)):
        return scan.alias, e.left.prop, e.right.name, scan.label
    return None


def is_point_lookup(plan: LogicalPlan, catalog: Catalog,
                    row_threshold: float = 2e4) -> bool:
    """Dispatch predicate for the serving layer: plans that anchor on an
    indexed ``$param`` equality *and* stay small by the GLogue-lite estimate
    route to HiActor's batched OLTP path; everything else is OLAP-shaped
    and goes to Gaia's dataflow.

    Plans containing LIMIT are excluded: the batched pass executes the
    whole multi-query table in one shot, so a LIMIT would truncate
    across the batch instead of per query. Write plans never batch here —
    mutations go down the serving layer's write route (DESIGN.md §11)."""
    if plan_is_write(plan):
        return False
    if find_indexed_anchor(plan) is None:
        return False
    if any(isinstance(op, Limit) for op in plan.ops):
        return False
    return plan_cost(plan, catalog) <= row_threshold


def should_use_fragment_path(plan: LogicalPlan, catalog: Catalog,
                             min_cost: float = 256.0,
                             row_threshold: float = 2e4) -> bool:
    """Dispatch predicate for the fragment frontier path (DESIGN.md §9):
    OLAP plans whose match prefix lowers to dense frontier stages AND whose
    GLogue-lite estimate says the interpreter would materialize enough
    intermediate rows (≥ ``min_cost``) to pay for [B, N] dense matrices.

    Point lookups are excluded — HiActor's indexed batch wins when the
    anchor resolves to a handful of rows — and plans whose prefix has no
    Expand gain nothing from a dense hop. ``row_threshold`` must be the
    same value the caller's HiActor dispatch uses, so the two predicates
    partition plans consistently. Anything that does not lower
    (cross-alias predicates, edge-alias reuse, ``$params`` in edge
    predicates, a non-Scan source…) falls back to the interpreter, which
    stays the semantic oracle.

    When the relational *tail* also lowers (``lower_tail``, DESIGN.md
    §14), the fragment route skips ``finish_frontier``'s Python row
    re-materialization entirely, so it pays off at smaller estimates: the
    admission bar drops to ``min_cost × FRAGMENT_TAIL_DISCOUNT``. The
    discount is monotone — every plan eligible at ``min_cost`` stays
    eligible — so previously-routed plans keep routing identically."""
    from repro_torch.core.ir.codegen import lower_tail, lower_to_frontier

    if plan_is_write(plan):
        return False
    if is_point_lookup(plan, catalog, row_threshold):
        return False
    program = lower_to_frontier(plan)
    if program is None or not (program.hops or program.shortest):
        return False
    cost = plan_cost(plan, catalog)
    if cost >= min_cost:
        return True
    # rows-kind tails earn no discount: their row order (and therefore a
    # LIMIT-without-ORDER BY subset, or tie order within a sort key) is
    # the frontier substrate's vertex-id order, not the interpreter's
    # traversal order — pulling a previously-interpreted plan over would
    # visibly change its answers. Group/scalar tails are deterministic
    # and interpreter-exact, so only they lower the admission bar.
    tail = lower_tail(program)
    return (tail is not None and tail.kind != "rows"
            and cost >= min_cost * FRAGMENT_TAIL_DISCOUNT)


def plan_cost(plan: LogicalPlan, catalog: Catalog) -> float:
    """Estimated total intermediate-result size (the GLogue cost: sum of
    subgraph frequencies along the execution plan)."""
    cost = 0.0
    card = 1.0
    labels: Dict[str, Optional[int]] = {}
    hops = 0
    for op in plan.ops:
        if isinstance(op, Scan):
            card = catalog.scan_card(op.label, op.pred)
            labels[op.alias] = op.label
            cost += card
        elif isinstance(op, Expand):
            src_label = labels.get(op.src)
            dst_label = op.vertex_label
            f = catalog.expand_fanout(src_label, op.edge_label, dst_label,
                                      op.direction)
            if hops >= 1 and src_label is not None \
                    and op.edge_label is not None:
                # edge-reached frontier: use the size-biased fanout
                f = max(f, catalog.size_biased.get(
                    (src_label, op.edge_label, op.direction), f))
            hops += 1
            card *= f
            if op.pred is not None:
                card *= 0.25
            if op.vertex_pred is not None:
                card *= 0.1
            if op.fused_vertex:
                labels[op.fused_vertex] = op.vertex_label
            cost += card
        elif isinstance(op, ExpandVar):
            # geometric walk-count sum over depths [min, max]: the first
            # hop uses the mean-field fanout, deeper hops the size-biased
            # one (an edge-reached frontier samples vertices ∝ degree)
            src_label = labels.get(op.src)
            f1 = catalog.expand_fanout(src_label, op.edge_label,
                                       op.vertex_label, op.direction)
            fsb = f1
            if src_label is not None and op.edge_label is not None:
                fsb = max(f1, catalog.size_biased.get(
                    (src_label, op.edge_label, op.direction), f1))
            tot = 1.0 if op.min_hops == 0 else 0.0
            c = 1.0
            for k in range(1, op.max_hops + 1):
                c *= f1 if k == 1 else fsb
                if k >= op.min_hops:
                    tot += c
            hops += 1
            card *= max(tot, 1e-3)
            if op.vertex_pred is not None:
                card *= 0.1
            labels[op.alias] = op.vertex_label
            cost += card
        elif isinstance(op, ShortestPath):
            # one row per reachable (source, target) pair: reach saturates
            # at the vertex count instead of compounding like walk counts
            src_label = labels.get(op.src)
            f1 = catalog.expand_fanout(src_label, op.edge_label,
                                       op.vertex_label, op.direction)
            reach = min(max(f1, 1.0) ** op.max_hops,
                        float(catalog.n_vertices))
            hops += 1
            card *= max(reach, 1e-3)
            if op.vertex_pred is not None:
                card *= 0.1
            labels[op.alias] = op.vertex_label
            cost += card
        elif isinstance(op, GetVertex):
            labels[op.alias] = op.label
            if op.pred is not None:
                card *= 0.1
            cost += card
        elif isinstance(op, Select):
            card *= 0.1
            cost += card
        else:
            cost += card
    return cost


def _chain_segments(plan: LogicalPlan):
    """Split the plan into the match chain (Scan + Expands/GetVertex) and the
    relational tail; CBO only reorders the chain."""
    chain: List = []
    tail: List = []
    for op in plan.ops:
        if isinstance(op, (Scan, Expand, GetVertex)) and not tail:
            chain.append(op)
        else:
            tail.append(op)
    return chain, tail


def apply_cbo(plan: LogicalPlan, catalog: Catalog) -> LogicalPlan:
    """Direction-flip CBO for linear chains: a path pattern
    (a)-[e1]->(b)-[e2]->(c) can be matched left→right or right→left.
    Choose the anchor (first Scan) with the lower estimated cost."""
    chain, tail = _chain_segments(plan)
    if not chain or not isinstance(chain[0], Scan):
        return plan
    reversed_chain = _reverse_chain(chain)
    if reversed_chain is None:
        return plan
    fwd_cost = plan_cost(LogicalPlan(chain), catalog)
    rev_cost = plan_cost(LogicalPlan(reversed_chain), catalog)
    best = chain if fwd_cost <= rev_cost else reversed_chain
    return LogicalPlan(list(best) + list(tail))


def _reverse_chain(chain) -> Optional[List]:
    """Reverse a pure fused linear chain Scan→Expand*→ (after RBO)."""
    if not all(isinstance(op, (Scan, Expand)) for op in chain):
        return None
    expands = chain[1:]
    if not all(isinstance(e, Expand) and e.fused_vertex for e in expands):
        return None
    scan: Scan = chain[0]
    # aliases along the path
    aliases = [scan.alias] + [e.fused_vertex for e in expands]
    labels = {scan.alias: scan.label}
    preds = {scan.alias: scan.pred}
    for e in expands:
        labels[e.fused_vertex] = e.vertex_label
        preds[e.fused_vertex] = e.vertex_pred
    new_scan = Scan(aliases[-1], labels[aliases[-1]], preds[aliases[-1]])
    out: List = [new_scan]
    for i in range(len(expands) - 1, -1, -1):
        e = expands[i]
        tgt = aliases[i]
        out.append(Expand(
            src=aliases[i + 1],
            edge_label=e.edge_label,
            direction="in" if e.direction == "out" else "out",
            edge=e.edge,
            pred=e.pred,
            fused_vertex=tgt,
            vertex_label=labels[tgt],
            vertex_pred=preds[tgt],
        ))
    return out
