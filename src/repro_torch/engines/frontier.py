"""Fragment-backed OLAP traversal — Gaia plans on the GRAPE substrate
(DESIGN.md §9), in PyTorch.

``lower_to_frontier`` (core/ir/codegen.py) turns a plan's match prefix into
dense frontier stages; this executor runs them on the partitioned fragment
model: the hop adjacency is sliced per (edge_label, direction) from the
shared ``PropertyGraph`` caches, range-partitioned into F fragments of
owned *destination* rows, and one admission batch of B queries executes
as one pass of tensor operations over a ``[B, N]`` path-count matrix:

    X₀[b, v] = 1 ⇔ v matches query b's anchor
    X ← hop(X) ⊙ mask_hop          (one stage per EXPAND/WHERE)
    X[b, v] = #matched paths of query b ending at v

Each fragment computes its owned ``[B, v_per]`` slice and the slices
concatenate. A hop is either the batched pull-ELL kernel
(``kernels/ops.py::frontier_step``, ``use_kernels=True``: the CUDA kernel
on the GPU, its plain version on the CPU) or an edge-list gather and
``index_add_`` with the same padding contract. Python-level results come
from the ``finish_*`` host assembly in ``core/ir/codegen.py``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.ir.codegen import (DeviceTail, FrontierHop,
                                         FrontierProgram, TailDataFallback,
                                         _LabelAwarePG, _expr_has_param,
                                         f32_exact_scalar,
                                         finish_device_tail, finish_frontier,
                                         finish_shortest,
                                         frontier_vertex_mask, lower_tail,
                                         lower_to_frontier)
from repro_torch.core.ir.dag import (Const, LogicalPlan, Param, PropRef,
                                     eval_expr)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.storage.lpg import PropertyGraph

_F32_INT_LIMIT = 2 ** 24


@dataclasses.dataclass
class _HopArrays:
    """Device-resident adjacency of one (edge_label, direction) hop, per
    fragment: the edge-list form ``(src, row, w)`` — global frontier-side
    vertex, local owned destination row, weight (0 ⇒ masked edge) — or
    the pull-ELL slab ``(ell_idx, ell_w, row_map)`` from ``csr_to_ell``."""

    frags: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _max0(t: torch.Tensor) -> torch.Tensor:
    """max(0, max(t)) as a 0-d tensor; 0 for an empty ``t``."""
    if t.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=t.device)
    return t.max().clamp_min(0.0)


class FragmentFrontierExecutor:
    """Executes lowered ``FrontierProgram``s over F fragments on one
    device (``None`` = CUDA; raises when CUDA is absent)."""

    def __init__(self, pg: PropertyGraph, n_frags: int = 1,
                 use_kernels: bool = False, device_tail: bool = True,
                 device=None):
        self.pg = pg if isinstance(pg, PropertyGraph) else PropertyGraph(pg)
        self.device = resolve_device(device)
        self.n_frags = n_frags
        self.v_per = -(-self.pg.n_vertices // n_frags)
        self.use_kernels = use_kernels
        self.device_tail = device_tail
        self._hops: Dict[Tuple, _HopArrays] = {}
        # device-tail compilation memo: (head, repr(tail ops)) → DeviceTail
        # or None; validated float32 vertex-property columns (None ⇒ the
        # property cannot ride float32 exactly — data fallback)
        self._tails: Dict[Tuple, Optional[DeviceTail]] = {}
        self._prop_cols: Dict[str, Optional[torch.Tensor]] = {}
        # static (param-free) [N] stage masks, keyed (label, pred repr);
        # rebuilt per execute only when the predicate carries $params
        self._masks: Dict[Tuple, torch.Tensor] = {}
        self._programs: "weakref.WeakKeyDictionary[LogicalPlan, Any]" = \
            weakref.WeakKeyDictionary()
        # batches whose relational tail finished on the device vs through
        # the interpreter (finish_frontier)
        self.tail_stats = {"device": 0, "interpreter": 0}

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    # ------------------------------------------------------------ lowering
    def program_for(self, plan: LogicalPlan) -> Optional[FrontierProgram]:
        """Lowered program for a (cached) plan object, memoized per plan."""
        try:
            prog = self._programs.get(plan, False)
        except TypeError:                 # unhashable plan, lower fresh
            return lower_to_frontier(plan)
        if prog is False:
            prog = lower_to_frontier(plan)
            self._programs[plan] = prog
        return prog

    # ------------------------------------------------------- hop adjacency
    def _hop_arrays(self, hop: FrontierHop) -> _HopArrays:
        key = hop.cache_key
        cached = self._hops.get(key)
        if cached is not None:
            return cached
        # pull orientation: slab/edge rows are the hop's *destination*
        # vertices, entries the frontier-side sources — so the row range
        # partition assigns each fragment the vertices it owns
        opp = "in" if hop.direction == "out" else "out"
        indptr, indices, emap = self.pg.sliced_csr(hop.edge_label, opp)
        w = np.ones(len(indices), np.float32)
        if hop.edge_pred is not None:
            eids = emap if emap is not None \
                else np.arange(len(indices), dtype=np.int64)
            keep = eval_expr(hop.edge_pred.expr, {}, _LabelAwarePG(self.pg),
                             {hop.edge_alias: eids})
            w = np.asarray(keep, np.float32)
        n, vp = self.pg.n_vertices, self.v_per
        deg = np.diff(indptr)
        frags = []
        for f in range(self.n_frags):
            # tiny graphs can leave trailing fragments with no owned rows
            lo, hi = min(f * vp, n), min((f + 1) * vp, n)
            e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
            if self.use_kernels:
                local_ptr = (indptr[lo:hi + 1] - e_lo).astype(np.int64)
                ell_idx, ell_w, row_map = ops.csr_to_ell(
                    local_ptr, indices[e_lo:e_hi].astype(np.int32),
                    w[e_lo:e_hi])
                frags.append((self._tensor(ell_idx), self._tensor(ell_w),
                              self._tensor(row_map)))
            else:
                row = np.repeat(np.arange(hi - lo), deg[lo:hi])
                frags.append((self._tensor(indices[e_lo:e_hi], torch.int64),
                              self._tensor(row, torch.int64),
                              self._tensor(w[e_lo:e_hi])))
        arrs = _HopArrays(frags)
        self._hops[key] = arrs
        return arrs

    # ---------------------------------------------------------- device hop
    def _owned_edges(self, src, row, w, x):
        """One fragment, edge-list form: [B, N] → owned [B, v_per]."""
        vals = x.index_select(1, src) * w                 # [B, Ep]
        out = torch.zeros(x.shape[0], self.v_per, dtype=torch.float32,
                          device=self.device)
        return out.index_add_(1, row, vals)

    def _owned_edges_minplus(self, src, row, w, d):
        """One fragment, edge-list form, tropical semiring: [B, N]
        distances → owned [B, v_per] relaxations (scatter-min; masked
        edges carry w == 0 and relax to +inf)."""
        vals = torch.where(w > 0, d.index_select(1, src) + 1.0, torch.inf)
        out = torch.full((d.shape[0], self.v_per), torch.inf,
                         dtype=torch.float32, device=self.device)
        return out.scatter_reduce_(1, row[None].expand_as(vals), vals,
                                   "amin")

    def _apply_hop(self, arrs: _HopArrays, x: torch.Tensor,
                   minplus: bool = False) -> torch.Tensor:
        """One hop over the fragment set: a sum-product step, or with
        ``minplus`` one shortest-path relaxation (before the ``min(d, ·)``
        merge). Owned ranges are disjoint, so they concatenate."""
        if self.use_kernels:
            step = ops.frontier_minplus_step if minplus \
                else ops.frontier_step
            owned = [step(ell_idx, ell_w, x, row_map, self.v_per)
                     for ell_idx, ell_w, row_map in arrs.frags]
        else:
            edges = self._owned_edges_minplus if minplus \
                else self._owned_edges
            owned = [edges(src, row, w, x) for src, row, w in arrs.frags]
        return torch.cat(owned, dim=1)[:, :self.pg.n_vertices].contiguous()

    def _prefix(self, program: FrontierProgram, x: torch.Tensor, masks,
                hops) -> Tuple[torch.Tensor, torch.Tensor]:
        """The match prefix: returns the head's path counts and the peak
        accumulation value across var-length stages. float32 path counts
        are exact only below 2^24, and powered stages reach it far sooner
        than fixed chains — the executor raises OverflowError when the
        peak crosses it (DESIGN.md §13)."""
        peak = torch.zeros((), dtype=torch.float32, device=self.device)
        for h, m, ha in zip(program.hops, masks, hops):
            if (h.min_hops, h.max_hops) == (1, 1):
                x = self._apply_hop(ha, x)
            else:
                # accumulated powered stages: acc = Σ_{k∈[lo,hi]} X·Aᵏ
                # (X itself when lo == 0); intermediate powers below lo
                # still feed later ones, so their peaks count too
                acc = x if h.min_hops == 0 else torch.zeros_like(x)
                cur = x
                for k in range(1, h.max_hops + 1):
                    cur = self._apply_hop(ha, cur)
                    peak = torch.maximum(peak, cur.max())
                    if k >= h.min_hops:
                        acc = acc + cur
                peak = torch.maximum(peak, acc.max())
                x = acc
            if m is not None:           # [N] static or [B, N] per-query
                x = x * m
        return x, peak

    # ---------------------------------------------------------- device tail
    def _device_tail(self, program: FrontierProgram) -> Optional[DeviceTail]:
        """Structural tail eligibility, memoized per (head, tail) shape."""
        key = (program.head, repr(program.tail))
        if key not in self._tails:
            self._tails[key] = lower_tail(program)
        return self._tails[key]

    def _tail_prop(self, name: str) -> torch.Tensor:
        """A vertex-property column as a device float32 vector, or
        :class:`TailDataFallback` when the data cannot ride float32
        exactly (non-integer dtype or magnitudes at/above 2²⁴). The
        verdict is cached — same policy as the static mask cache."""
        if name not in self._prop_cols:
            lpg = _LabelAwarePG(self.pg)
            try:
                raw = np.asarray(lpg.vprop(name))
            except KeyError:
                # unknown property: the interpreter tail raises the real
                # KeyError — don't mask it behind a device artifact
                self._prop_cols[name] = None
            else:
                col = None
                if np.issubdtype(raw.dtype, np.integer) \
                        or raw.dtype == np.bool_:
                    if raw.size == 0 or \
                            np.abs(raw).max() < _F32_INT_LIMIT:
                        col = self._tensor(raw.astype(np.float32))
                self._prop_cols[name] = col
        col = self._prop_cols[name]
        if col is None:
            raise TailDataFallback(
                f"vertex property {name!r} is not exactly float32-"
                f"representable (need integer/bool dtype, |v| < 2^24)")
        return col

    def _tail_pvals(self, tail: DeviceTail, params_list
                    ) -> Dict[str, torch.Tensor]:
        """Per-query [B, 1] float32 columns for the tail's $params; any
        value float32 cannot carry exactly falls back (a comparison
        against an inexact constant could flip)."""
        pvals: Dict[str, torch.Tensor] = {}
        for name in tail.param_names:
            col = np.empty((len(params_list), 1), np.float32)
            for b, p in enumerate(params_list):
                if name not in p or not f32_exact_scalar(p[name]):
                    raise TailDataFallback(
                        f"parameter ${name} missing or not exactly "
                        f"float32-representable")
                col[b, 0] = float(p[name])
            pvals[name] = self._tensor(col)
        return pvals

    def _dev(self, e, ctx, base, head: str):
        """Device eval → (value, peak): value is a 0-d / [N] / [B, 1] /
        [B, N] float32 tensor (bool for predicates); peak bounds |v| of
        every arithmetic node over base-candidate lanes."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        if isinstance(e, PropRef):
            if e.prop is not None:
                return ctx["props"][e.prop], zero
            if e.alias == head:
                return ctx["iota"], zero
            return ctx["aggs"][e.alias], zero
        if isinstance(e, Const):
            return torch.tensor(float(e.value), dtype=torch.float32,
                                device=self.device), zero
        if isinstance(e, Param):
            return ctx["pvals"][e.name], zero
        lv, lp = self._dev(e.left, ctx, base, head)
        if e.op == "in":
            vals = [float(v) for v in e.right.value]
            if not vals:
                return torch.zeros_like(lv, dtype=torch.bool) & base, lp
            hit = (lv[..., None] == self._tensor(
                np.asarray(vals, np.float32))).any(dim=-1)
            return hit, lp
        rv, rp = self._dev(e.right, ctx, base, head)
        peak = torch.maximum(lp, rp)
        if e.op in ("+", "-", "*"):
            v = {"+": lambda: lv + rv, "-": lambda: lv - rv,
                 "*": lambda: lv * rv}[e.op]()
            peak = torch.maximum(peak, _max0(
                torch.where(base, v, 0.0).abs()))
            return v, peak
        if e.op == "and":
            return torch.logical_and(lv, rv), peak
        if e.op == "or":
            return torch.logical_or(lv, rv), peak
        cmp = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
               "<=": torch.le, ">": torch.gt, ">=": torch.ge}[e.op]
        return cmp(lv, rv), peak

    def _run_tail(self, program: FrontierProgram, tail: DeviceTail,
                  x, masks, pvals, hops, props) -> Dict[str, Any]:
        """The fused prefix + relational tail (DESIGN.md §14): WHERE as
        frontier masks, aggregates as dense reductions over the [B, N]
        counts, ORDER BY as a stable masked argsort — returning only the
        small per-query views ``finish_device_tail`` assembles rows from.

        Exactness is certified on the device: ``tail_peak`` tracks the
        magnitude of every arithmetic intermediate (masked to candidate
        lanes) plus the absolute-sum bound of each float32 accumulation;
        the caller discards the device tail and finishes on the
        interpreter when it reaches 2²⁴."""
        head = program.head
        agg_fns = {a.name: a.fn for a in tail.aggs}
        counts, peak = self._prefix(program, x, masks, hops)
        cand0 = counts > 0.5
        ctx: Dict[str, Any] = {
            "pvals": pvals, "aggs": {}, "props": props,
            "iota": torch.arange(self.pg.n_vertices, dtype=torch.float32,
                                 device=self.device)}
        tpeak = torch.zeros((), dtype=torch.float32, device=self.device)
        out: Dict[str, Any] = {"counts": counts, "peak": peak}
        if tail.kind == "scalar":
            xm = torch.where(cand0, counts, 0.0)
            evs = {}
            for a in tail.aggs:
                if a.fn == "count":
                    continue
                ev, p = self._dev(a.expr, ctx, cand0, head)
                tpeak = torch.maximum(tpeak, p)
                evs[a.name] = ev
            names = [a.name for a in tail.aggs if a.fn != "count"]
            aggs_out: Dict[str, Any] = {}
            if self.use_kernels and names and all(
                    evs[nm].dim() == 1 for nm in names):
                vals = torch.stack([evs[nm] for nm in names]).contiguous()
                cnt, sums, sabs, mins, maxs = ops.tail_reduce(
                    xm.contiguous(), vals)
                for j, nm in enumerate(names):
                    fn_ = agg_fns[nm]
                    if fn_ in ("sum", "avg"):
                        aggs_out[nm] = sums[:, j]
                        tpeak = torch.maximum(tpeak, _max0(sabs[:, j]))
                    else:
                        aggs_out[nm] = (mins if fn_ == "min"
                                        else maxs)[:, j]
            else:
                cnt = xm.sum(dim=1)
                for nm in names:
                    fn_ = agg_fns[nm]
                    if fn_ in ("sum", "avg"):
                        term = torch.where(cand0, counts * evs[nm], 0.0)
                        aggs_out[nm] = term.sum(dim=1)
                        # Σ m·|e| bounds every partial sum, so below 2^24
                        # the f32 accumulation is exact in any order
                        tpeak = torch.maximum(
                            tpeak, _max0(term.abs().sum(dim=1)))
                    elif fn_ == "min":
                        aggs_out[nm] = torch.where(
                            cand0, evs[nm], torch.inf).amin(dim=1)
                    else:
                        aggs_out[nm] = torch.where(
                            cand0, evs[nm], -torch.inf).amax(dim=1)
            tpeak = torch.maximum(tpeak, _max0(cnt))
            out["cnt"], out["has_rows"] = cnt, cnt > 0.5
            out["aggs"] = aggs_out
            out["tail_peak"] = tpeak
            return out
        if tail.kind == "group":
            aggs_out = {}
            for a in tail.aggs:
                if a.fn == "count":
                    ctx["aggs"][a.name] = counts
                    continue
                ev, p = self._dev(a.expr, ctx, cand0, head)
                tpeak = torch.maximum(tpeak, p)
                if a.fn == "sum":
                    col = torch.where(cand0, counts * ev, 0.0)
                    tpeak = torch.maximum(tpeak, _max0(col.abs()))
                else:
                    # min/max/avg of a group whose rows all share the head
                    # vertex: the expr's single distinct value
                    col = torch.where(cand0, ev, 0.0)
                ctx["aggs"][a.name] = col
                aggs_out[a.name] = col
            out["aggs"] = aggs_out
        cand = cand0
        for hx in tail.having:
            hv, hp = self._dev(hx, ctx, cand0, head)
            tpeak = torch.maximum(tpeak, hp)
            cand = torch.logical_and(cand, hv)
        out["cand"] = cand
        if tail.order_key is not None:
            kv, kp = self._dev(tail.order_key, ctx, cand0, head)
            tpeak = torch.maximum(tpeak, kp)
            out["order"] = ops.masked_order(kv.expand(counts.shape), cand)
        out["tail_peak"] = tpeak
        return out

    def _finish_tail(self, program: FrontierProgram, tail: DeviceTail,
                     outd: Dict[str, Any], counts: np.ndarray, params_list
                     ) -> List[Dict[str, np.ndarray]]:
        """Per-query host assembly of the device-tail outputs."""
        def host(t):
            return t.cpu().numpy()

        aggs = {k: host(v) for k, v in outd.get("aggs", {}).items()}
        cand = host(outd["cand"]) if "cand" in outd else None
        order = host(outd["order"]) if "order" in outd else None
        cnt = host(outd["cnt"]) if "cnt" in outd else None
        has = host(outd["has_rows"]) if "has_rows" in outd else None
        res = []
        for b, params in enumerate(params_list):
            view: Dict[str, Any] = {"counts": counts[b],
                                    "aggs": {k: v[b] for k, v in
                                             aggs.items()}}
            if cand is not None:
                view["cand"] = cand[b]
            if order is not None:
                view["order"] = order[b]
            if cnt is not None:
                view["cnt"], view["has_rows"] = cnt[b], has[b]
            res.append(finish_device_tail(program, tail, view, self.pg,
                                          params=params))
        return res

    def _shortest_hop(self, sp) -> FrontierHop:
        return FrontierHop(
            edge_label=sp.edge_label, direction=sp.direction,
            edge_pred=None, edge_alias=None, vertex_alias=sp.alias,
            vertex_label=None, vertex_pred=None)

    def _relax(self, sp, d: torch.Tensor, mask, arrs: _HopArrays
               ) -> torch.Tensor:
        """``d ← min(d, relax(d))`` max_hops times; min_hops == 1 seeds
        from the first relaxation so dist 0 never enters (src→src must
        cycle)."""
        if sp.min_hops >= 1:
            d = self._apply_hop(arrs, d, minplus=True)
            iters = sp.max_hops - 1
        else:
            iters = sp.max_hops
        for _ in range(iters):
            d = torch.minimum(d, self._apply_hop(arrs, d, minplus=True))
        if mask is not None:            # head label/pred: unreachable = inf
            d = torch.where(mask > 0, d, torch.inf)
        return d

    # -------------------------------------------------------------- execute
    def execute(self, plan: LogicalPlan,
                params_list: Sequence[Optional[Dict[str, Any]]]
                ) -> List[Dict[str, np.ndarray]]:
        """Run one admission batch (same template, per-query params) as one
        device pass; raises ValueError when the plan does not lower.

        The batch is padded to a power-of-two width (repeating the last
        query; its rows are sliced off the result) so the [B, N] shapes
        repeat across admission chunks."""
        if not params_list:
            return []
        B0 = len(params_list)
        bucket = 1 << max(0, int(B0 - 1).bit_length())
        if bucket > B0:
            params_list = list(params_list) \
                + [params_list[-1]] * (bucket - B0)
        return self._execute_batch(plan, params_list)[:B0]

    def _execute_batch(self, plan: LogicalPlan,
                       params_list: Sequence[Optional[Dict[str, Any]]]
                       ) -> List[Dict[str, np.ndarray]]:
        program = plan if isinstance(plan, FrontierProgram) \
            else self.program_for(plan)
        if program is None:
            raise ValueError("plan has no fragment-executable prefix; "
                             "route it to the interpreter instead "
                             "(cbo.should_use_fragment_path gates this)")
        params_list = [p or {} for p in params_list]
        if program.shortest is not None:
            return self._execute_shortest(program, params_list)
        B, n = len(params_list), self.pg.n_vertices
        src = self._stage_mask(program.source_alias, program.source_label,
                               program.source_pred, params_list)
        if src is None:                      # unfiltered scan: all vertices
            x0 = torch.ones((B, n), dtype=torch.float32, device=self.device)
        else:
            x0 = src.expand(B, n).contiguous()
        masks = tuple(
            self._stage_mask(h.vertex_alias, h.vertex_label, h.vertex_pred,
                             params_list)
            for h in program.hops)
        hops = tuple(self._hop_arrays(h) for h in program.hops)
        tail = self._device_tail(program) if self.device_tail \
            and program.tail else None
        if tail is not None:
            try:
                pvals = self._tail_pvals(tail, params_list)
                props = {p: self._tail_prop(p) for p in tail.prop_refs}
                if self.pg.n_vertices >= _F32_INT_LIMIT:
                    raise TailDataFallback(
                        "vertex ids exceed float32 exact-integer range")
                outd = self._run_tail(program, tail, x0, masks, pvals, hops,
                                      props)
            except TailDataFallback:
                outd = None            # data can't ride f32: interpreter tail
            if outd is not None:
                counts = outd["counts"].cpu().numpy()
                if float(outd["peak"]) >= 2 ** 24 \
                        or counts.max(initial=0.0) >= 2 ** 24:
                    # prefix counts themselves are inexact — the same
                    # contract finish_frontier enforces: the serving layer
                    # catches OverflowError and reruns on the interpreter
                    raise OverflowError(
                        f"frontier path count exceeds float32 exact-integer "
                        f"range (2^24); rerun on the interpreter")
                if float(outd["tail_peak"]) < 2 ** 24:
                    self.tail_stats["device"] += 1
                    return self._finish_tail(program, tail, outd, counts,
                                             params_list)
                # tail arithmetic overflowed but the counts are exact:
                # finish through the interpreter tail, no device re-run
                self.tail_stats["interpreter"] += 1
                return [finish_frontier(program, counts[b], self.pg,
                                        params=params_list[b])
                        for b in range(B)]
        counts, peak = self._prefix(program, x0, masks, hops)
        if float(peak) >= 2 ** 24:
            # same contract as finish_frontier's final check, but covers
            # intermediate powers of accumulated var-length stages whose
            # inexact counts may not survive into the final frontier
            raise OverflowError(
                f"frontier path count {float(peak):.0f} exceeds float32 "
                f"exact-integer range (2^24); rerun on the interpreter")
        counts = counts.cpu().numpy()
        if program.tail:
            self.tail_stats["interpreter"] += 1
        return [finish_frontier(program, counts[b], self.pg,
                                params=params_list[b])
                for b in range(B)]

    def _execute_shortest(self, program: FrontierProgram, params_list
                          ) -> List[Dict[str, np.ndarray]]:
        """shortestPath() batch: one [R, N] tropical distance matrix over
        the R flattened (query, source) pairs, relaxed max_hops times."""
        sp = program.shortest
        B, n = len(params_list), self.pg.n_vertices
        src = self._stage_mask(program.source_alias, program.source_label,
                               program.source_pred, params_list)
        if src is None:
            m = np.ones((B, n), bool)
        else:
            ms = src.cpu().numpy() > 0
            m = np.broadcast_to(ms, (B, n)) if ms.ndim == 1 else ms
        qidx, srcs = np.nonzero(m)
        R = len(srcs)
        if R * n > (1 << 26):
            raise OverflowError(
                f"shortestPath frontier too large ({R} sources x "
                f"{n} vertices); rerun on the interpreter")
        head = self._stage_mask(sp.alias, sp.vertex_label, sp.vertex_pred,
                                params_list)
        hm_rows = None
        if head is not None and R:
            hm_rows = (head[self._tensor(qidx, torch.int64)]
                       if head.dim() == 2 else head.expand(R, n))
        if R == 0:
            dists = np.zeros((0, n), np.float32)
        else:
            d0 = np.full((R, n), np.inf, np.float32)
            d0[np.arange(R), srcs] = 0.0
            arrs = self._hop_arrays(self._shortest_hop(sp))
            dists = self._relax(sp, self._tensor(d0), hm_rows,
                                arrs).cpu().numpy()
        return [finish_shortest(program, srcs[qidx == b], dists[qidx == b],
                                self.pg, params=params_list[b])
                for b in range(B)]

    def _stage_mask(self, alias: str, label: Optional[int], pred,
                    params_list: Sequence[Dict[str, Any]]):
        """One stage's device mask: None when the stage filters nothing,
        a cached static [N] tensor when the predicate is param-free, a
        per-query [B, N] tensor otherwise."""
        if label is None and pred is None:
            return None
        if pred is None or not _expr_has_param(pred.expr):
            key = (label, repr(pred))
            cached = self._masks.get(key)
            if cached is None:
                cached = self._tensor(frontier_vertex_mask(
                    alias, label, pred, self.pg,
                    params_list[0] if params_list else {}
                ).astype(np.float32))
                self._masks[key] = cached
            return cached
        B, n = len(params_list), self.pg.n_vertices
        out = np.empty((B, n), np.float32)
        for b, params in enumerate(params_list):
            out[b] = frontier_vertex_mask(alias, label, pred, self.pg,
                                          params).astype(np.float32)
        return self._tensor(out)
