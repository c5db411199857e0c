"""Gaia — dataflow engine for OLAP graph queries (paper §5.3, [69]).

Executes one query as a vectorized dataflow over the whole row table;
`run_partitioned` splits the source rows into chunks processed
independently (the data-parallel workers of the real Gaia — on a cluster
each chunk is a worker's partition; here chunks demonstrate the identical
dataflow semantics and feed the scaling benchmark).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir.cbo import Catalog, apply_cbo
from repro_torch.core.ir.codegen import Table, execute_plan
from repro_torch.core.ir.dag import LogicalPlan, ProcedureCall, Scan
from repro_torch.core.ir.parser import parse_cypher, parse_gremlin
from repro_torch.core.ir.rbo import apply_rbo
from repro_torch.storage.lpg import PropertyGraph


class GaiaEngine:
    def __init__(self, store, catalog: Optional[Catalog] = None,
                 rbo: bool = True, cbo: bool = True, plan_cache=None,
                 procedures=None, device=None):
        # accept a prebuilt facade so co-located engines share one set of
        # adjacency caches (reverse CSR, label slices)
        self.pg = store if isinstance(store, PropertyGraph) \
            else PropertyGraph(store)
        self.catalog = catalog or Catalog.build(self.pg)
        self.rbo = rbo
        self.cbo = cbo
        # optional serving-layer PlanCache (anything with get_or_compile);
        # shared across engines so repeated templates skip parse+RBO+CBO
        self.plan_cache = plan_cache
        # where fragment executors run; None resolves to CUDA when the
        # first one is built (the interpreter never touches a device)
        self.device = device
        self._frontier_execs: Dict[Tuple, Any] = {}
        # CALL algo.* executor, created lazily so plain traversal engines
        # never touch the analytics stack (DESIGN.md §7)
        self._procedures = procedures

    @property
    def procedures(self):
        if self._procedures is None:
            from repro_torch.engines.procedures import ProcedureRegistry
            self._procedures = ProcedureRegistry(device=self.device)
        return self._procedures

    # ------------------------------------------------------------- compile
    def compile(self, query: str, language: str = "cypher") -> LogicalPlan:
        return self.compile_cached(query, language)[0]

    def compile_cached(self, query: str, language: str = "cypher"):
        """``(plan, cache_hit)``; compiles cold when no cache is attached."""
        if self.plan_cache is None:
            return self.compile_cold(query, language), False
        from repro_torch.serving.plan_cache import plan_key
        key = plan_key(query, language, self.rbo, self.cbo)
        return self.plan_cache.get_or_compile(
            key, lambda: self.compile_cold(query, language))

    def compile_cold(self, query: str, language: str = "cypher") -> LogicalPlan:
        """Full parse + RBO + CBO, bypassing any plan cache."""
        plan = (parse_cypher(query) if language == "cypher"
                else parse_gremlin(query))
        if self.rbo:
            plan = apply_rbo(plan)
        if self.cbo:
            plan = apply_cbo(plan, self.catalog)
        return plan

    # ------------------------------------------------------------- execute
    def execute(self, query: str, language: str = "cypher",
                params: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
        plan = self.compile(query, language)
        return self.execute_plan(plan, params=params)

    def execute_plan(self, plan: LogicalPlan,
                     params: Optional[Dict[str, Any]] = None):
        procs = self._procedures
        if procs is None and any(isinstance(op, ProcedureCall)
                                 for op in plan.ops):
            procs = self.procedures       # lazy-create on first CALL plan
        return execute_plan(plan, self.pg, params=params, procedures=procs)

    # ------------------------------------------------- fragment frontier
    def fragment_executor(self, n_frags: int = 1, use_kernels: bool = False,
                          device_tail: bool = True):
        """Lazily-built executor for the dense fragment path (DESIGN.md
        §9); one per engine so hop adjacencies and device masks are
        shared across templates."""
        key = (n_frags, use_kernels, device_tail)
        if key not in self._frontier_execs:
            from repro_torch.engines.frontier import FragmentFrontierExecutor
            self._frontier_execs[key] = FragmentFrontierExecutor(
                self.pg, n_frags=n_frags, use_kernels=use_kernels,
                device_tail=device_tail, device=self.device)
        return self._frontier_execs[key]

    def execute_fragment(self, plan: LogicalPlan,
                         params_list: List[Optional[Dict[str, Any]]],
                         n_frags: int = 1, use_kernels: bool = False,
                         device_tail: bool = True
                         ) -> List[Dict[str, np.ndarray]]:
        """Execute one admission batch of a lowered OLAP template as one
        batched device pass over the [B, N] frontier matrix (eligible
        relational tails included — DESIGN.md §14)."""
        ex = self.fragment_executor(n_frags, use_kernels, device_tail)
        return ex.execute(plan, params_list)

    def run_partitioned(self, query: str, n_partitions: int = 4,
                        language: str = "cypher") -> List[Dict[str, np.ndarray]]:
        """Data-parallel execution: the initial Scan's vertex set is split
        into ``n_partitions`` ranges, each running the identical plan."""
        plan = self.compile(query, language)
        scan = plan.ops[0]
        assert isinstance(scan, Scan)
        ids = self.pg.vertices(scan.label)
        parts = np.array_split(ids, n_partitions)
        outs = []
        for part in parts:
            sub = LogicalPlan(list(plan.ops))
            outs.append(_execute_with_source(sub, self.pg, part))
        return outs


def _execute_with_source(plan: LogicalPlan, pg, source_ids: np.ndarray):
    """Execute replacing the initial scan's candidate set (worker partition)."""
    from repro_torch.core.ir.codegen import _LabelAwarePG, _eval_pred

    scan = plan.ops[0]
    t = Table({scan.alias: source_ids}, {})
    lpg = _LabelAwarePG(pg)
    if scan.label is not None:
        t = t.mask(pg.vlabels[source_ids] == scan.label)
    if scan.pred is not None:
        t = t.mask(_eval_pred(scan.pred, t, lpg))
    rest = LogicalPlan(plan.ops[1:])
    return _continue(rest, pg, t)


def _continue(plan: LogicalPlan, pg, table: Table):
    from repro_torch.core.ir import codegen

    # reuse execute_plan's operator loop by prepending the existing table
    return codegen.execute_plan(plan, pg, table=table)
