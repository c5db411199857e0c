"""QueryService — the multi-tenant front door over the query engines
(DESIGN.md §6), read side.

A request is ``(template, params)``: a parameterized query template plus the
values to bind. The service

1. compiles each distinct template once through the shared :class:`PlanCache`
   (parse + RBO + CBO only on a miss),
2. groups pending requests by template and admits them in vectorized batches
   — requests from *different* clients that share a template ride one batch,
3. dispatches each template by shape: plans anchored on an indexed
   ``$param`` equality with a small GLogue-lite cost estimate go to
   HiActor's batched OLTP path; OLAP traversals whose match prefix lowers
   to dense frontier stages and whose estimate clears
   ``cbo.should_use_fragment_path`` execute as one batched device pass on
   the partitioned fragment substrate (DESIGN.md §9), through the CUDA
   kernels on the GPU; hybrid ``CALL algo.*`` plans (route ``grape``) run
   per request on Gaia's interpreter, which sources its rows from the
   GRAPE fixpoint that :class:`ProcedureRegistry` memoizes per snapshot
   (on the GPU the fixpoint's ``sum`` combiner is the segment-sum
   kernel); everything else executes on Gaia's interpreter with the
   cached plan re-bound per request,
4. reports per-query latency and aggregate QPS per flush.

Write plans (route ``write``) are recognised and rejected with
``NotImplementedError``: the mutable store is not part of this package
yet. Everything the read side derives from the store lives in one
:class:`EngineBinding`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.ir.cbo import (Catalog, is_point_lookup,
                                     should_use_fragment_path)
from repro_torch.core.ir.dag import ProcedureCall, plan_is_write
from repro_torch.device import resolve_device
from repro_torch.engines.gaia import GaiaEngine
from repro_torch.engines.hiactor import HiActorEngine
from repro_torch.engines.procedures import ProcedureRegistry
from repro_torch.serving.plan_cache import PlanCache, plan_key
from repro_torch.storage.lpg import PropertyGraph


# Errors a single request can legitimately produce: bad templates
# (SyntaxError from the parsers), unbound/mistyped params and missing
# columns (LookupError), type mismatches, data-dependent arithmetic
# failures (ArithmeticError covers the float32-exactness OverflowError),
# unsupported operator shapes and routes, and permission rejections.
# Admission catches exactly these and converts them to request
# rejections; anything else — KeyboardInterrupt/SystemExit, assertion
# failures, a corrupted binding — is an internal fault that must surface
# (DESIGN.md §14).
REQUEST_ERRORS: Tuple[type, ...] = (
    SyntaxError, ValueError, LookupError, TypeError, ArithmeticError,
    NotImplementedError, PermissionError)


@dataclasses.dataclass
class Request:
    template: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    language: str = "cypher"


@dataclasses.dataclass
class Response:
    result: Dict[str, np.ndarray]
    engine: str          # "gaia" | "hiactor" | "fragment" | "grape"
    cached: bool         # plan-cache hit at admission time
    latency_us: float    # wall time of the admission batch this query
    #                      rode
    # time spent waiting for dispatch vs executing: the synchronous flush
    # path has no queue of its own (admission IS the flush), so it
    # reports queue_us=0 and service_us=latency_us
    queue_us: float = 0.0
    service_us: float = 0.0


@dataclasses.dataclass
class ServingStats:
    n_queries: int
    wall_us: float
    qps: float
    latencies_us: List[float]
    route_counts: Dict[str, int]
    cache: Dict[str, float]

    # empty-window guards use len() rather than truthiness: callers hand in
    # lists OR numpy arrays, and a 2+-element ndarray raises on bool()
    # while an empty one is falsy either way. An empty window reports
    # 0.0, never raises.
    @property
    def mean_latency_us(self) -> float:
        return (float(np.mean(self.latencies_us))
                if len(self.latencies_us) else 0.0)

    @property
    def p95_latency_us(self) -> float:
        return (float(np.percentile(self.latencies_us, 95))
                if len(self.latencies_us) else 0.0)

    def summary(self) -> str:
        routes = ", ".join(f"{k}={v}" for k, v in
                           sorted(self.route_counts.items())) or "none"
        return (f"{self.n_queries} queries in {self.wall_us / 1e3:.1f} ms "
                f"({self.qps:.0f} qps); latency mean "
                f"{self.mean_latency_us:.0f} us / p95 "
                f"{self.p95_latency_us:.0f} us; routes: {routes}; "
                f"cache hit-rate {self.cache['hit_rate']:.2f}")


@dataclasses.dataclass
class EngineBinding:
    """The read-side state over one store: both engines plus the maps
    derived against them. ``routes``/``proc_names`` grow monotonically
    (resolution is memoized, never invalidated in place)."""

    gaia: GaiaEngine
    hiactor: HiActorEngine
    version: Optional[int]
    routes: Dict[Tuple, str] = dataclasses.field(default_factory=dict)
    proc_names: Dict[Tuple, str] = dataclasses.field(default_factory=dict)


class QueryService:
    """Concurrent query serving over one store with both engines attached.
    ``device`` is where the fragment and grape routes run (``None`` =
    CUDA; raises when CUDA is absent)."""

    def __init__(self, store, *, catalog: Optional[Catalog] = None,
                 cache_capacity: int = 128, batch_size: int = 64,
                 row_threshold: float = 2e4,
                 rbo: bool = True, cbo: bool = True,
                 fragment: bool = True, n_frags: int = 1,
                 fragment_min_cost: float = 256.0,
                 device_tail: bool = True,
                 procedures: Optional[ProcedureRegistry] = None,
                 device=None):
        self.device = resolve_device(device)
        self.cache = PlanCache(cache_capacity, on_evict=self._on_plan_evicted)
        self.batch_size = max(1, int(batch_size))
        self.row_threshold = row_threshold
        self.rbo = rbo
        self.cbo = cbo
        # dense fragment path for eligible OLAP traversals (DESIGN.md §9)
        self.fragment = fragment
        self.n_frags = max(1, int(n_frags))
        self.fragment_min_cost = fragment_min_cost
        # lower eligible relational tails into the fragment batch's device
        # pass (DESIGN.md §14); off = interpreter tail
        self.device_tail = device_tail
        # CALL algo.* registry; pass a shared one to reuse memoized
        # fixpoints across services over the same snapshot
        self.procedures = procedures or ProcedureRegistry(device=self.device)
        self._queue: List[Request] = []
        self._proc_seq = 0                # monotonic: names never reused
        # stored-procedure registration is the one binding mutation that
        # can race (a caller executing while another resolves a template)
        self._reg_lock = threading.Lock()
        self._binding = self._make_binding(store, catalog)
        self.last_stats: Optional[ServingStats] = None

    def _make_binding(self, store, catalog: Optional[Catalog]
                      ) -> EngineBinding:
        pg = store if isinstance(store, PropertyGraph) \
            else PropertyGraph(store)     # one facade: engines share the
        # adjacency caches (reverse CSR, label slices)
        gaia = GaiaEngine(pg, catalog=catalog, rbo=self.rbo, cbo=self.cbo,
                          plan_cache=self.cache, procedures=self.procedures,
                          device=self.device)
        hiactor = HiActorEngine(pg, catalog=gaia.catalog,
                                procedures=self.procedures)
        return EngineBinding(gaia, hiactor,
                             getattr(pg.grin.store, "version", None))

    @property
    def gaia(self) -> GaiaEngine:
        return self._binding.gaia

    @property
    def hiactor(self) -> HiActorEngine:
        return self._binding.hiactor

    def _on_plan_evicted(self, key) -> None:
        """Cache eviction drops the matching stored procedure too, so the
        registry stays bounded by cache capacity and a later recompile
        never executes a stale registered plan."""
        b = self._binding
        b.routes.pop(key, None)
        pname = b.proc_names.pop(key, None)
        if pname is not None:
            b.hiactor.unregister(pname)

    # ------------------------------------------------------------- compile
    def compile(self, template: str, language: str = "cypher"):
        """``(plan, cached)`` through the shared plan cache."""
        return self.gaia.compile_cached(template, language)

    # ----------------------------------------------------- route + execute
    def route_for_plan(self, plan, catalog: Catalog) -> str:
        """One template's route: a pure function of the plan + service
        config + catalog stats."""
        if plan_is_write(plan):
            return "write"
        if any(isinstance(op, ProcedureCall) for op in plan.ops):
            return "grape"
        if is_point_lookup(plan, catalog, self.row_threshold):
            return "hiactor"
        if self.fragment and should_use_fragment_path(
                plan, catalog, self.fragment_min_cost,
                self.row_threshold):
            # heavy traversal template: the whole admission batch
            # becomes one device pass over the fragment substrate's
            # [B, N] frontier matrices (DESIGN.md §9)
            return "fragment"
        return "gaia"

    def resolve_route(self, binding: EngineBinding, key: Tuple,
                      plan) -> str:
        """The route of one compiled template, memoized per binding."""
        route = binding.routes.get(key)
        if route is None:
            route = self.route_for_plan(plan, binding.gaia.catalog)
            binding.routes[key] = route
        return route

    def ensure_procedure(self, binding: EngineBinding, key: Tuple,
                         plan) -> str:
        """Register ``plan`` as a HiActor stored procedure on ``binding``
        (idempotent, thread-safe)."""
        with self._reg_lock:
            pname = binding.proc_names.get(key)
            if pname is None or not binding.hiactor.has_procedure(pname):
                pname = f"__svc_{self._proc_seq}"
                self._proc_seq += 1
                binding.hiactor.register_plan(pname, plan)
                binding.proc_names[key] = pname
            return pname

    def exec_point_batch(self, binding: EngineBinding, key: Tuple, plan,
                         params_list: Sequence[Dict[str, Any]]
                         ) -> List[Dict[str, np.ndarray]]:
        """One vectorized HiActor pass over a same-template micro-batch."""
        pname = self.ensure_procedure(binding, key, plan)
        return binding.hiactor.submit_batch(pname, params_list)

    def exec_fragment_batch(self, binding: EngineBinding, plan,
                            params_list: Sequence[Dict[str, Any]]
                            ) -> Tuple[List[Dict[str, np.ndarray]], str]:
        """One batched device pass over the fragment substrate, through
        the slab kernels; returns ``(results, engine)`` — falls back to
        the interpreter when path counts blow past float32 exactness."""
        try:
            outs = binding.gaia.execute_fragment(
                plan, list(params_list), n_frags=self.n_frags,
                use_kernels=True, device_tail=self.device_tail)
            return outs, "fragment"
        except OverflowError:
            return [binding.gaia.execute_plan(plan.bind(p))
                    for p in params_list], "gaia"

    def exec_interpreted(self, binding: EngineBinding, plan,
                         params: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One OLAP / hybrid CALL request on Gaia's interpreter (for CALL
        plans the procedure memo makes every request after the first reuse
        the converged fixpoint)."""
        return binding.gaia.execute_plan(plan.bind(params))

    # -------------------------------------------------------------- admit
    def submit(self, template: str, params: Optional[Dict[str, Any]] = None,
               language: str = "cypher") -> int:
        """Enqueue one request; returns its position in the next flush."""
        self._queue.append(Request(template, dict(params or {}), language))
        return len(self._queue) - 1

    def flush(self) -> Tuple[List[Response], ServingStats]:
        """Execute all pending requests; responses in submission order.

        Admission compiles and validates every template group first.
        Invalid requests (bad template, unbound params, a write, which
        this package does not serve yet) are dropped, with the first error raised,
        while every valid request goes back on the queue untouched."""
        b = self._binding
        pending, self._queue = self._queue, []
        t0 = time.perf_counter()
        # same-template requests batch together regardless of submitter
        groups: "OrderedDict[Tuple, List[Tuple[int, Request]]]" = OrderedDict()
        for pos, req in enumerate(pending):
            key = plan_key(req.template, req.language, self.rbo, self.cbo)
            groups.setdefault(key, []).append((pos, req))

        admitted = []
        rejected: List[Exception] = []
        for key, items in groups.items():
            first = items[0][1]
            try:
                plan, cached = b.gaia.compile_cached(first.template,
                                                     first.language)
            except REQUEST_ERRORS as e:
                rejected.extend([e] * len(items))
                continue
            # the write route is a pure plan-shape decision (route_for_plan);
            # the others resolve at execution, after earlier groups'
            # HiActor registrations refined the catalog
            if plan_is_write(plan):
                rejected.extend([NotImplementedError(
                    f"template {first.template!r} needs the write route, "
                    f"which this package does not serve yet")] * len(items))
                continue
            needed = plan.param_names()
            valid = []
            for pos, req in items:
                missing = needed - set(req.params)
                if missing:
                    rejected.append(KeyError(
                        f"unbound parameters {sorted(missing)} "
                        f"for template {first.template!r}"))
                    continue
                valid.append((pos, req))
            if valid:
                admitted.append((key, valid, plan, cached))
        if rejected:
            keep = {pos for _, items, _, _ in admitted for pos, _ in items}
            self._queue = [req for pos, req in enumerate(pending)
                           if pos in keep] + self._queue
            raise rejected[0]

        responses: List[Optional[Response]] = [None] * len(pending)
        route_counts: Dict[str, int] = {}
        for key, items, plan, cached in admitted:
            route = self.resolve_route(b, key, plan)
            route_counts[route] = route_counts.get(route, 0) + len(items)
            if route == "hiactor":
                # admission batching: chunks of batch_size per vectorized pass
                for i in range(0, len(items), self.batch_size):
                    chunk = items[i:i + self.batch_size]
                    c0 = time.perf_counter()
                    outs = self.exec_point_batch(
                        b, key, plan, [req.params for _, req in chunk])
                    c_us = (time.perf_counter() - c0) * 1e6
                    for (pos, _), out in zip(chunk, outs):
                        responses[pos] = Response(out, route, cached, c_us,
                                                  service_us=c_us)
            elif route == "fragment":
                for i in range(0, len(items), self.batch_size):
                    chunk = items[i:i + self.batch_size]
                    c0 = time.perf_counter()
                    outs, eng = self.exec_fragment_batch(
                        b, plan, [req.params for _, req in chunk])
                    if eng != route:
                        route_counts[route] -= len(chunk)
                        if not route_counts[route]:
                            del route_counts[route]
                        route_counts[eng] = \
                            route_counts.get(eng, 0) + len(chunk)
                    c_us = (time.perf_counter() - c0) * 1e6
                    for (pos, _), out in zip(chunk, outs):
                        responses[pos] = Response(out, eng, cached, c_us,
                                                  service_us=c_us)
            else:
                # OLAP and hybrid CALL plans execute per request
                # (batch_size plays no role)
                for pos, req in items:
                    c0 = time.perf_counter()
                    out = self.exec_interpreted(b, plan, req.params)
                    c_us = (time.perf_counter() - c0) * 1e6
                    responses[pos] = Response(out, route, cached, c_us,
                                              service_us=c_us)

        wall_us = (time.perf_counter() - t0) * 1e6
        stats = ServingStats(
            n_queries=len(pending), wall_us=wall_us,
            qps=len(pending) / (wall_us / 1e6) if wall_us else 0.0,
            latencies_us=[r.latency_us for r in responses],
            route_counts=route_counts,
            cache=self.cache.stats.snapshot())
        self.last_stats = stats
        return responses, stats

    def serve(self, requests: Sequence[Union[Request, Tuple]]
              ) -> Tuple[List[Response], ServingStats]:
        """Admit a whole stream and flush: the one-call serving loop."""
        for r in requests:
            if isinstance(r, Request):
                self._queue.append(r)
            else:
                self.submit(*r)
        return self.flush()
