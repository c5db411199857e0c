"""Procedure registry — the `CALL algo.*` / `CALL gnn.infer` bridge
(DESIGN.md §7, §10).

GIE exposes built-in algorithms as stored procedures callable from the
query languages; this module is that bridge for the reproduction. A
:class:`ProcedureRegistry` wraps the GRAPE analytics engine behind a flat
``name → spec`` table (pagerank / sssp / bfs / wcc / degree_centrality)
and memoizes converged fixpoints per **(store snapshot, algorithm,
canonical args)** so repeated serving traffic reuses the result instead of
re-iterating. Snapshot identity honors GART MVCC: two snapshots of one
store at the same version share a memo entry, so a query pinned at
version v always sees analytics computed at version v.

The learning stack plugs into the same bridge from the other side:
``register_model`` installs a trained model's ``(store) → scores[N]``
serving function under a name, and ``CALL gnn.infer($model) YIELD v,
score`` runs it like any procedure — memoized per **(snapshot, model name,
model registration version)**, so re-registering a retrained model never
serves a stale memo entry while an unchanged registration reuses its
scores across serving traffic (lifetimes: DESIGN.md §10).

Results come back as dense ``np.ndarray[N]`` host arrays trimmed to the
store's vertex range (GRAPE pads fragments to a common width; the padding
tail never leaks into query results). The GRAPE engine (and torch with
it) is imported lazily on the first ``run``, keeping this module — and
the parser, which reads :data:`RESULT_NAMES` — cheap to import.

The registry's ``device`` is where its GRAPE engines run (``None`` =
CUDA, raising when CUDA is absent); on the GPU the ``sum`` combiner runs
the sorted-segment-sum kernel (``use_kernels=True``, the default).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProcedureSpec:
    """One registered algorithm: argument schema + default YIELD name."""

    name: str
    params: Tuple[Tuple[str, Any], ...]   # ((arg name, default), ...)
    result: str                           # default score column name
    runner: Callable                      # (engine, *args) -> array[N]
    # fixpoint accepts warm_start= (a previous snapshot's solution); the
    # incremental contract per algorithm is documented in DESIGN.md §15
    warmable: bool = False

    def canonical_args(self, args: Sequence[Any],
                       kwargs: Optional[Dict[str, Any]] = None) -> Tuple:
        """Positional args + kwargs + defaults → one canonical tuple (the
        memo key component). Numeric casts make ``0.85`` and ``.85`` and a
        numpy scalar all hit the same entry."""
        kwargs = dict(kwargs or {})
        if len(args) > len(self.params):
            raise TypeError(f"{self.name} takes at most {len(self.params)} "
                            f"args, got {len(args)}")
        out = []
        for i, (pname, default) in enumerate(self.params):
            if i < len(args):
                val = args[i]
            elif pname in kwargs:
                val = kwargs.pop(pname)
            else:
                val = default
            if isinstance(default, str):
                out.append(str(val))
            elif isinstance(default, int):
                out.append(int(val))
            else:
                out.append(float(val))
        if kwargs:
            raise TypeError(f"{self.name} got unexpected args "
                            f"{sorted(kwargs)}")
        return tuple(out)


def _host(result) -> np.ndarray:
    """A runner's result as a host array (a torch tensor may live on the
    GPU)."""
    if hasattr(result, "detach"):
        return result.detach().cpu().numpy()
    return np.asarray(result)


def _run_pagerank(engine, damping, warm_start=None):
    from repro_torch.engines.grape.algorithms import pagerank
    return pagerank(engine, damping=damping, warm_start=warm_start)


def _run_sssp(engine, source, warm_start=None):
    from repro_torch.engines.grape.algorithms import sssp
    return sssp(engine, source=source, warm_start=warm_start)


def _run_bfs(engine, source, warm_start=None):
    from repro_torch.engines.grape.algorithms import bfs
    return bfs(engine, source=source, warm_start=warm_start)


def _run_wcc(engine, warm_start=None):
    from repro_torch.engines.grape.algorithms import wcc
    return wcc(engine, warm_start=warm_start)


def _run_degree_centrality(engine):
    from repro_torch.engines.grape.algorithms import degree_centrality
    return degree_centrality(engine)


# the learning↔query bridge: runs a model registered with
# ``ProcedureRegistry.register_model`` (no GRAPE engine involved)
GNN_INFER = "gnn.infer"


class _StorePin:
    """LRU slot for a snapshot seen only by ``gnn.infer``: no GRAPE engine
    exists, but the store must stay alive while its memo entries do —
    identity-fallback tokens are ids, and a recycled id must never serve a
    dead graph's scores."""

    __slots__ = ("store",)

    def __init__(self, store):
        self.store = store

SPECS: Dict[str, ProcedureSpec] = {
    "pagerank": ProcedureSpec("pagerank", (("damping", 0.85),), "rank",
                              _run_pagerank, warmable=True),
    "sssp": ProcedureSpec("sssp", (("source", 0),), "dist", _run_sssp,
                          warmable=True),
    "bfs": ProcedureSpec("bfs", (("source", 0),), "depth", _run_bfs,
                         warmable=True),
    "wcc": ProcedureSpec("wcc", (), "comp", _run_wcc, warmable=True),
    "degree_centrality": ProcedureSpec("degree_centrality", (), "centrality",
                                       _run_degree_centrality),
    GNN_INFER: ProcedureSpec(GNN_INFER, (("model", "default"),), "score",
                             None),
}

# parser-facing: default YIELD score column per algorithm
RESULT_NAMES: Dict[str, str] = {n: s.result for n, s in SPECS.items()}


def normalize_proc_name(name: str) -> str:
    """Strip the ``algo.`` namespace; validate against the registry."""
    short = name[5:] if name.startswith("algo.") else name
    if short not in SPECS:
        raise KeyError(f"unknown procedure {name!r}; available: "
                       f"{sorted(SPECS)}")
    return short


def snapshot_token(store) -> Tuple:
    """Identity of a store *state* for memoization. MVCC snapshots expose
    ``snapshot_token`` (GART: (store uid, version)) so distinct snapshot
    objects at one version share memoized results; immutable stores fall
    back to object identity (the registry keeps the store alive through
    its engine cache, so ids are never recycled underneath us)."""
    tok = getattr(store, "snapshot_token", None)
    if tok is not None:
        return tuple(tok)
    return ("obj", id(store))


@dataclasses.dataclass
class RegistryStats:
    hits: int = 0
    misses: int = 0
    warm_starts: int = 0       # misses served by warm-started fixpoints

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ProcedureRegistry:
    """Memoizing executor for `CALL algo.*` plans.

    One registry can serve many stores/snapshots: the store is passed per
    ``run`` call, and both the per-snapshot GRAPE engine and every
    converged result are cached under the snapshot token. Share a single
    registry across QueryService instances pinned at different GART
    versions to get cross-version reuse with per-version correctness.

    The cache is LRU-bounded *per snapshot token* (``max_snapshots``): a
    streaming store minting a new version every wave would otherwise pin
    one GRAPE engine plus result arrays per version forever. Evicting a
    token drops its engine and all its memoized results together.
    """

    def __init__(self, n_frags: int = 1, use_kernels: bool = True,
                 max_snapshots: int = 8, device=None):
        if max_snapshots < 1:
            raise ValueError("max_snapshots must be >= 1")
        self.n_frags = n_frags
        self.use_kernels = use_kernels
        self.device = device
        self.max_snapshots = max_snapshots
        # token → GrapeEngine, or a _StorePin for tokens only seen by
        # gnn.infer (no engine needed, but the slot shares the LRU
        # accounting and keeps the store alive for its memo entries)
        self._engines: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._results: Dict[Tuple, np.ndarray] = {}
        # warm-start lineage: (store uid, name, canon) → (version, result)
        # of the NEWEST converged fixpoint per store — a later version of
        # the same MVCC store warm-starts from it (append-only contract,
        # DESIGN.md §15). Bounded: one entry per (store, algo, args), and
        # evicting a token drops its store's entries.
        self._latest: Dict[Tuple, Tuple[int, np.ndarray]] = {}
        # name → (serving fn, registration version); versions are monotonic
        # so a re-registered model never hits the old version's memo entries
        self._models: Dict[str, Tuple[Callable, int]] = {}
        self._model_seq = 0
        self.stats = RegistryStats()

    def __contains__(self, name: str) -> bool:
        try:
            normalize_proc_name(name)
            return True
        except KeyError:
            return False

    def spec(self, name: str) -> ProcedureSpec:
        return SPECS[normalize_proc_name(name)]

    # ------------------------------------------------------- trained models
    def register_model(self, name: str, infer_fn: Callable) -> None:
        """Install (or replace) a trained model's ``(store) → scores[N]``
        serving function as the target of ``CALL gnn.infer(name)``."""
        self._model_seq += 1
        self._models[str(name)] = (infer_fn, self._model_seq)
        # old-version memo entries are unreachable once the version bumps;
        # purge them or a retrain loop leaks one score array per cycle
        self._drop_model_results(str(name))

    def unregister_model(self, name: str) -> None:
        self._models.pop(str(name), None)
        self._drop_model_results(str(name))

    def _drop_model_results(self, name: str) -> None:
        self._results = {
            k: v for k, v in self._results.items()
            if not (k[1] == GNN_INFER and k[2][0] == name
                    and k[2][1] != self._models.get(name, (None, -1))[1])}

    # --------------------------------------------------------- LRU plumbing
    def _evict(self) -> None:
        while len(self._engines) > self.max_snapshots:
            evicted, _ = self._engines.popitem(last=False)
            self._results = {k: v for k, v in self._results.items()
                             if k[0] != evicted}
            self._latest = {k: v for k, v in self._latest.items()
                            if k[0] != evicted[:-1]}

    def _touch_token(self, token: Tuple, store=None,
                     create: bool = True) -> None:
        if token in self._engines:
            self._engines.move_to_end(token)     # keep hot tokens alive
            return
        if create:
            # identity-fallback tokens (('obj', id(store))) are only valid
            # while the store object lives: pin it, or a recycled id could
            # serve another graph's memoized scores
            self._engines[token] = _StorePin(store)
            self._evict()

    def _engine(self, store, token: Tuple):
        eng = self._engines.get(token)
        if eng is None or isinstance(eng, _StorePin):
            from repro_torch.engines.grape import GrapeEngine
            eng = GrapeEngine(store, n_frags=self.n_frags,
                              use_kernels=self.use_kernels,
                              device=self.device)
            self._engines[token] = eng
            self._evict()
        self._engines.move_to_end(token)         # LRU order on reuse
        return eng

    def run(self, store, name: str, args: Sequence[Any] = (),
            kwargs: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Execute (or reuse) one procedure against one store snapshot;
        returns the dense per-vertex result, length ``store.n_vertices``."""
        spec = self.spec(name)
        canon = spec.canonical_args(args, kwargs)
        infer_fn = None
        if spec.name == GNN_INFER:
            entry = self._models.get(canon[0])
            if entry is None:
                raise KeyError(f"no model {canon[0]!r} registered for "
                               f"gnn.infer; registered: "
                               f"{sorted(self._models)}")
            infer_fn, version = entry
            canon = (canon[0], version)
        token = snapshot_token(store)
        key = (token, spec.name, canon)
        cached = self._results.get(key)
        if cached is not None:
            self.stats.hits += 1
            self._touch_token(token, create=False)
            return cached
        self.stats.misses += 1
        if infer_fn is not None:
            # LRU slot pinning the store; no GRAPE engine needed
            self._touch_token(token, store)
            result = _host(infer_fn(store))
        else:
            engine = self._engine(store, token)
            # warm-start from the newest earlier fixpoint of the SAME MVCC
            # store (versioned tokens only: ('gart', uid, version)); the
            # append-only contract makes this sound — bit-exact for the
            # min-propagation algorithms, same tolerance for pagerank
            # (DESIGN.md §15)
            warm = None
            lineage = None
            if spec.warmable and len(token) == 3 \
                    and isinstance(token[-1], int):
                lineage = (token[:-1], spec.name, canon)
                prev = self._latest.get(lineage)
                if prev is not None and prev[0] < token[-1]:
                    warm = prev[1]
            if warm is not None:
                result = _host(spec.runner(engine, *canon,
                                           warm_start=warm))
                self.stats.warm_starts += 1
            else:
                result = _host(spec.runner(engine, *canon))
        result = result[:store.n_vertices]        # drop fragment padding
        self._results[key] = result
        if infer_fn is None and spec.warmable and lineage is not None:
            prev = self._latest.get(lineage)
            if prev is None or prev[0] <= token[-1]:
                self._latest[lineage] = (token[-1], result)
        return result

    def clear(self, results_only: bool = True) -> None:
        """Drop memoized fixpoints; with ``results_only=False`` also drop
        the per-snapshot engines (full cold start, re-partitions).
        Registered models survive — they are registrations, not caches
        (``unregister_model`` removes one)."""
        self._results.clear()
        self._latest.clear()
        if not results_only:
            self._engines.clear()
        self.stats = RegistryStats()
