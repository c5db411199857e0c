"""Parameterized-plan cache for the serving layer (DESIGN.md §6).

The paper's 2.4× LDBC-interactive throughput comes from the serving path:
queries are compiled *once* into stored plans and executed concurrently —
never re-parsed per request. This module provides the compiled-plan side:
an LRU cache keyed by (query template, language, optimizer flags), so
repeated traffic skips parse + RBO + CBO entirely and only pays
``LogicalPlan.bind(params)`` + execution.

Keys are plain hashable tuples (built by :func:`plan_key`), which keeps the
cache usable from the engines without importing the serving package at
module-load time.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple


def _normalize_template(template: str) -> str:
    """Collapse runs of whitespace *outside* string literals; quoted
    regions pass through verbatim so ``{name: 'A  B'}`` and
    ``{name: 'A B'}`` never collide on one cache entry."""
    out = []
    i, n = 0, len(template)
    in_ws = False
    while i < n:
        ch = template[i]
        if ch in "'\"":
            j = i + 1
            while j < n and template[j] != ch:
                j += 1
            out.append(template[i:j + 1])
            i = j + 1
            in_ws = False
        elif ch.isspace():
            if not in_ws:
                out.append(" ")
                in_ws = True
            i += 1
        else:
            out.append(ch)
            in_ws = False
            i += 1
    return "".join(out).strip()


def plan_key(template: str, language: str = "cypher",
             rbo: bool = True, cbo: bool = True) -> Tuple:
    """Canonical cache key: whitespace-normalized template + compile flags.

    Two textually different spellings of the same template (line breaks,
    indentation) hit the same entry; different optimizer settings never
    share a compiled plan.
    """
    return (_normalize_template(template), language,
            ("rbo", rbo), ("cbo", cbo))


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}


class PlanCache:
    """LRU cache for compiled (post-RBO/CBO, still-parameterized) plans.

    ``on_evict(key)`` is called for each LRU-evicted entry so owners of
    derived state (e.g. the serving layer's registered stored procedures)
    can drop it and stay bounded by cache capacity.

    Thread safety: the always-on scheduler (DESIGN.md §12) compiles on its
    dispatcher thread while user threads may call ``session.execute``
    concurrently, so LRU reordering and the hit/miss counters are guarded
    by one reentrant lock (``move_to_end`` during a concurrent iteration
    corrupts the OrderedDict; ``stats.hits += 1`` drops increments).
    ``on_evict`` fires while the lock is held — keep eviction callbacks
    lock-free (the serving layer's only pops dicts and unregisters a
    stored procedure).
    """

    def __init__(self, capacity: int = 128,
                 on_evict: Optional[Callable[[Hashable], None]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.on_evict = on_evict
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: Hashable):
        """Return the cached plan or ``None``; counts a hit or a miss."""
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.stats.hits += 1
                return self._entries[key]
            self.stats.misses += 1
            return None

    def peek(self, key: Hashable):
        """The cached plan (or ``None``) WITHOUT touching LRU order or the
        hit/miss counters — the incremental rebind re-resolves carried
        routes against the new catalog, and that bookkeeping sweep must
        not distort cache stats or keep cold templates artificially
        warm."""
        with self._lock:
            return self._entries.get(key)

    def put(self, key: Hashable, plan: Any) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
            self._entries[key] = plan
            while len(self._entries) > self.capacity:
                evicted_key, _ = self._entries.popitem(last=False)
                self.stats.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(evicted_key)

    def get_or_compile(self, key: Hashable, compile_fn: Callable[[], Any]):
        """``(plan, cached)`` — compile and insert on miss.

        The compile runs *outside* the lock so a slow cold compile never
        stalls concurrent lookups; two racing threads may both compile the
        same key (plans are pure values — last insert wins)."""
        plan = self.get(key)
        if plan is not None:
            return plan, True
        plan = compile_fn()
        self.put(key, plan)
        return plan, False

    def clear(self) -> None:
        """Drop all entries (each through ``on_evict``, so derived state
        like registered procedures is released too) and reset counters."""
        with self._lock:
            keys = list(self._entries)
            self._entries.clear()
            if self.on_evict is not None:
                for key in keys:
                    self.on_evict(key)
            self.stats = CacheStats()
