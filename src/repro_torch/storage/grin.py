"""GRIN — unified Graph Retrieval INterface (paper §4.1), adapted to JAX.

The paper defines GRIN as a C-ABI trait system: a storage backend announces
the *traits* (capabilities) it supports; an engine declares the traits it
requires, and any (engine × storage) pair whose traits match interlocks.

TPU adaptation: iterator traits become *batched array* traits — every
retrieval API yields dense numpy/jnp arrays (CSR ``indptr/indices``,
property columns) because the engines consume tensors. The trait-matching
contract (and the <8% overhead claim of Exp-1b) is preserved: engines are
written once against :class:`GRINAdapter` and run unchanged on CSR (Vineyard
analogue), GART (MVCC dynamic) and GraphAr (archive) backends.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


class Traits(enum.Flag):
    NONE = 0
    # topology
    TOPOLOGY_ARRAY = enum.auto()       # CSR-style (indptr, indices) access
    TOPOLOGY_CSC = enum.auto()         # reverse adjacency
    DEGREE = enum.auto()
    # property
    VERTEX_PROPERTY = enum.auto()
    EDGE_PROPERTY = enum.auto()
    VERTEX_LABEL = enum.auto()
    EDGE_LABEL = enum.auto()
    # partition
    PARTITIONED = enum.auto()
    # index
    INDEX_INTERNAL_ID = enum.auto()    # contiguous internal vertex ids
    INDEX_LABEL = enum.auto()          # per-label vertex index
    # predicate
    PREDICATE_PUSHDOWN = enum.auto()   # storage-level filtering (GraphAr)
    # mutation / versioning
    MUTABLE = enum.auto()
    MVCC_SNAPSHOT = enum.auto()
    # archive
    CHUNKED = enum.auto()              # chunk-pruned loading


# trait sets required by each engine (checked at deployment build time)
ANALYTICS_REQUIRED = Traits.TOPOLOGY_ARRAY | Traits.DEGREE
QUERY_REQUIRED = (Traits.TOPOLOGY_ARRAY | Traits.VERTEX_LABEL |
                  Traits.VERTEX_PROPERTY)
LEARNING_REQUIRED = Traits.TOPOLOGY_ARRAY | Traits.VERTEX_PROPERTY


@runtime_checkable
class GRINStore(Protocol):
    """What a storage backend must provide (duck-typed protocol)."""

    def traits(self) -> Traits: ...

    @property
    def n_vertices(self) -> int: ...

    @property
    def n_edges(self) -> int: ...

    def adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr [N+1], indices [E]) out-adjacency."""
        ...


class GRINAdapter:
    """The engine-facing handle: validates traits once, then exposes the
    uniform retrieval API. Raises at *composition* time (flexbuild) if the
    store lacks a required trait — the LEGO bricks refuse to interlock."""

    def __init__(self, store: Any, required: Traits = Traits.NONE):
        missing = required & ~store.traits()
        if missing:
            raise TypeError(
                f"storage {type(store).__name__} lacks required GRIN traits: "
                f"{missing}")
        self.store = store

    # ---- topology ----------------------------------------------------------
    def traits(self) -> Traits:
        return self.store.traits()

    @property
    def n_vertices(self) -> int:
        return self.store.n_vertices

    @property
    def n_edges(self) -> int:
        return self.store.n_edges

    def adjacency(self):
        return self.store.adjacency()

    def csc(self):
        if not (self.store.traits() & Traits.TOPOLOGY_CSC):
            raise TypeError("store lacks TOPOLOGY_CSC")
        return self.store.csc()

    def degrees(self) -> np.ndarray:
        indptr, _ = self.store.adjacency()
        return np.diff(indptr)

    def neighbors(self, v: int) -> np.ndarray:
        indptr, indices = self.store.adjacency()
        return indices[indptr[v]:indptr[v + 1]]

    # ---- property ----------------------------------------------------------
    def vertex_prop(self, name: str) -> np.ndarray:
        return self.store.vertex_prop(name)

    def edge_prop(self, name: str) -> np.ndarray:
        return self.store.edge_prop(name)

    def vertex_labels(self) -> np.ndarray:
        return self.store.vertex_labels()

    def edge_labels(self) -> np.ndarray:
        return self.store.edge_labels()

    # ---- predicate pushdown -------------------------------------------------
    def scan_vertices(self, label: Optional[int] = None,
                      prop: Optional[str] = None,
                      value: Any = None) -> np.ndarray:
        """Vertex ids matching (label, prop==value); pushed into the storage
        when it supports PREDICATE_PUSHDOWN, else evaluated here."""
        t = self.store.traits()
        if t & Traits.PREDICATE_PUSHDOWN and hasattr(self.store, "scan_vertices"):
            return self.store.scan_vertices(label=label, prop=prop, value=value)
        ids = np.arange(self.store.n_vertices)
        if label is not None and t & Traits.VERTEX_LABEL:
            ids = ids[self.store.vertex_labels()[ids] == label]
        if prop is not None:
            col = self.store.vertex_prop(prop)
            ids = ids[col[ids] == value]
        return ids
