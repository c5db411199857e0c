"""CSRStore — the Vineyard analogue: immutable, in-memory, zero-copy views.

CSR + (optional) CSC with contiguous internal vertex ids, label arrays and
columnar properties. The construction path (edge list → sorted CSR) is the
shared substrate for GART compaction and GraphAr chunking.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.storage.grin import Traits


def edges_to_csr(n: int, src: np.ndarray, dst: np.ndarray,
                 data: Optional[Dict[str, np.ndarray]] = None):
    """Sort an edge list into CSR. Returns (indptr, indices, perm)."""
    order = np.lexsort((dst, src))
    src_s, dst_s = src[order], dst[order]
    counts = np.bincount(src_s, minlength=n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, dst_s.astype(np.int32), order


def validate_csr_parts(n: int, indptr: np.ndarray, indices: np.ndarray,
                       edge_labels: Optional[np.ndarray] = None,
                       edge_props: Optional[Dict[str, np.ndarray]] = None,
                       what: str = "CSR parts") -> None:
    """Structural sanity of already-sorted CSR arrays before
    :meth:`CSRStore.from_parts` adopts them. The in-process extension
    paths construct parts by arithmetic and skip this; loaders pulling
    arrays off disk (GraphAr archives, durability checkpoints) call it so
    a corrupt file surfaces as a clear error instead of a downstream
    bincount explosion."""
    indptr = np.asarray(indptr)
    if len(indptr) != n + 1 or (n >= 0 and (indptr[0] != 0)):
        raise ValueError(f"{what}: indptr has {len(indptr)} entries for "
                         f"{n} vertices (or does not start at 0)")
    if len(indptr) > 1 and np.any(np.diff(indptr) < 0):
        raise ValueError(f"{what}: indptr is not nondecreasing")
    E = int(indptr[-1]) if len(indptr) else 0
    if len(indices) != E:
        raise ValueError(f"{what}: {len(indices)} indices for "
                         f"indptr[-1]={E}")
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise ValueError(f"{what}: edge targets out of range [0, {n})")
    if edge_labels is not None and len(edge_labels) != E:
        raise ValueError(f"{what}: {len(edge_labels)} edge labels for "
                         f"{E} edges")
    for k, col in (edge_props or {}).items():
        if len(col) != E:
            raise ValueError(f"{what}: edge prop {k!r} has {len(col)} "
                             f"rows for {E} edges")


def topo_base(store):
    """Canonical topology identity of a (possibly shell-shared) CSR: a
    vprops-only snapshot merge wraps the previous merged CSR's arrays in a
    fresh shell tagged ``_topo_base``; lineage checks that compare merged
    CSRs by ``is`` must collapse shells back to the CSR they alias."""
    return getattr(store, "_topo_base", store)


def missing_fill(dtype):
    """The one missing-value convention across vertex AND edge property
    columns: NaN for float dtypes, 0 for integer/bool (DESIGN.md §15)."""
    return np.nan if np.issubdtype(np.dtype(dtype), np.floating) else 0


def _insert_rows_sorted(indptr0: np.ndarray, key0: np.ndarray,
                        new_rows: np.ndarray, new_key: np.ndarray,
                        n: int):
    """Merge ``K`` new (row, key) entries into a row-segmented array whose
    keys are sorted within each row, keeping the within-row key order
    stable: equal keys keep old entries before new ones, and new entries
    in their input order. This is exactly the order a full stable
    ``np.lexsort((key, row))`` over the concatenation would produce, so
    callers composing CSR/CSC/label-slice extensions out of it stay
    bit-identical to a from-scratch rebuild.

    Returns ``(indptr1, old_dest, new_dest)`` — the merged row pointers
    and, for every old/new entry, its position in the merged layout.
    """
    E0, K = len(key0), len(new_key)
    counts_new = np.bincount(new_rows, minlength=n)
    add = np.zeros(n + 1, np.int64)
    np.cumsum(counts_new, out=add[1:])
    indptr1 = indptr0 + add
    # composite (row, key) sort keys: rows dominate, keys order within.
    # key0 is sorted inside each row, so comp0 is globally sorted.
    hi_key = 1
    if E0:
        hi_key = max(hi_key, int(key0.max()) + 1)
    if K:
        hi_key = max(hi_key, int(new_key.max()) + 1)
    if n * hi_key >= 2 ** 62:           # composite would overflow int64
        raise OverflowError("row/key range too large for composite merge")
    row0 = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr0))
    comp0 = row0 * hi_key + np.asarray(key0, np.int64)
    comp_new = (np.asarray(new_rows, np.int64) * hi_key
                + np.asarray(new_key, np.int64))
    s = np.argsort(comp_new, kind="stable")
    comp_new_s = comp_new[s]
    # standard merge arithmetic: ties place old entries first (left/right
    # searchsorted sides), new entries keep input order (stable argsort)
    old_dest = np.arange(E0, dtype=np.int64) + np.searchsorted(
        comp_new_s, comp0, side="left")
    new_dest = np.empty(K, np.int64)
    new_dest[s] = np.arange(K, dtype=np.int64) + np.searchsorted(
        comp0, comp_new_s, side="right")
    return indptr1, old_dest, new_dest


def extend_csr(base: "CSRStore", new_src: np.ndarray, new_dst: np.ndarray,
               new_elabels: Optional[np.ndarray] = None,
               new_eprops: Optional[Dict[str, np.ndarray]] = None,
               vertex_props: Optional[Dict[str, np.ndarray]] = None,
               vertex_labels: Optional[np.ndarray] = None):
    """O(delta·log) CSR extension, bit-identical to rebuilding a
    :class:`CSRStore` from the concatenated ``[base edges, delta edges]``
    list (``edges_to_csr`` lexsorts stably, so equal ``(src, dst)`` keys
    keep base-before-delta order — the same order the within-row stable
    merge produces). When the base carries a CSC it is extended too: old
    entries keep their relative order (``old_pos`` is strictly monotone)
    and new entries merge by ``(dst, src)`` with CSR-position tie order.

    Returns ``(store, old_pos, new_pos)`` — the new store plus the
    mapping from base/delta edge ids to positions in the merged CSR
    (what label-slice and device-slab patching key off).
    """
    n = base.n_vertices
    E0, K = base.n_edges, len(new_src)
    new_src = np.asarray(new_src, np.int64)
    new_dst = np.asarray(new_dst, np.int64)
    indptr1, old_pos, new_pos = _insert_rows_sorted(
        base.indptr, base.indices.astype(np.int64), new_src, new_dst, n)
    E1 = E0 + K
    indices1 = np.empty(E1, np.int32)
    indices1[old_pos] = base.indices
    indices1[new_pos] = new_dst.astype(np.int32)
    elab1 = np.empty(E1, np.int32)
    elab1[old_pos] = base.edge_labels()
    elab1[new_pos] = (np.asarray(new_elabels, np.int32)
                      if new_elabels is not None else 0)
    eprops1: Dict[str, np.ndarray] = {}
    new_eprops = new_eprops or {}
    for k in set(base._eprops) | set(new_eprops):
        b_col = base._eprops.get(k)
        d_col = (np.asarray(new_eprops[k]) if k in new_eprops else None)
        dt = np.promote_types(
            b_col.dtype if b_col is not None else d_col.dtype,
            d_col.dtype if d_col is not None else b_col.dtype)
        col = np.empty(E1, dt)
        col[old_pos] = (b_col if b_col is not None
                        else np.full(E0, missing_fill(dt), dt))
        col[new_pos] = (d_col if d_col is not None
                        else np.full(K, missing_fill(dt), dt))
        eprops1[k] = col
    csc1 = None
    if base._csc is not None:
        cindptr0, csrc0, cmap0 = base._csc
        # feed new entries in new-CSR-position order: for equal (dst, src)
        # the CSC tie-break is CSR position, and old < new always holds
        # (the stable dst-sort put old entries first within the row)
        csr_order = np.argsort(new_pos, kind="stable")
        cindptr1, cold, cnew = _insert_rows_sorted(
            cindptr0, csrc0.astype(np.int64),
            new_dst[csr_order], new_src[csr_order], n)
        csrc1 = np.empty(E1, np.int32)
        csrc1[cold] = csrc0
        csrc1[cnew] = new_src[csr_order].astype(np.int32)
        cmap1 = np.empty(E1, np.int64)
        cmap1[cold] = old_pos[cmap0]
        cmap1[cnew] = new_pos[csr_order]
        csc1 = (cindptr1, csrc1, cmap1)
    store = CSRStore.from_parts(
        n, indptr1, indices1, vertex_props=vertex_props,
        edge_props=eprops1,
        vertex_labels=(vertex_labels if vertex_labels is not None
                       else base.vertex_labels()),
        edge_labels=elab1, csc=csc1)
    return store, old_pos, new_pos


class CSRStore:
    """Immutable in-memory property graph store (Vineyard-like)."""

    def __init__(self, n_vertices: int, src: np.ndarray, dst: np.ndarray,
                 vertex_props: Optional[Dict[str, np.ndarray]] = None,
                 edge_props: Optional[Dict[str, np.ndarray]] = None,
                 vertex_labels: Optional[np.ndarray] = None,
                 edge_labels: Optional[np.ndarray] = None,
                 build_csc: bool = True):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        self._n = int(n_vertices)
        self.indptr, self.indices, perm = edges_to_csr(self._n, src, dst)
        self._vprops = dict(vertex_props or {})
        self._eprops = {k: np.asarray(v)[perm] for k, v in (edge_props or {}).items()}
        self._vlabels = (np.asarray(vertex_labels, np.int32)
                         if vertex_labels is not None
                         else np.zeros(self._n, np.int32))
        self._elabels = (np.asarray(edge_labels, np.int32)[perm]
                         if edge_labels is not None
                         else np.zeros(len(self.indices), np.int32))
        self._csc: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        if build_csc:
            self._build_csc()

    @classmethod
    def from_parts(cls, n_vertices: int, indptr: np.ndarray,
                   indices: np.ndarray,
                   vertex_props: Optional[Dict[str, np.ndarray]] = None,
                   edge_props: Optional[Dict[str, np.ndarray]] = None,
                   vertex_labels: Optional[np.ndarray] = None,
                   edge_labels: Optional[np.ndarray] = None,
                   csc=None) -> "CSRStore":
        """Construct from already-CSR-sorted parts without re-sorting —
        the incremental-extension path (``extend_csr``) and snapshot
        shell-sharing build through here. Arrays are adopted, not copied;
        callers own the no-aliasing discipline."""
        self = cls.__new__(cls)
        self._n = int(n_vertices)
        self.indptr = indptr
        self.indices = indices
        self._vprops = dict(vertex_props or {})
        self._eprops = dict(edge_props or {})
        self._vlabels = (np.asarray(vertex_labels, np.int32)
                         if vertex_labels is not None
                         else np.zeros(self._n, np.int32))
        self._elabels = (np.asarray(edge_labels, np.int32)
                         if edge_labels is not None
                         else np.zeros(len(indices), np.int32))
        self._csc = csc
        return self

    # ------------------------------------------------------------------ GRIN
    def traits(self) -> Traits:
        t = (Traits.TOPOLOGY_ARRAY | Traits.DEGREE | Traits.VERTEX_PROPERTY |
             Traits.EDGE_PROPERTY | Traits.VERTEX_LABEL | Traits.EDGE_LABEL |
             Traits.INDEX_INTERNAL_ID)
        if self._csc is not None:
            t |= Traits.TOPOLOGY_CSC
        return t

    @property
    def n_vertices(self) -> int:
        return self._n

    @property
    def n_edges(self) -> int:
        return int(len(self.indices))

    def adjacency(self):
        return self.indptr, self.indices

    def csc(self):
        if self._csc is None:
            self._build_csc()
        return self._csc[0], self._csc[1]

    def csc_edge_map(self) -> np.ndarray:
        """Map CSC position → CSR edge id (for edge property access)."""
        if self._csc is None:
            self._build_csc()
        return self._csc[2]

    def vertex_prop(self, name: str) -> np.ndarray:
        return self._vprops[name]

    def edge_prop(self, name: str) -> np.ndarray:
        return self._eprops[name]

    def vertex_labels(self) -> np.ndarray:
        return self._vlabels

    def edge_labels(self) -> np.ndarray:
        return self._elabels

    # ------------------------------------------------------------------ util
    def _build_csc(self):
        E = len(self.indices)
        src = np.repeat(np.arange(self._n, dtype=np.int64),
                        np.diff(self.indptr))
        order = np.lexsort((src, self.indices))
        counts = np.bincount(self.indices, minlength=self._n)
        indptr = np.zeros(self._n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        self._csc = (indptr, src[order].astype(np.int32), order)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def subgraph_props(self) -> Dict[str, np.ndarray]:
        return dict(self._vprops)


def store_from_arrays(n_vertices: int, indptr: np.ndarray,
                      indices: np.ndarray,
                      vertex_props: Optional[Dict[str, np.ndarray]] = None,
                      edge_props: Optional[Dict[str, np.ndarray]] = None,
                      vertex_labels: Optional[np.ndarray] = None,
                      edge_labels: Optional[np.ndarray] = None) -> CSRStore:
    """A :class:`CSRStore` over already-CSR-sorted arrays taken from
    another store (for example the JAX package's), copied so the two never
    alias. The parts are validated and the CSC is rebuilt, so the new
    store answers exactly as the one the arrays came from."""
    n = int(n_vertices)
    indptr = np.array(indptr, np.int64)
    indices = np.array(indices, np.int32)
    vertex_props = {k: np.array(v) for k, v in (vertex_props or {}).items()}
    edge_props = {k: np.array(v) for k, v in (edge_props or {}).items()}
    if vertex_labels is not None:
        vertex_labels = np.array(vertex_labels, np.int32)
    if edge_labels is not None:
        edge_labels = np.array(edge_labels, np.int32)
    validate_csr_parts(n, indptr, indices, edge_labels, edge_props,
                       what="store_from_arrays")
    store = CSRStore.from_parts(n, indptr, indices, vertex_props,
                                edge_props, vertex_labels, edge_labels)
    store._build_csc()
    return store
