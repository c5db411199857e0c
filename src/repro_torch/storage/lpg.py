"""Labeled Property Graph facade used by the query engines (paper §2.1).

Wraps any GRIN store exposing labels/properties, adding the per-label
expansion primitives the GraphIR physical operators consume. All hot paths
are vectorized over *frontiers* (arrays of vertex ids), matching the
dataflow engines.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.storage.grin import GRINAdapter, QUERY_REQUIRED, Traits


class PropertyGraph:
    def __init__(self, store, base: Optional["PropertyGraph"] = None,
                 delta=None):
        self.grin = GRINAdapter(store, QUERY_REQUIRED)
        self.indptr, self.indices = self.grin.adjacency()
        self.vlabels = self.grin.vertex_labels()
        self.elabels = self.grin.edge_labels()
        self._rev: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        # (edge_label, direction) -> label-sliced CSR; built lazily so typed
        # expansions touch only their own edges instead of filtering the
        # whole multi-label adjacency per frontier
        self._label_csr: Dict[Tuple[int, str],
                              Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        # analytics results materialized by CALL algo.* (DESIGN.md §7);
        # overlay the store's own columns, last-writer-wins per name
        self._temp_vprops: Dict[str, np.ndarray] = {}
        if base is not None:
            self._adopt_from(base, delta)

    # --------------------------------------------------- incremental adopt
    def _adopt_from(self, base: "PropertyGraph", delta) -> None:
        """Carry ``base``'s label-sliced CSR caches forward when this
        graph's merged CSR was *extended* from base's (DESIGN.md §15):
        each cached slice is patched by inserting the delta's same-label
        edges at their CSR positions instead of re-slicing all E edges.
        Silently does nothing when the lineage check fails (a compact()
        or an unrelated merge landed in between) — slices then rebuild
        lazily, which is always correct."""
        info = getattr(self.grin.store, "_inc_info", None)
        if info is None:
            return
        from repro_torch.storage.csr import topo_base
        prev_merged, old_pos, new_pos = info
        base_store = base.grin.store
        base_merged = getattr(base_store, "_merged", base_store)
        if topo_base(prev_merged) is not topo_base(base_merged):
            return                      # different extension lineage
        if old_pos is None:             # identical topology (vprops-only
            self._rev = base._rev       # commit): share every cache
            self._label_csr.update(base._label_csr)
            return
        if delta is None or len(delta.src) != len(new_pos):
            return
        from repro_torch.storage.csr import _insert_rows_sorted
        E1 = len(self.indices)
        for (lab, direction), (sl_ptr, sl_idx, sl_eids) \
                in base._label_csr.items():
            keep = delta.labels == lab
            d_src, d_dst = delta.src[keep], delta.dst[keep]
            d_eid = new_pos[keep]
            # remap the old slice's CSR edge ids into the merged layout
            # (old_pos is strictly monotone, so within-row order holds)
            eids_re = old_pos[sl_eids]
            try:
                if direction == "out":
                    # rows = src; within-row order is CSR position = eid
                    ptr1, od, nd = _insert_rows_sorted(
                        sl_ptr, eids_re, d_src, d_eid, self.n_vertices)
                    new_heads = d_dst
                else:
                    # rows = dst; within-row order is (src, CSR position)
                    # — the reverse-CSC tie order. Positions are unique,
                    # so the composite key reproduces it exactly.
                    ptr1, od, nd = _insert_rows_sorted(
                        sl_ptr, sl_idx.astype(np.int64) * E1 + eids_re,
                        d_dst, d_src * E1 + d_eid, self.n_vertices)
                    new_heads = d_src
            except OverflowError:
                continue                # composite too wide: lazy rebuild
            k = len(sl_eids) + len(d_eid)
            idx1 = np.empty(k, sl_idx.dtype)
            idx1[od] = sl_idx
            idx1[nd] = new_heads.astype(sl_idx.dtype)
            eids1 = np.empty(k, np.int64)
            eids1[od] = eids_re
            eids1[nd] = d_eid
            self._label_csr[(lab, direction)] = (ptr1, idx1, eids1)

    # --------------------------------------------------------------- lookups
    @property
    def n_vertices(self):
        return self.grin.n_vertices

    def vprop(self, name: str) -> np.ndarray:
        temp = self._temp_vprops.get(name)
        if temp is not None:
            return temp
        return self.grin.vertex_prop(name)

    # ---------------------------------------------------- temp vertex props
    def set_temp_vprop(self, name: str, values: np.ndarray) -> None:
        """Install a computed per-vertex column (a procedure result) that
        shadows any same-named storage property until dropped/replaced."""
        values = np.asarray(values)
        if len(values) != self.n_vertices:
            raise ValueError(f"temp vprop {name!r} has {len(values)} rows, "
                             f"graph has {self.n_vertices} vertices")
        self._temp_vprops[name] = values

    def drop_temp_vprop(self, name: str) -> None:
        self._temp_vprops.pop(name, None)

    def eprop(self, name: str) -> np.ndarray:
        return self.grin.edge_prop(name)

    def vertices(self, label: Optional[int] = None) -> np.ndarray:
        if label is None:
            return np.arange(self.n_vertices, dtype=np.int64)
        return np.nonzero(self.vlabels == label)[0].astype(np.int64)

    # ------------------------------------------------------------ expansion
    def _reverse(self):
        if self._rev is None:
            store = self.grin.store
            if store.traits() & Traits.TOPOLOGY_CSC:
                indptr, indices = store.csc()
                emap = store.csc_edge_map()
            else:
                src = np.repeat(np.arange(self.n_vertices, dtype=np.int64),
                                np.diff(self.indptr))
                order = np.argsort(self.indices, kind="stable")
                counts = np.bincount(self.indices, minlength=self.n_vertices)
                indptr = np.zeros(self.n_vertices + 1, np.int64)
                np.cumsum(counts, out=indptr[1:])
                indices, emap = src[order].astype(np.int32), order
            self._rev = (indptr, indices, emap)
        return self._rev

    def _label_sliced(self, edge_label: int, direction: str):
        """CSR restricted to one edge label (lazy, cached). Within each
        source the surviving edges keep their full-CSR relative order, so
        expansion output order matches the filter-after-materialize path."""
        key = (edge_label, direction)
        cached = self._label_csr.get(key)
        if cached is not None:
            return cached
        if direction == "in":
            indptr, indices, emap = self._reverse()
            eids = emap
        else:
            indptr, indices = self.indptr, self.indices
            eids = np.arange(len(indices), dtype=np.int64)
        src = np.repeat(np.arange(self.n_vertices, dtype=np.int64),
                        np.diff(indptr))
        keep = self.elabels[eids] == edge_label
        new_indptr = np.zeros(self.n_vertices + 1, np.int64)
        np.cumsum(np.bincount(src[keep], minlength=self.n_vertices),
                  out=new_indptr[1:])
        sliced = (new_indptr, indices[keep], eids[keep])
        self._label_csr[key] = sliced
        return sliced

    def sliced_csr(self, edge_label: Optional[int], direction: str
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """(indptr, indices, edge_ids) of the adjacency restricted to
        ``edge_label`` (None = all labels) in ``direction``: rows are the
        ``direction``-side endpoints. ``edge_ids`` is None when rows are the
        raw forward CSR (position == edge id). Shared by the interpreter's
        ``expand`` and the fragment frontier builder (DESIGN.md §9)."""
        if edge_label is not None:
            return self._label_sliced(edge_label, direction)
        if direction == "in":
            return self._reverse()
        return self.indptr, self.indices, None

    def expand(self, frontier: np.ndarray, edge_label: Optional[int] = None,
               direction: str = "out",
               edge_pred: Optional[Tuple[str, str, float]] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized frontier expansion.

        Returns (tails, heads, edge_ids): for each edge incident to the
        frontier (matching label/pred), the frontier row index it came from
        (``tails`` indexes into ``frontier``), the neighbor vertex id, and
        the global edge id (CSR position) for property access.
        """
        indptr, indices, emap = self.sliced_csr(edge_label, direction)

        starts = indptr[frontier]
        degs = (indptr[frontier + 1] - starts).astype(np.int64)
        total = int(degs.sum())
        tails = np.repeat(np.arange(len(frontier)), degs)
        # positions of each expanded edge in the CSR array
        offs = np.concatenate([[0], np.cumsum(degs)])[:-1]
        pos = np.arange(total) - np.repeat(offs, degs) + np.repeat(starts, degs)
        heads = indices[pos].astype(np.int64)
        eids = emap[pos] if emap is not None else pos
        if edge_pred is not None:
            name, op, value = edge_pred
            col = self.eprop(name)[eids]
            keep = _apply_op(col, op, value)
            tails, heads, eids = tails[keep], heads[keep], eids[keep]
        return tails, heads, eids

    def filter_vertices(self, ids: np.ndarray, label=None, prop=None, op="==",
                        value=None) -> np.ndarray:
        mask = np.ones(len(ids), bool)
        if label is not None:
            mask &= self.vlabels[ids] == label
        if prop is not None:
            mask &= _apply_op(self.vprop(prop)[ids], op, value)
        return mask


def _apply_op(col: np.ndarray, op: str, value) -> np.ndarray:
    if op == "==":
        return col == value
    if op == "!=":
        return col != value
    if op == "<":
        return col < value
    if op == "<=":
        return col <= value
    if op == ">":
        return col > value
    if op == ">=":
        return col >= value
    if op == "in":
        return np.isin(col, value)
    raise ValueError(f"unknown op {op}")
