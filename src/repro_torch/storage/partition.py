"""Edge-cut graph partitioning for the distributed analytics engine.

Vertices are assigned to fragments (contiguous ranges after an optional
locality-improving BFS reorder); each fragment keeps the CSR rows of its
owned vertices. Fragments are padded to a common size so the whole set
stacks into dense ``[F, ...]`` arrays — GRAPE's fragment model, with one
fragment per device once the port runs on several GPUs (ROADMAP A7).
Numpy only: the GRAPE engine moves the stacks to its device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# THE padding sentinel for every stacked/slabbed edge array in the stack
# (fragment indices, ELL slabs, frontier slabs). Kernels and engines test
# ``index < 0`` / ``index != PAD_SENTINEL``; real vertex ids are never
# negative, so edges *into vertex 0* are always distinguishable from pad.
PAD_SENTINEL = -1


@dataclasses.dataclass
class Fragments:
    """Stacked, padded fragments: everything shaped [F, ...]."""

    n_frags: int
    n_vertices: int                 # global
    v_per_frag: int                 # owned vertices per fragment (padded)
    indptr: np.ndarray              # [F, v_per_frag+1] local CSR over owned rows
    indices: np.ndarray             # [F, max_edges] global neighbor ids
    #                                 (pad PAD_SENTINEL)
    weights: Optional[np.ndarray]   # [F, max_edges]
    owned_start: np.ndarray         # [F] first owned vertex id
    out_degree: np.ndarray          # [N] global out-degrees (replicated)

    def owner_of(self, v: np.ndarray) -> np.ndarray:
        return np.minimum(v // self.v_per_frag, self.n_frags - 1)


def bfs_reorder(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Cheap locality reorder (BFS from max-degree vertex); returns perm
    old_id → new_id. Improves edge-cut of range partitioning."""
    n = len(indptr) - 1
    deg = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    k = 0
    frontier = [int(np.argmax(deg))]
    visited[frontier[0]] = True
    while k < n:
        nxt: List[int] = []
        for u in frontier:
            order[k] = u
            k += 1
            for w in indices[indptr[u]:indptr[u + 1]]:
                if not visited[w]:
                    visited[w] = True
                    nxt.append(int(w))
        if not nxt:
            rest = np.nonzero(~visited)[0]
            if len(rest) == 0:
                break
            visited[rest[0]] = True
            nxt = [int(rest[0])]
        frontier = nxt
    perm = np.empty(n, np.int64)
    perm[order] = np.arange(n)
    return perm


def partition(store, n_frags: int, reorder: bool = False) -> Fragments:
    indptr, indices = store.adjacency()
    n = store.n_vertices
    weights = None
    try:
        weights = store.edge_prop("weight")
    except (KeyError, AttributeError):
        pass

    if reorder:
        perm = bfs_reorder(indptr, indices)
        src = np.repeat(perm, np.diff(indptr))
        dst = perm[indices]
        order = np.lexsort((dst, src))
        counts = np.bincount(src, minlength=n)
        new_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=new_indptr[1:])
        indptr, indices = new_indptr, dst[order].astype(np.int32)
        if weights is not None:
            weights = weights[order]

    v_per = -(-n // n_frags)
    max_edges = 0
    for f in range(n_frags):
        lo, hi = f * v_per, min((f + 1) * v_per, n)
        max_edges = max(max_edges, int(indptr[hi] - indptr[lo]))
    max_edges = max(max_edges, 1)

    f_indptr = np.zeros((n_frags, v_per + 1), np.int64)
    f_indices = np.full((n_frags, max_edges), PAD_SENTINEL, np.int64)
    f_weights = (np.zeros((n_frags, max_edges), np.float32)
                 if weights is not None else None)
    starts = np.zeros(n_frags, np.int64)
    for f in range(n_frags):
        lo, hi = f * v_per, min((f + 1) * v_per, n)
        e_lo, e_hi = int(indptr[lo]), int(indptr[hi])
        ne = e_hi - e_lo
        local_ptr = indptr[lo:hi + 1] - e_lo
        f_indptr[f, :hi - lo + 1] = local_ptr
        f_indptr[f, hi - lo + 1:] = local_ptr[-1]
        f_indices[f, :ne] = indices[e_lo:e_hi]
        if f_weights is not None:
            f_weights[f, :ne] = weights[e_lo:e_hi]
        starts[f] = lo
    return Fragments(
        n_frags=n_frags, n_vertices=n, v_per_frag=v_per,
        indptr=f_indptr, indices=f_indices, weights=f_weights,
        owned_start=starts, out_degree=np.diff(indptr).astype(np.int32))
