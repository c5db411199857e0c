"""GRAPE — distributed analytical engine (paper §6), in PyTorch.

Fragment execution follows the paper's design:

- fragments are stacked dense arrays ``[F, ...]`` (partition.py) on the
  engine's device, executed one after another on one device (the
  multi-GPU form waits for ROADMAP A7);
- per superstep each fragment scatters its out-edge contributions into ONE
  dense length-N message buffer, and the F buffers are combined by one
  sum / min / max — GRAPE's "aggregate fragmented small messages into a
  continuous compact buffer before dispatching";
- the ``sum`` combiner is the sorted-segment-sum kernel
  (``kernels.ops.segment_sum`` → ``csrc/segment_sum.cu`` on the GPU, its
  plain version on the CPU). Its precondition holds by construction:
  with ``use_kernels=True`` each fragment's edges are sorted by
  destination once, when the engine is built. ``use_kernels=False`` keeps
  the edges in CSR order and combines with ``index_add_`` — the
  reference's jnp form, an explicit option, never a fallback. ``min`` and
  ``max`` are ``scatter_reduce_`` in either form, outside any kernel as in
  the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.storage.grin import ANALYTICS_REQUIRED, GRINAdapter
from repro_torch.storage.partition import PAD_SENTINEL, Fragments, partition

COMBINERS = ("sum", "min", "max")


@dataclasses.dataclass
class FragmentArrays:
    """Device-resident stacked fragment arrays, edges in CSR order or (for
    the kernel) sorted by destination within each fragment."""

    indices: torch.Tensor       # [F, E] int64 global destination ids;
    #                             PAD_SENTINEL entries are rebased to 0 with
    #                             e_mask False (scatter-safe: vertex 0
    #                             contributions are zeroed by the mask,
    #                             never by the id)
    e_src: torch.Tensor         # [F, E] int64 local owned source index
    e_mask: torch.Tensor        # [F, E] valid edge
    segs: Optional[List[torch.Tensor]]  # per fragment, [E] int32
    #                             destinations ascending, PAD_SENTINEL
    #                             first (sorted form only; one tensor per
    #                             fragment so the kernel wrapper's
    #                             sortedness check runs once for each)
    weights: Optional[torch.Tensor]   # [F, E] float32
    owned_start: torch.Tensor   # [F]
    out_degree: torch.Tensor    # [N]
    n_vertices: int
    v_per_frag: int


def _prepare(frags: Fragments, sort_by_dst: bool,
             device: torch.device) -> FragmentArrays:
    F, E = frags.indices.shape
    e_src = np.zeros((F, E), np.int64)
    for f in range(F):
        ptr = frags.indptr[f]
        e_src[f] = np.clip(
            np.searchsorted(ptr, np.arange(E), side="right") - 1,
            0, frags.v_per_frag - 1)
    indices = frags.indices
    weights = frags.weights
    mask = indices != PAD_SENTINEL
    segs = None
    if sort_by_dst:
        # stable: equal destinations keep CSR order; padding (-1) first
        order = np.argsort(np.where(mask, indices, PAD_SENTINEL), axis=1,
                           kind="stable")
        indices = np.take_along_axis(indices, order, 1)
        e_src = np.take_along_axis(e_src, order, 1)
        mask = np.take_along_axis(mask, order, 1)
        if weights is not None:
            weights = np.take_along_axis(weights, order, 1)
        segs = [torch.as_tensor(row.astype(np.int32), device=device)
                for row in indices]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return FragmentArrays(
        indices=dev(np.where(mask, indices, 0).astype(np.int64)),
        e_src=dev(e_src),
        e_mask=dev(mask),
        segs=segs,
        weights=None if weights is None else dev(weights),
        owned_start=dev(frags.owned_start),
        out_degree=dev(frags.out_degree),
        n_vertices=frags.n_vertices,
        v_per_frag=frags.v_per_frag,
    )


class GrapeEngine:
    """Pregel/PIE/FLASH substrate over stacked fragments. ``device`` is
    where the fragments live and supersteps run (``None`` = CUDA; raises
    when CUDA is absent)."""

    def __init__(self, store, n_frags: int = 1, mesh=None,
                 use_kernels: bool = True, reorder: bool = False,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "GrapeEngine runs its fragments on one device; the "
                "multi-GPU mesh form is ROADMAP A7")
        self.grin = GRINAdapter(store, ANALYTICS_REQUIRED)
        self.device = resolve_device(device)
        self.n_frags = n_frags
        self.use_kernels = use_kernels
        self.frags = _prepare(partition(store, n_frags, reorder=reorder),
                              use_kernels, self.device)

    # ------------------------------------------------------------ superstep
    def _scatter(self, f: int, owned_vals: torch.Tensor, combiner: str,
                 use_weights: bool) -> torch.Tensor:
        """Fragment ``f``: owned vertex values → dense length-N
        contribution."""
        fa = self.frags
        n = fa.n_vertices
        vals = owned_vals[fa.e_src[f]]                    # [E]
        if use_weights and fa.weights is not None:
            # semiring pairing: (+,×) for sum-combining flows (pagerank,
            # equity), (min,+) tropical for shortest paths
            if combiner in ("min", "max"):
                vals = vals + fa.weights[f]
            else:
                vals = vals * fa.weights[f]
        mask = fa.e_mask[f]
        if combiner == "sum":
            vals = torch.where(mask, vals, 0.0)
            if self.use_kernels:
                return ops.segment_sum(vals.float().contiguous(), fa.segs[f],
                                       n)
            buf = torch.zeros(n, dtype=vals.dtype, device=vals.device)
            return buf.index_add_(0, fa.indices[f], vals)
        pad = torch.inf if combiner == "min" else -torch.inf
        vals = torch.where(mask, vals, pad)
        buf = torch.full((n,), pad, dtype=vals.dtype, device=vals.device)
        return buf.scatter_reduce_(0, fa.indices[f], vals,
                                   "amin" if combiner == "min" else "amax",
                                   include_self=True)

    def superstep(self, owned_vals: torch.Tensor, combiner: str = "sum",
                  use_weights: bool = False) -> torch.Tensor:
        """owned_vals [F, v_per] → combined messages [N]."""
        if combiner not in COMBINERS:
            raise ValueError(f"unknown combiner {combiner!r}")
        contribs = [self._scatter(f, owned_vals[f], combiner, use_weights)
                    for f in range(self.n_frags)]
        if len(contribs) == 1:
            return contribs[0]
        stacked = torch.stack(contribs)
        if combiner == "sum":
            return stacked.sum(dim=0)
        if combiner == "min":
            return stacked.amin(dim=0)
        return stacked.amax(dim=0)

    # --------------------------------------------------------------- helpers
    def owned_view(self, dense: torch.Tensor) -> torch.Tensor:
        """[N] → [F, v_per] (the tail past N padded with zeros)."""
        n, vp, F = self.frags.n_vertices, self.frags.v_per_frag, self.n_frags
        pad = F * vp - n
        if pad:
            dense = torch.cat([dense, dense.new_zeros(pad)])
        return dense.reshape(F, vp)

    def dense_view(self, owned: torch.Tensor) -> torch.Tensor:
        return owned.reshape(-1)[: self.frags.n_vertices]

    @property
    def out_degree(self) -> torch.Tensor:
        return self.frags.out_degree
