"""Device-resident GNN sampling on the fragment substrate (DESIGN.md §10),
in PyTorch.

The learning stack's sampling hot path on the storage and kernel layer
the query engines use. One layered GraphSAGE batch — fixed-fanout draws
per hop, a feature gather per frontier — runs on the executor's device:

    hop l:   nbrs[m, k] = draw(frontier[m], u_l[m, k])
    gather:  feats[m]   = features[frontier[m]]        (0-rows for PAD)

The JAX package range-partitions the adjacency into F fragments and
offers two exchanges: ``psum`` (each fragment draws for the seeds it owns,
the disjoint results summed) and ``stacked`` (on one device fragment f's
row r IS global row ``f·v_per + r``, so the draw runs against the flat
tables). Both give the same bits for any F. The port has the stacked
exchange: ``n_frags`` is accepted and recorded, and the psum exchange and
a mesh wait for ROADMAP A7 (multiple GPUs).

Draws come straight off CSR (``ops.sample_neighbors``: the CUDA kernel on
the GPU, its plain version on the CPU) at O(E) memory; there is no dense
``[N, max_degree]`` slab. Uniforms are an input at the draw boundary:
``sample`` takes either a ``torch.Generator`` on the executor's device or
the per-hop uniforms themselves, which is how the tests hand the JAX
package's threefry uniforms (``layer_uniforms``) to the port.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.storage.grin import LEARNING_REQUIRED, GRINAdapter
from repro_torch.storage.partition import PAD_SENTINEL

EXCHANGES = ("stacked", "psum")

# (layer, M, K) → float32 uniforms [M, K] on the executor's device
Uniforms = Callable[[int, int, int], torch.Tensor]


class FragmentSampleExecutor:
    """Layered fixed-fanout sampling + feature gather over the flat
    (stacked) tables of F range-partitioned fragments."""

    def __init__(self, store, n_frags: int = 1, mesh=None,
                 feature_prop: str = "feat",
                 label_prop: Optional[str] = None, pg=None,
                 exchange: str = "stacked", device=None):
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}; "
                             f"one of {EXCHANGES}")
        if mesh is not None or exchange == "psum":
            raise NotImplementedError(
                "the psum exchange and mesh execution wait for the "
                "multi-GPU port (ROADMAP A7); exchange='stacked' gives the "
                "same draws for any n_frags")
        self.device = resolve_device(device)
        # ``pg`` shares the query engines' PropertyGraph adjacency caches
        if pg is not None:
            store = pg.grin.store
            indptr, indices, _ = pg.sliced_csr(None, "out")
        else:
            indptr, indices = store.adjacency()
        grin = GRINAdapter(store, LEARNING_REQUIRED)
        self.store = store
        self.feature_prop = feature_prop
        self.label_prop = label_prop
        n = grin.n_vertices
        self.n_vertices = n
        self.n_frags = n_frags

        feats = np.asarray(grin.vertex_prop(feature_prop), np.float32)
        if feats.ndim == 1:
            feats = feats[:, None]
        self.feature_dim = feats.shape[1]
        dev = self.device
        self.deg = torch.as_tensor(np.diff(indptr).astype(np.int32),
                                   device=dev)
        self.csr_starts = torch.as_tensor(
            np.asarray(indptr[:-1], np.int64), device=dev)
        # one trailing sentinel, as in the JAX package's CSR draw
        self.csr_indices = torch.as_tensor(np.concatenate(
            [indices, [PAD_SENTINEL]]).astype(np.int32), device=dev)
        # ids < 0 or ≥ n gather the all-zero pad row n
        feats_pad = np.zeros((n + 1, self.feature_dim), np.float32)
        feats_pad[:n] = feats
        self.feats = torch.as_tensor(feats_pad, device=dev)
        self.labels = None
        if label_prop is not None:
            lab_pad = np.zeros(n + 1, np.int32)
            lab_pad[:n] = np.asarray(grin.vertex_prop(label_prop))
            self.labels = torch.as_tensor(lab_pad, device=dev)

    def advance(self, store, delta, pg=None):
        raise NotImplementedError(
            "incremental rebinds of the sampling tables wait for the port's "
            "write slice (ROADMAP A4, A6); build a new executor over the "
            "new snapshot")

    # ------------------------------------------------------------ one hop
    def _layer(self, ids: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """ids [M] global (< 0 or ≥ n ⇒ PAD), u [M, K] → draws [M, K]; the
        draw treats rows outside [0, n) as invalid."""
        return ops.sample_neighbors(self.csr_starts, self.deg,
                                    self.csr_indices, ids, u)

    # ------------------------------------------------------ feature gather
    def _gather(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of a padded per-vertex table (features or labels); invalid
        ids hit the all-zero pad row n."""
        safe = torch.where((ids >= 0) & (ids < self.n_vertices), ids,
                           self.n_vertices).long()
        return table.index_select(0, safe)

    def gather_features(self, ids) -> torch.Tensor:
        """[M] global vertex ids → [M, D] features (0-rows for PAD ids)."""
        return self._gather(self.feats, torch.as_tensor(
            np.asarray(ids, np.int32), device=self.device))

    # ------------------------------------------------------------- batch
    def _sample_impl(self, seeds: torch.Tensor, fanouts: Tuple[int, ...],
                     uniforms: Uniforms):
        frontiers = [seeds.to(torch.int32)]
        layers: List[torch.Tensor] = []
        for l, k in enumerate(fanouts):
            m = frontiers[-1].shape[0]
            u = uniforms(l, m, k)
            if tuple(u.shape) != (m, k):
                raise ValueError(f"hop {l} needs uniforms of shape "
                                 f"{(m, k)}, got {tuple(u.shape)}")
            nbrs = self._layer(frontiers[-1],
                               u.to(self.device, torch.float32).contiguous())
            layers.append(nbrs)
            frontiers.append(nbrs.reshape(-1))
        feats = [self._gather(self.feats, fr) for fr in frontiers]
        labels = (self._gather(self.labels, frontiers[0])
                  if self.labels is not None else None)
        return layers, feats, labels

    def sample(self, seeds, fanouts: Sequence[int], *,
               generator: Optional[torch.Generator] = None,
               uniforms: Optional[Sequence[torch.Tensor]] = None):
        """One layered batch: seeds [B] → (layers, feats, labels).

        layers[l]: [B·∏f[:l], f[l]] int32 draws (PAD_SENTINEL for invalid);
        feats[l]: frontier-l features [B·∏f[:l], D] float32; labels [B]
        int32 (None without a label property); all on the executor's
        device. Hop l's uniforms are ``uniforms[l]`` ([M_l, f[l]] float32)
        when given, else drawn from ``generator`` (a ``torch.Generator``
        on the executor's device)."""
        fanouts = tuple(int(f) for f in fanouts)
        if (generator is None) == (uniforms is None):
            raise ValueError("pass exactly one of generator= and uniforms=")
        if uniforms is not None:
            if len(uniforms) != len(fanouts):
                raise ValueError(f"{len(fanouts)} hops need as many "
                                 f"uniform tensors, got {len(uniforms)}")

        def draw(l: int, m: int, k: int) -> torch.Tensor:
            if uniforms is not None:
                return torch.as_tensor(uniforms[l])
            return torch.rand((m, k), generator=generator,
                              device=self.device)

        if not isinstance(seeds, torch.Tensor):
            seeds = torch.as_tensor(np.asarray(seeds, np.int32))
        return self._sample_impl(seeds.to(self.device), fanouts, draw)
