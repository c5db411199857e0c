"""Graph sampling for GNN inference (paper §7 — GraphLearn), in PyTorch.

Fixed-fanout k-hop neighbour sampling (GraphSAGE) behind one API with two
backends:

- ``backend="host"`` — CPU numpy sampling, the paper's decoupled
  CPU-sampling-server role; a copy of the JAX package's host sampler,
  draw for draw;
- ``backend="device"`` — the sampling hot path on the fragment substrate
  (``engines/sample.py``; DESIGN.md §10) on the sampler's device (CUDA
  unless ``device="cpu"``): CSR draws (the ``sample_ell`` kernel on the
  GPU), the feature gather, the draws of step s from a ``torch.Generator``
  seeded from ``(seed, s)``. ``sample_batch`` returns the same
  ``SampledBatch`` shapes and ``-1``-padding contract as the host path.

Both draw neighbour indices by the floor-multiply map ``⌊u · deg⌋``
(``uniform_index``), free of the modulo bias of ``bits % deg``. NCN
common-neighbour sampling (``sample_ncn``) waits for the training slice
(ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.storage.grin import LEARNING_REQUIRED, GRINAdapter


def uniform_index(u: np.ndarray, degs: np.ndarray) -> np.ndarray:
    """Unbiased uniform draw: ``u ∈ [0, 1)`` → ``⌊u · deg⌋`` clipped to
    ``[0, deg)``. ``u`` and ``degs`` broadcast together."""
    d = np.asarray(degs)
    col = (u * d).astype(np.int64)
    return np.minimum(col, np.maximum(d - 1, 0))


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """One 63-bit generator seed per ``(seed, step)`` pair (the device
    backend's draws for step ``step``, the trainer's for chunk ``step``),
    mixed with splitmix64's finaliser so that every bit depends on both:
    the CPU generator keeps only a seed's low 32 bits."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


@dataclasses.dataclass
class SampledBatch:
    """Layered GraphSAGE mini-batch: layer l has seeds^(l) and their sampled
    neighbours (fixed fanout, -1 ⇒ padded / missing)."""

    seeds: np.ndarray                   # [B] target vertices
    layers: List[np.ndarray]            # layer l: [B * prod(fanout[:l]), fanout[l]]
    features: List[np.ndarray]          # node features per layer frontier
    labels: Optional[np.ndarray] = None


class GraphSampler:
    def __init__(self, store, feature_prop: str = "feat",
                 label_prop: Optional[str] = None, seed: int = 0,
                 backend: str = "host", n_frags: int = 1, pg=None,
                 device=None):
        self.grin = GRINAdapter(store, LEARNING_REQUIRED)
        self.indptr, self.indices = self.grin.adjacency()
        self.feature_prop = feature_prop
        self.label_prop = label_prop
        self._features = self.grin.vertex_prop(feature_prop)
        self._labels = (self.grin.vertex_prop(label_prop)
                        if label_prop else None)
        self.rng = np.random.default_rng(seed)
        if backend not in ("host", "device"):
            raise ValueError(f"unknown sampler backend {backend!r}")
        self.backend = backend
        self.n_frags = n_frags
        self.device = resolve_device(device)
        self._pg = pg
        self._seed = seed
        self._device_ex = None
        self._draws = 0
        # the step counter and the numpy Generator are shared by callers on
        # several threads: claim a step (or draw) under the lock
        self._draws_lock = threading.Lock()
        if backend == "device":
            self.device_executor()          # build eagerly: fail fast

    def device_executor(self):
        """The (lazily built) fragment sampling engine on the sampler's
        device — shared with the ``CALL gnn.infer`` bridge."""
        if self._device_ex is None:
            from repro_torch.engines.sample import FragmentSampleExecutor
            self._device_ex = FragmentSampleExecutor(
                self.grin.store, n_frags=self.n_frags,
                feature_prop=self.feature_prop, label_prop=self.label_prop,
                pg=self._pg, device=self.device)
        return self._device_ex

    def step_generator(self, step: int) -> torch.Generator:
        """The device backend's generator for step ``step``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self._seed, step))
        return gen

    @property
    def feature_dim(self) -> int:
        return self._features.shape[1]

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """[N] → [N, fanout] sampled neighbour ids (with replacement; -1 for
        isolated vertices)."""
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        with self._draws_lock:
            u = self.rng.random((len(nodes), fanout))
        cols = uniform_index(u, np.maximum(degs, 1)[:, None])
        take = np.where(degs[:, None] > 0, starts[:, None] + cols, 0)
        out = self.indices[take].astype(np.int64)
        return np.where(degs[:, None] > 0, out, -1)

    def sample_batch(self, seeds: np.ndarray,
                     fanouts: Sequence[int]) -> SampledBatch:
        """Multi-hop sampling as a dataflow: hop l depends on hop l-1."""
        if self.backend == "device":
            with self._draws_lock:
                step = self._draws
                self._draws += 1
            return self.sample_batch_device(seeds, fanouts,
                                            self.step_generator(step))
        frontiers = [np.asarray(seeds, np.int64)]
        layers = []
        for f in fanouts:
            nbrs = self.sample_neighbors(np.maximum(frontiers[-1], 0), f)
            nbrs = np.where(frontiers[-1][:, None] >= 0, nbrs, -1)
            layers.append(nbrs)
            frontiers.append(nbrs.reshape(-1))
        feats = [self._feature_of(fr) for fr in frontiers]
        labels = None
        if self._labels is not None:
            # PAD (-1) seeds get label 0, matching the device backend's
            # zero pad row — the two backends share one batch contract
            seeds_a = np.asarray(seeds)
            labels = np.where(seeds_a >= 0,
                              self._labels[np.maximum(seeds_a, 0)], 0)
        return SampledBatch(seeds=np.asarray(seeds), layers=layers,
                            features=feats, labels=labels)

    def sample_batch_device(self, seeds: np.ndarray, fanouts: Sequence[int],
                            generator: torch.Generator) -> SampledBatch:
        """One device batch under an explicit generator, copied back to
        the host ``SampledBatch`` layout."""
        ex = self.device_executor()
        layers, feats, labels = ex.sample(seeds, tuple(fanouts),
                                          generator=generator)
        return SampledBatch(
            seeds=np.asarray(seeds),
            layers=[l.cpu().numpy().astype(np.int64) for l in layers],
            features=[f.cpu().numpy() for f in feats],
            labels=None if labels is None else labels.cpu().numpy())

    def _feature_of(self, nodes: np.ndarray) -> np.ndarray:
        safe = np.maximum(nodes, 0)
        f = self._features[safe]
        return np.where((nodes >= 0)[:, None], f, 0.0).astype(np.float32)

    def sample_ncn(self, edges: np.ndarray, fanouts: Sequence[int],
                   max_common: int = 8):
        raise NotImplementedError(
            "NCN common-neighbour sampling comes with the port's training "
            "slice (ROADMAP A6)")
