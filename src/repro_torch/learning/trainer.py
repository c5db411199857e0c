"""The GraphSAGE trainer's serving half (paper §7), in PyTorch.

A trained model serves from queries through the procedure bridge:
``register_inference`` freezes the current parameters into a
``CALL gnn.infer($model)`` procedure (DESIGN.md §10) whose full-graph
forward pass is deterministic under a fixed key — so serving scores equal
the offline ``infer_scores`` of the same snapshot bit for bit.

Parameters come from a seeded ``torch.Generator`` or, through
:func:`repro_torch.learning.gnn.params_from_reference`, from the JAX
package's parameter tree. Training (``sample``, ``train_on``,
``train_step_device``, ``train``) waits for the training half of ROADMAP
A6.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.learning.gnn import GraphSAGE, params_from_reference
from repro_torch.learning.sampler import GraphSampler, step_seed

# (chunk index, layer, M, K) → float32 uniforms [M, K]
ChunkUniforms = Callable[[int, int, int, int], torch.Tensor]

_TRAINING = ("training waits for the port's training slice (ROADMAP A6: "
             "train_on, train_step_device, DecoupledPipeline)")


class SageTrainer:
    def __init__(self, sampler: GraphSampler, hidden: int, n_classes: int,
                 fanouts: Sequence[int], batch_size: int = 256,
                 lr: float = 1e-2, seed: int = 0,
                 params: Optional[Mapping] = None):
        """``params``: the JAX package's GraphSAGE parameter tree (arrays)
        to serve; without it the parameters are drawn from a
        ``torch.Generator`` seeded with ``seed``."""
        self.sampler = sampler
        self.device = sampler.device
        self.fanouts = tuple(int(f) for f in fanouts)
        self.batch_size = batch_size
        self.lr = lr
        gen = torch.Generator().manual_seed(seed)
        self.model = GraphSAGE(sampler.feature_dim, hidden, n_classes,
                               self.fanouts, generator=gen,
                               device=self.device)
        if params is not None:
            self.model.load_state_dict(params_from_reference(params))
        # foreign-snapshot executors each pin a device copy of the feature
        # matrix and the CSR; LRU-bounded so a stream of MVCC snapshots
        # served through gnn.infer cannot grow memory without bound
        self._ext_executors: "OrderedDict[int, tuple]" = OrderedDict()
        self.max_ext_executors = 4

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The current parameters, as a detached state dict."""
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def sample(self, step: int):
        raise NotImplementedError(_TRAINING)

    def train_on(self, batch) -> float:
        raise NotImplementedError(_TRAINING)

    def train_step_device(self, step: int) -> float:
        raise NotImplementedError(_TRAINING)

    def train(self, steps: int, pipelined: bool = True, n_workers: int = 2,
              prefetch: str = "host"):
        raise NotImplementedError(_TRAINING)

    # ------------------------------------------------- query-serving bridge
    def _executor_for(self, store):
        """A sampling executor over ``store`` (the trainer's own store reuses
        its engine; foreign snapshots get one each, LRU-cached by identity up
        to ``max_ext_executors``)."""
        if store is None or store is self.sampler.grin.store:
            return self.sampler.device_executor()
        cached = self._ext_executors.get(id(store))
        if cached is not None and cached[0] is store:
            self._ext_executors.move_to_end(id(store))
            return cached[1]
        from repro_torch.engines.sample import FragmentSampleExecutor
        ex = FragmentSampleExecutor(
            store, n_frags=self.sampler.n_frags,
            feature_prop=self.sampler.feature_prop, label_prop=None,
            device=self.device)
        self._ext_executors[id(store)] = (store, ex)
        while len(self._ext_executors) > self.max_ext_executors:
            self._ext_executors.popitem(last=False)
        return ex

    # the fixed serving chunk: draws are seeded per chunk index, so the
    # grid must never move or offline scores would diverge from served ones
    INFER_CHUNK = 2048

    def infer_scores(self, store=None, params=None, key: int = 0, *,
                     uniforms: Optional[ChunkUniforms] = None) -> np.ndarray:
        """Deterministic full-graph forward pass: per-vertex max-logit score
        [N] (float32, on the host), on the fixed ``INFER_CHUNK`` grid with
        PAD seeds on the last chunk — the exact computation
        ``CALL gnn.infer`` serves, bit for bit.

        Chunk i's draws come from a generator on the sampler's device
        seeded from ``(key, i)``, or from ``uniforms(i, layer, m, k)`` when
        given (the tests pass the JAX package's per-chunk uniforms).
        ``params`` is a state dict of this trainer's model (``None``: the
        current parameters). Scores stay on the device until the last
        chunk: one copy to the host per call."""
        params = self.params if params is None else params
        ex = self._executor_for(store)
        dev = ex.device
        n = ex.n_vertices
        chunk = self.INFER_CHUNK
        n_chunks = -(-n // chunk)
        seeds = torch.arange(n_chunks * chunk, dtype=torch.int32,
                             device=dev)
        seeds[n:] = -1
        out = torch.empty(n_chunks * chunk, dtype=torch.float32, device=dev)
        with torch.no_grad():
            for i in range(n_chunks):
                if uniforms is None:
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(step_seed(key, i))

                    def draw(l, m, k, gen=gen):
                        return torch.rand((m, k), generator=gen, device=dev)
                else:
                    def draw(l, m, k, i=i):
                        return uniforms(i, l, m, k)
                layers, feats, _ = ex._sample_impl(
                    seeds[i * chunk:(i + 1) * chunk], self.fanouts, draw)
                lg = torch.func.functional_call(self.model, params,
                                                (feats, layers))
                out[i * chunk:(i + 1) * chunk] = lg.max(dim=-1).values
        return out[:n].cpu().numpy()

    def as_procedure(self, key: int = 0):
        """Freeze the CURRENT parameters into a ``(store) → scores[N]``
        serving function. A later change of the parameters does NOT change
        an already-created procedure — re-register to serve new
        parameters (lifetime rules: DESIGN.md §10)."""
        params = {k: v.clone() for k, v in self.params.items()}

        def infer_fn(store):
            return self.infer_scores(store=store, params=params, key=key)

        return infer_fn

    def register_inference(self, registry, name: str = "default",
                           key: int = 0) -> str:
        """Register this model in a :class:`ProcedureRegistry` so queries
        serve it: ``CALL gnn.infer($model) YIELD v, score``."""
        registry.register_model(name, self.as_procedure(key))
        return name
