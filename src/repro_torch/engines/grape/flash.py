"""FLASH — flexible control flow beyond fixed-point (paper §6, [58]).

FLASH programs manipulate *vertex sets* (dense boolean masks) with three
primitives, allowing non-neighbor communication (arbitrary gather/scatter by
vertex id — e.g. pointer-jumping connected components):

- ``vset(pred)``            — filter a vertex set
- ``push(vs, value_fn)``    — emit along edges from a set (neighbor comm)
- ``pull_at(idx)``          — read state at arbitrary vertex ids (non-neighbor)
"""

from __future__ import annotations

import torch

from repro_torch.engines.grape.engine import GrapeEngine


class FlashContext:
    def __init__(self, engine: GrapeEngine):
        self.engine = engine
        self.n = engine.frags.n_vertices
        self.deg = engine.out_degree.float()

    def all_vertices(self) -> torch.Tensor:
        return torch.ones(self.n, dtype=torch.bool,
                          device=self.engine.device)

    def vset(self, mask_or_pred) -> torch.Tensor:
        if callable(mask_or_pred):
            return mask_or_pred(torch.arange(self.n,
                                             device=self.engine.device))
        return mask_or_pred

    def push(self, vs: torch.Tensor, values: torch.Tensor,
             combiner: str = "sum", use_weights: bool = False
             ) -> torch.Tensor:
        """Emit ``values`` along out-edges of vertices in ``vs``; returns the
        combined inbox [N]."""
        fill = {"sum": 0.0, "min": torch.inf, "max": -torch.inf}[combiner]
        emitted = torch.where(vs, values, fill)
        owned = self.engine.owned_view(emitted)
        return self.engine.superstep(owned, combiner, use_weights)

    @staticmethod
    def pull_at(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Non-neighbor communication: read state at arbitrary vertices."""
        return state[idx.long()]

    @staticmethod
    def scatter_to(state: torch.Tensor, idx: torch.Tensor, values,
                   combiner: str = "min") -> torch.Tensor:
        """Non-neighbor write: ``state`` combined at ``idx`` with
        ``values`` (a new tensor; ``state`` is left as it was)."""
        idx = idx.long()
        values = torch.as_tensor(values, dtype=state.dtype,
                                 device=state.device).expand(idx.shape)
        if combiner == "sum":
            return state.clone().index_add_(0, idx, values)
        return state.clone().scatter_reduce_(
            0, idx, values, "amin" if combiner == "min" else "amax",
            include_self=True)
