"""Pregel — "think like a vertex" programming model over GRAPE (paper §6).

A :class:`VertexProgram` defines per-vertex state, the value each vertex
sends along its out-edges, and the state update from combined incoming
messages. ``run_pregel`` executes synchronized supersteps with a single
combined exchange per step (GRAPE's compact-buffer exchange).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.engines.grape.engine import GrapeEngine


@dataclasses.dataclass
class VertexProgram:
    """send(state, degree) -> per-vertex emitted value (broadcast on edges);
    update(state, msgs, step) -> new state; both on dense [N] tensors."""

    init: Callable[[int], Dict[str, torch.Tensor]]
    send: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]
    update: Callable[[Dict[str, torch.Tensor], torch.Tensor, int],
                     Dict[str, torch.Tensor]]
    combiner: str = "sum"
    use_weights: bool = False
    # convergence: L1 residual on this state key (None = fixed steps)
    residual_key: Optional[str] = None
    tol: float = 1e-6


def run_pregel(engine: GrapeEngine, prog: VertexProgram, max_steps: int,
               cache_key=None,
               init_state: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """Run supersteps until ``max_steps`` or until the L1 residual on
    ``prog.residual_key`` is at most ``prog.tol`` — the stopping rule of
    the JAX package's jitted fixpoint. The residual counts a vertex that
    stays unreached (inf - inf = NaN) as no change and a newly reached one
    (inf - finite) as 1e30. Reading it is one host sync per superstep.

    ``init_state`` warm-starts the fixpoint from a previous solution
    instead of ``prog.init`` (DESIGN.md §15): sound when every state key's
    update is a contraction (pagerank — converges to the same fixpoint
    tolerance) or monotone min-propagation started from a valid upper
    bound (bfs/sssp/wcc on an append-only graph — the fixpoint is unique
    and reached bit-exactly). The caller owns that contract.

    ``cache_key`` is accepted for the JAX package's signature; without a
    compiled program there is nothing to cache."""
    del cache_key
    dev = engine.device
    n = engine.frags.n_vertices
    state = prog.init(n) if init_state is None else \
        {k: torch.as_tensor(v, device=dev) for k, v in init_state.items()}
    deg = engine.out_degree.float()
    step = 0
    res = float("inf")
    while step < max_steps and res > prog.tol:
        emitted = prog.send(state, deg)                 # [N]
        owned = engine.owned_view(emitted)              # [F, v_per]
        msgs = engine.superstep(owned, prog.combiner, prog.use_weights)
        new = prog.update(state, msgs, step)
        if prog.residual_key is not None:
            diff = (new[prog.residual_key] - state[prog.residual_key]).abs()
            diff = torch.nan_to_num(diff, nan=0.0, posinf=1e30)
            res = float(diff.sum())
        state = new
        step += 1
    return state
