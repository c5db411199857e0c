"""PIE — subgraph-centric model (PEval / IncEval / Assemble), paper §6.

Unlike Pregel's per-vertex ``compute``, PIE programs run a *sequential*
algorithm over the whole local fragment (PEval), then repeat incremental
evaluation (IncEval) on received boundary messages until fixpoint — GRAPE's
auto-parallelization of sequential algorithms. Here both phases are dense
tensor programs over the fragment's owned slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.engines.grape.engine import GrapeEngine


@dataclasses.dataclass
class PIEProgram:
    """peval(engine) -> (state, emitted);  inc(state, msgs, step) ->
    (state, emitted); assemble(state) -> result. ``emitted`` is a dense [N]
    value vector the engine exchanges (compact-buffer) into the next
    round's ``msgs``."""

    peval: Callable[[GrapeEngine], Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]]
    inc: Callable[[Dict[str, torch.Tensor], torch.Tensor, int],
                  Tuple[Dict[str, torch.Tensor], torch.Tensor]]
    assemble: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
    combiner: str = "sum"
    use_weights: bool = False
    residual_key: Optional[str] = None
    tol: float = 1e-6


def run_pie(engine: GrapeEngine, prog: PIEProgram, max_rounds: int
            ) -> Dict[str, torch.Tensor]:
    state, emitted = prog.peval(engine)
    for r in range(max_rounds):
        owned = engine.owned_view(emitted)
        msgs = engine.superstep(owned, prog.combiner, prog.use_weights)
        new_state, emitted = prog.inc(state, msgs, r)
        if prog.residual_key is not None:
            res = float((new_state[prog.residual_key]
                         - state[prog.residual_key]).abs().sum())
            state = new_state
            if res < prog.tol:
                break
        else:
            state = new_state
    return prog.assemble(state)
