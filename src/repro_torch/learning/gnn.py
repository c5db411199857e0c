"""GraphSAGE (mean aggregator) in PyTorch — the learning stack's serving
model (paper §7/§8).

Parameters keep the JAX package's names and layout (``l{i}.w_self``,
``l{i}.w_nbr`` ``[in, out]``, ``l{i}.b``, ``out.w``, ``out.b``), so a
reference parameter tree crosses over with :func:`params_from_reference`
and the public functions take and return the JAX package's shapes. The
products are ``torch.matmul`` in strict float32: the JAX package computes
them outside any Pallas kernel, and TF32 (about three decimal digits)
would move scores far beyond the tolerance the port is held to.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device


@contextlib.contextmanager
def _strict_fp32():
    """Float32 products in full float32 on the GPU while the model runs:
    TF32 off in matmuls (no cuDNN op runs here), the caller's setting
    restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class GraphSAGE(nn.Module):
    """Mean-aggregator GraphSAGE over fixed-fanout sampled batches. The
    initial weights are drawn on the CPU from ``generator`` (the same on
    every device) and live on ``device`` (CUDA unless ``"cpu"``)."""

    def __init__(self, feature_dim: int, hidden: int, n_classes: int,
                 fanouts: Sequence[int], generator:
                 Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.feature_dim = feature_dim
        self.hidden = hidden
        self.n_classes = n_classes
        self.fanouts = tuple(int(f) for f in fanouts)
        dims = [feature_dim] + [hidden] * len(self.fanouts)

        def fan_in(shape):
            # the JAX package's "fan_in" init: N(0, 1/fan_in), fan_in = in
            w = torch.randn(shape, generator=generator) / math.sqrt(
                max(1, shape[0]))
            return nn.Parameter(w.to(device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device))

        for i in range(len(self.fanouts)):
            self.add_module(f"l{i}", nn.ParameterDict({
                "w_self": fan_in((dims[i], dims[i + 1])),
                "w_nbr": fan_in((dims[i], dims[i + 1])),
                "b": zeros(dims[i + 1])}))
        self.out = nn.ParameterDict({"w": fan_in((hidden, n_classes)),
                                     "b": zeros(n_classes)})

    @_strict_fp32()
    def embed(self, feats: List[torch.Tensor],
              layer_nbrs: List[torch.Tensor]) -> torch.Tensor:
        """feats[l]: frontier-l features [B·∏f[:l], D]; layer_nbrs[l] the
        sampled neighbour ids [B·∏f[:l], f[l]] (only their valid mask,
        id ≥ 0, is read) → embeddings [B, hidden]."""
        k = len(self.fanouts)
        h = list(feats)
        for l in range(k):
            lp = getattr(self, f"l{l}")
            new_h = []
            for depth in range(k - l):
                cur = h[depth]
                nbr = h[depth + 1].reshape(cur.shape[0], self.fanouts[depth],
                                           -1)
                valid = (layer_nbrs[depth].reshape(cur.shape[0], -1) >= 0
                         )[..., None].to(cur.dtype)
                mean_nbr = (nbr * valid).sum(dim=1) / \
                    valid.sum(dim=1).clamp_min(1.0)
                z = cur @ lp["w_self"] + mean_nbr @ lp["w_nbr"] + lp["b"]
                new_h.append(torch.relu(z))
            h = new_h
        return h[0]

    @_strict_fp32()
    def logits(self, feats: List[torch.Tensor],
               layer_nbrs: List[torch.Tensor]) -> torch.Tensor:
        """Class logits [B, n_classes]."""
        z = self.embed(feats, layer_nbrs)
        return z @ self.out["w"] + self.out["b"]

    forward = logits

    def loss(self, feats: List[torch.Tensor], layer_nbrs: List[torch.Tensor],
             labels: torch.Tensor) -> torch.Tensor:
        """Mean softmax cross-entropy of the logits against int labels."""
        return F.cross_entropy(self.logits(feats, layer_nbrs).float(),
                               labels.long())


def params_from_reference(tree: Mapping[str, Mapping[str, np.ndarray]]
                          ) -> Dict[str, torch.Tensor]:
    """The JAX package's GraphSAGE parameter tree (``GraphSAGE.init`` /
    ``SageTrainer.params``; arrays, e.g. converted with ``np.asarray``) →
    this module's state dict (``model.load_state_dict(...)``). Names and
    layouts are the same, so the crossing is a copy."""
    return {f"{layer}.{name}": torch.as_tensor(
                np.array(arr, dtype=np.float32, copy=True))
            for layer, group in tree.items() for name, arr in group.items()}
