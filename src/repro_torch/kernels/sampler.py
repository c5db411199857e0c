"""Batched fixed-fanout neighbour sampling — the GraphLearn hot loop
(DESIGN.md §10), in PyTorch.

One sampling hop draws ``K`` neighbours (with replacement) for each of
``M`` seed rows. The draw is a pure gather:

    col[m, k] = min(int32(u[m, k] · float32(deg[row_m])), max(deg − 1, 0))
    out[m, k] = indices[starts[row_m] + col[m, k]]

and ``PAD_SENTINEL`` where ``row_m < 0``, ``row_m ≥ R`` or
``deg[row_m] == 0``. ``u`` holds float32 uniforms in [0, 1); the product
is one float32 multiply, truncated toward zero, so every version of the
draw gives the same bits.

The JAX package draws off a per-vertex ELL *sampling slab* (one row per
vertex, padded to the lane-aligned maximum degree) and keeps it whole in
a TPU core's VMEM, gated at 8 MB. Here the addressing is CSR: an ELL slab
is the case ``starts[r] = r·W``, ``indices = ell.reshape(-1)``, so one
function serves both layouts and a CSR graph never densifies. There is no
slab to keep resident and so no size gate: the kernel reads ``starts``
and ``deg`` once per seed row and one ``indices`` entry per draw, and
needs O(E) memory at any degree skew (a power-law graph's slab is
160–800× its edge list).

:func:`sample_draw_ref` is the plain version; the CUDA kernel
(``csrc/sampler.cu``) computes the same function and is reached through
:func:`repro_torch.kernels.ops.sample_neighbors`, which :func:`sample_ell`
and :func:`sample_csr` call.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.storage.partition import PAD_SENTINEL


def sample_ell_width(deg: np.ndarray) -> int:
    """The slab width ``csr_to_sample_ell`` uses for a degree vector: the
    lane-aligned maximum degree, computable without allocating anything."""
    W = int(deg.max()) if len(deg) else 0
    W = max(1, W)
    return -(-W // 128) * 128 if W > 128 else W   # lane alignment


def csr_to_sample_ell(indptr: np.ndarray, indices: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR → (ell_idx [N, W], deg [N]) sampling slab (host side, once).

    Row r holds vertex r's neighbours in CSR order, padded to the
    lane-aligned maximum degree with ``PAD_SENTINEL``."""
    n = len(indptr) - 1
    deg = np.diff(indptr).astype(np.int32)
    W = sample_ell_width(deg)
    ell = np.full((n, W), PAD_SENTINEL, np.int32)
    if len(indices):
        rows = np.repeat(np.arange(n), deg)
        cols = np.arange(len(indices)) - np.repeat(indptr[:-1], deg)
        ell[rows, cols] = indices
    return ell, deg


def sample_draw_ref(starts: torch.Tensor, deg: torch.Tensor,
                    indices: torch.Tensor, rows: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """The draw with CSR addressing. starts int64 [R] / deg int32 [R]:
    each row's first position in ``indices`` and its length; indices
    int32 [E]; rows int32 [M] (outside [0, R) ⇒ no draw); u float32
    [M, K] → out int32 [M, K], ``PAD_SENTINEL`` for invalid or isolated
    rows."""
    R = starts.shape[0]
    in_range = (rows >= 0) & (rows < R)
    safe = torch.where(in_range, rows, 0).long()
    if R:
        d = deg.index_select(0, safe)[:, None]                  # [M, 1]
        s = starts.index_select(0, safe)[:, None]
    else:
        d = torch.zeros((rows.shape[0], 1), dtype=torch.int32,
                        device=rows.device)
        s = torch.zeros((rows.shape[0], 1), dtype=torch.int64,
                        device=rows.device)
    # one float32 multiply, truncated (both operands non-negative)
    col = torch.minimum((u * d.float()).to(torch.int32),
                        (d - 1).clamp_min(0))
    valid = in_range[:, None] & (d > 0)
    pos = torch.where(valid, s + col, 0)
    if indices.numel():
        nbr = indices.index_select(0, pos.reshape(-1)).reshape(pos.shape)
    else:
        nbr = torch.zeros_like(col)
    return torch.where(valid, nbr, PAD_SENTINEL).to(torch.int32)


def sample_csr(starts: torch.Tensor, deg: torch.Tensor,
               indices: torch.Tensor, rows: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """One hop straight off CSR (``starts`` = ``indptr[:-1]``)."""
    from repro_torch.kernels import ops
    return ops.sample_neighbors(starts, deg, indices, rows, u)


def sample_ell(ell_idx: torch.Tensor, deg: torch.Tensor, rows: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """One hop off an ELL sampling slab ``ell_idx`` [R, W]: the CSR draw
    with ``starts[r] = r·W`` over the flattened slab."""
    R, W = ell_idx.shape
    starts = torch.arange(R, dtype=torch.int64, device=ell_idx.device) * W
    return sample_csr(starts, deg, ell_idx.reshape(-1), rows, u)
