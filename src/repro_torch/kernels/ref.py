"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes exactly what its kernel computes, with the same
float32 arithmetic (the segment sum, like its kernel, accumulates in
float64), so results agree bit for bit wherever the values are integers
below 2**24 (path counts, distances, the tail's certified sums, degree
counts). The wrappers in :mod:`repro_torch.kernels.ops` use these for CPU
tensors; on the GPU they are the yardstick the kernels are held against
(``chip_smoke.py``, ``tests/test_torch_kernels.py``).
"""

from __future__ import annotations

import torch

# rows per chunk of the gather so the [B, rows, W] intermediate stays
# near 2**26 elements whatever the slab's width
_GATHER_ELEMS = 1 << 26


def _gather_rows(indices: torch.Tensor, x: torch.Tensor, lo: int, hi: int):
    """x[b, indices[lo:hi, w]] as [B, hi - lo, W] (padding reads vertex 0
    and is masked by the caller)."""
    idx = indices[lo:hi]
    safe = idx.clamp_min(0).reshape(-1).long()
    return x.index_select(1, safe).reshape(x.shape[0], *idx.shape)


def _row_chunks(indices: torch.Tensor, batch: int):
    R, W = indices.shape
    step = max(1, _GATHER_ELEMS // max(1, batch * W))
    return [(lo, min(R, lo + step)) for lo in range(0, R, step)]


def frontier_ref(indices: torch.Tensor, weights: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Batched pull-ELL hop. indices/weights [R, W] (pad < 0); x [B, N]
    → y [B, R]: y[b, r] = Σ_w x[b, indices[r, w]]·weights[r, w]."""
    x = x.float()
    out = torch.empty(x.shape[0], indices.shape[0], dtype=torch.float32,
                      device=x.device)
    for lo, hi in _row_chunks(indices, x.shape[0]):
        g = _gather_rows(indices, x, lo, hi)
        vals = torch.where((indices[lo:hi] >= 0)[None],
                           g * weights[lo:hi].float()[None], 0.0)
        out[:, lo:hi] = vals.sum(dim=2)
    return out


def frontier_minplus_ref(indices: torch.Tensor, weights: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Tropical pull-ELL hop. indices/weights [R, W] (pad < 0 or w == 0
    → +inf); x [B, N] distances → y [B, R]:
    y[b, r] = min_w x[b, indices[r, w]] + 1 over valid entries."""
    x = x.float()
    out = torch.empty(x.shape[0], indices.shape[0], dtype=torch.float32,
                      device=x.device)
    for lo, hi in _row_chunks(indices, x.shape[0]):
        g = _gather_rows(indices, x, lo, hi)
        valid = ((indices[lo:hi] >= 0) & (weights[lo:hi] > 0))[None]
        vals = torch.where(valid, g + 1.0, torch.inf)
        out[:, lo:hi] = vals.amin(dim=2) if vals.shape[2] else torch.inf
    return out


def frontier_step_ref(ell_idx: torch.Tensor, ell_w: torch.Tensor,
                      x: torch.Tensor, row_map: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """:func:`frontier_ref`, then split slab rows folded back onto their
    destination rows with a scatter-add: Y [B, n_rows]."""
    y_slab = frontier_ref(ell_idx, ell_w, x)
    out = torch.zeros(x.shape[0], n_rows, dtype=torch.float32,
                      device=x.device)
    return out.index_add_(1, row_map.long(), y_slab)


def frontier_minplus_step_ref(ell_idx: torch.Tensor, ell_w: torch.Tensor,
                              x: torch.Tensor, row_map: torch.Tensor,
                              n_rows: int) -> torch.Tensor:
    """:func:`frontier_minplus_ref`, then a scatter-min over ``row_map``:
    Y [B, n_rows], +inf where nothing relaxes."""
    y_slab = frontier_minplus_ref(ell_idx, ell_w, x)
    out = torch.full((x.shape[0], n_rows), torch.inf, dtype=torch.float32,
                     device=x.device)
    index = row_map.long()[None].expand_as(y_slab)
    return out.scatter_reduce_(1, index, y_slab, "amin")


def tail_reduce_ref(x: torch.Tensor, vals: torch.Tensor):
    """Masked per-row reductions of the device tail: x [B, N] float32
    counts (0 ⇒ absent), vals [C, N] float32. Returns (cnt [B],
    sums [B, C], sabs [B, C], mins [B, C], maxs [B, C]); the sums are
    elementwise products summed in float32 (no matmul, so never TF32)."""
    x = x.float()
    vals = vals.float()
    prod = x[:, None, :] * vals[None]                   # [B, C, N]
    cnt = x.sum(dim=1)
    sums = prod.sum(dim=2)
    sabs = (x[:, None, :] * vals.abs()[None]).sum(dim=2)
    present = (x > 0)[:, None, :]
    vb = vals[None].expand_as(prod)
    if x.shape[1]:
        mins = torch.where(present, vb, torch.inf).amin(dim=2)
        maxs = torch.where(present, vb, -torch.inf).amax(dim=2)
    else:
        mins = torch.full(prod.shape[:2], torch.inf, device=x.device)
        maxs = torch.full(prod.shape[:2], -torch.inf, device=x.device)
    return cnt, sums, sabs, mins, maxs


def spmv_ref(indices: torch.Tensor, weights: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV. indices/weights [R, W] (pad < 0); x [N] → y [R]:
    y[r] = Σ_w weights[r, w]·x[indices[r, w]] over entries with
    indices ≥ 0 (products rounded, then summed over W)."""
    return frontier_ref(indices, weights, x.float()[None])[0]


def spmv_step_ref(ell_idx: torch.Tensor, ell_w: torch.Tensor,
                  x: torch.Tensor, row_map: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """:func:`spmv_ref`, then split slab rows folded back onto their
    original rows with a scatter-add over ``row_map``: y [n_rows]."""
    y_slab = spmv_ref(ell_idx, ell_w, x)
    out = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    return out.index_add_(0, row_map.long(), y_slab)


def segment_sum_ref(vals: torch.Tensor, segs: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Segment sum: y [n_out] float32, y[s] = Σ vals[e] over entries with
    segs[e] == s; entries with segs < 0 are dropped. Needs no order of
    ``segs`` (the kernel needs them sorted). Accumulates in float64 and
    rounds once, as the kernel does: a float32 running sum over a hub
    segment of 10⁵–10⁶ entries would drift by about 1e-5 of its total."""
    keep = segs >= 0
    out = torch.zeros(n_out, dtype=torch.float64, device=vals.device)
    out.index_add_(0, segs[keep].long(), vals[keep].double())
    return out.float()
