"""Dispatch wrappers around the port's CUDA kernels.

Each wrapper checks its inputs, then runs the kernel for CUDA tensors
and the plain version from :mod:`repro_torch.kernels.ref` (the sampler's
from :mod:`repro_torch.kernels.sampler`) for CPU tensors; any other
device raises. There is no fallback: a kernel that
fails to build or launch raises. ``LAUNCHES`` counts kernel launches per
kernel, so a run can show that its main path went through them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.sampler import sample_draw_ref
from repro_torch.storage.partition import PAD_SENTINEL

LAUNCHES: Dict[str, int] = {"frontier_ell": 0, "frontier_ell_minplus": 0,
                            "tail_reduce_grid": 0, "segment_sum_sorted": 0,
                            "spmv_ell": 0, "sample_ell": 0}

# columns of N one block of the tail reduction covers (csrc/tail_reduce.cu)
TAIL_CHUNK = 4096


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plain(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------- slabs
def csr_to_ell(indptr: np.ndarray, indices: np.ndarray,
               weights: Optional[np.ndarray] = None,
               row_split: int = 1024) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR → padded ELL slab (host-side, done once per graph).

    Heavy rows (> row_split) are split into multiple slab rows; returns
    (ell_idx [N',W], ell_w [N',W], row_map [N'] — slab row → original row).
    """
    n = len(indptr) - 1
    if weights is None:
        weights = np.ones(len(indices), np.float32)
    rows = []
    for r in range(n):
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        for s in range(lo, hi, row_split):
            rows.append((r, s, min(hi, s + row_split)))
    if not rows:
        rows = [(0, 0, 0)]
    W = max(1, max(hi - lo for _, lo, hi in rows))
    W = -(-W // 128) * 128 if W > 128 else W      # lane alignment
    Np = -(-len(rows) // 256) * 256               # block_rows alignment
    ell_idx = np.full((Np, W), PAD_SENTINEL, np.int32)
    ell_w = np.zeros((Np, W), np.float32)
    row_map = np.zeros(Np, np.int64)
    for i, (r, lo, hi) in enumerate(rows):
        ell_idx[i, : hi - lo] = indices[lo:hi]
        ell_w[i, : hi - lo] = weights[lo:hi]
        row_map[i] = r
    return ell_idx, ell_w, row_map


def spmv(ell_idx: torch.Tensor, ell_w: torch.Tensor, x: torch.Tensor,
         row_map: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y = A @ x over the ELL slab (``csr_to_ell``): y [n_rows] from
    x [N] float32; split slab rows fold back onto their original rows
    with a scatter-add, outside the kernel as in the JAX package."""
    _require(x.dim() == 1, "x must be float32 [N]")
    _check_slab(ell_idx, ell_w, x[None], row_map)
    if _plain(x):
        return ref.spmv_step_ref(ell_idx, ell_w, x, row_map, n_rows)
    from repro_torch.kernels import build

    R, W = ell_idx.shape
    y_slab = torch.empty(R, dtype=torch.float32, device=x.device)
    if R:
        err = build.library("spmv").spmv_ell_launch(
            ell_idx.data_ptr(), ell_w.data_ptr(), x.data_ptr(),
            y_slab.data_ptr(), R, W, x.device.index or 0, _stream(x))
        _check_cuda(err, "spmv_ell")
        LAUNCHES["spmv_ell"] += 1
    out = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    return out.index_add_(0, row_map, y_slab)


# -------------------------------------------------------- segment sum
def _check_segments(segs: torch.Tensor, n_out: int) -> None:
    """Raise ``ValueError`` unless ``segs`` is ascending with every id
    below ``n_out`` (negative ids allowed: dropped entries). One device
    reduction and one host sync the first time a tensor is seen; the
    verdict is kept on the tensor with its version counter, so an
    unchanged tensor (an engine's prepared segments) is not checked again
    and one written in place since is."""
    tag = (segs._version, n_out)
    if getattr(segs, "_segments_checked", None) == tag:
        return
    if segs.numel():
        bad = segs[-1] >= n_out
        if segs.numel() > 1:
            bad = bad | (segs[1:] < segs[:-1]).any()
        if bool(bad):
            raise ValueError("segment_sum needs segs sorted ascending, "
                             f"each below n_out = {n_out}")
    segs._segments_checked = tag


def segment_sum(vals: torch.Tensor, segs: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Sorted-segment sum: y [n_out] float32, y[s] = Σ vals[e] over
    segs[e] == s. ``segs`` int32 [E] must be sorted ascending (negative
    ⇒ dropped; they sort first); unsorted input raises ``ValueError`` on
    every device — there is no unsorted fallback. Deterministic on the
    card: no atomics, each segment reduced by one warp in a fixed
    order."""
    _require(vals.dtype == torch.float32 and vals.dim() == 1,
             "vals must be float32 [E]")
    _require(segs.dtype == torch.int32 and segs.shape == vals.shape,
             "segs must be int32 with vals' shape")
    _require(segs.device == vals.device, "vals and segs must be on one "
             "device")
    _require(vals.is_contiguous() and segs.is_contiguous(),
             "vals and segs must be contiguous")
    plain = _plain(vals)
    _check_segments(segs, n_out)
    if plain:
        return ref.segment_sum_ref(vals, segs, n_out)
    from repro_torch.kernels import build

    y = torch.empty(n_out, dtype=torch.float32, device=vals.device)
    if n_out:
        err = build.library("segment_sum").segment_sum_launch(
            vals.data_ptr(), segs.data_ptr(), y.data_ptr(), vals.numel(),
            n_out, vals.device.index or 0, _stream(vals))
        _check_cuda(err, "segment_sum_sorted")
        LAUNCHES["segment_sum_sorted"] += 1
    return y


# ------------------------------------------------------------ sampling
def sample_neighbors(starts: torch.Tensor, deg: torch.Tensor,
                     indices: torch.Tensor, rows: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """One fixed-fanout sampling hop off CSR (``kernels/sampler.py``):
    starts int64 [R] and deg int32 [R] locate each row's neighbours in
    indices int32 [E]; rows int32 [M] (outside [0, R) ⇒ no draw); u
    float32 [M, K] uniforms in [0, 1) → out int32 [M, K], PAD_SENTINEL for
    invalid or isolated rows. The kernel trusts ``starts[r] + deg[r] ≤ E``
    (the executor builds them from one CSR)."""
    _require(starts.dtype == torch.int64 and starts.dim() == 1,
             "starts must be int64 [R]")
    _require(deg.dtype == torch.int32 and deg.shape == starts.shape,
             "deg must be int32 with starts' shape")
    _require(indices.dtype == torch.int32 and indices.dim() == 1,
             "indices must be int32 [E]")
    _require(rows.dtype == torch.int32 and rows.dim() == 1,
             "rows must be int32 [M]")
    _require(u.dtype == torch.float32 and u.dim() == 2
             and u.shape[0] == rows.shape[0], "u must be float32 [M, K]")
    _require(all(t.device == u.device for t in (starts, deg, indices, rows)),
             "sampling inputs must be on one device")
    _require(all(t.is_contiguous() for t in (starts, deg, indices, rows, u)),
             "sampling inputs must be contiguous")
    _require(starts.shape[0] < 2 ** 31, "at most 2**31 - 1 rows")
    if _plain(u):
        return sample_draw_ref(starts, deg, indices, rows, u)
    from repro_torch.kernels import build

    M, K = u.shape
    out = torch.empty((M, K), dtype=torch.int32, device=u.device)
    if M and K:
        err = build.library("sampler").sample_neighbors_launch(
            starts.data_ptr(), deg.data_ptr(), indices.data_ptr(),
            rows.data_ptr(), u.data_ptr(), out.data_ptr(), M, K,
            starts.shape[0], u.device.index or 0, _stream(u))
        _check_cuda(err, "sample_ell")
        LAUNCHES["sample_ell"] += 1
    return out


# --------------------------------------------------------- frontier hop
def _check_slab(ell_idx, ell_w, x, row_map) -> None:
    _require(ell_idx.dtype == torch.int32 and ell_idx.dim() == 2,
             "ell_idx must be int32 [R, W]")
    _require(ell_w.dtype == torch.float32 and ell_w.shape == ell_idx.shape,
             "ell_w must be float32 with ell_idx's shape")
    _require(x.dtype == torch.float32 and x.dim() == 2,
             "x must be float32 [B, N]")
    _require(row_map.dtype == torch.int64
             and row_map.shape == (ell_idx.shape[0],),
             "row_map must be int64 [R]")
    _require(all(t.device == x.device for t in (ell_idx, ell_w, row_map)),
             "slab and frontier must be on one device")
    _require(all(t.is_contiguous() for t in (ell_idx, ell_w, x, row_map)),
             "slab and frontier must be contiguous")


def _frontier_launch(name: str, minplus: int, ell_idx, ell_w, x, row_map,
                     n_rows: int) -> torch.Tensor:
    from repro_torch.kernels import build

    B = x.shape[0]
    R, W = ell_idx.shape
    fill = torch.inf if minplus else 0.0
    # vertex-major: one gathered source is one contiguous B-vector
    yT = torch.full((n_rows, B), fill, dtype=torch.float32, device=x.device)
    if R and W and B:
        xT = x.t().contiguous()
        err = build.library("frontier").frontier_ell_launch(
            ell_idx.data_ptr(), ell_w.data_ptr(), row_map.data_ptr(),
            xT.data_ptr(), yT.data_ptr(), R, W, B, minplus,
            x.device.index or 0, _stream(x))
        _check_cuda(err, name)
        LAUNCHES[name] += 1
    return yT.t().contiguous()


def frontier_step(ell_idx: torch.Tensor, ell_w: torch.Tensor,
                  x: torch.Tensor, row_map: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """One batched EXPAND hop: Y [B, n_rows] = X [B, N] pushed through the
    pull-ELL slab (``csr_to_ell`` of the hop's *reverse* adjacency), slab
    rows reduced back onto destination vertices with a scatter-add."""
    _check_slab(ell_idx, ell_w, x, row_map)
    if _plain(x):
        return ref.frontier_step_ref(ell_idx, ell_w, x, row_map, n_rows)
    return _frontier_launch("frontier_ell", 0, ell_idx, ell_w, x, row_map,
                            n_rows)


def frontier_minplus_step(ell_idx: torch.Tensor, ell_w: torch.Tensor,
                          x: torch.Tensor, row_map: torch.Tensor,
                          n_rows: int) -> torch.Tensor:
    """One batched min-plus (shortest-path) relaxation: Y [B, n_rows] =
    X [B, N] distances (non-negative, +inf = unreached) pulled through the
    ELL slab in the tropical semiring; split heavy rows take the min of
    their parts."""
    _check_slab(ell_idx, ell_w, x, row_map)
    if _plain(x):
        return ref.frontier_minplus_step_ref(ell_idx, ell_w, x, row_map,
                                             n_rows)
    return _frontier_launch("frontier_ell_minplus", 1, ell_idx, ell_w, x,
                            row_map, n_rows)


# ----------------------------------------------------------- device tail
def tail_reduce(x: torch.Tensor, vals: torch.Tensor):
    """Masked per-row reductions for the device tail (DESIGN.md §14):
    ``x`` [B, N] float32 path counts (0 ⇒ vertex absent from the row's
    multiset), ``vals`` [C, N] float32 aggregate value vectors. Returns
    ``(cnt [B], sums [B, C], sabs [B, C], mins [B, C], maxs [B, C])`` —
    COUNT(*), weighted SUMs, their absolute-value twins (the float32
    exactness certificate), and masked MIN/MAX (±inf on empty rows)."""
    _require(x.dtype == torch.float32 and x.dim() == 2,
             "x must be float32 [B, N]")
    _require(vals.dtype == torch.float32 and vals.dim() == 2
             and vals.shape[1] == x.shape[1], "vals must be float32 [C, N]")
    _require(vals.device == x.device, "x and vals must be on one device")
    _require(x.is_contiguous() and vals.is_contiguous(),
             "x and vals must be contiguous")
    if _plain(x):
        return ref.tail_reduce_ref(x, vals)
    from repro_torch.kernels import build

    B, N = x.shape
    C = vals.shape[0]
    _require(B <= 65535, "tail_reduce takes at most 65535 rows")
    slots = 1 + 4 * C
    out = torch.empty((B, slots), dtype=torch.float32, device=x.device)
    if B:
        partial = torch.empty((-(-N // TAIL_CHUNK), B, slots),
                              dtype=torch.float32, device=x.device)
        err = build.library("tail_reduce").tail_reduce_launch(
            x.data_ptr(), vals.data_ptr(), partial.data_ptr(),
            out.data_ptr(), B, N, C, TAIL_CHUNK, x.device.index or 0,
            _stream(x))
        _check_cuda(err, "tail_reduce_grid")
        LAUNCHES["tail_reduce_grid"] += 1
    return (out[:, 0], out[:, 1:1 + C], out[:, 1 + C:1 + 2 * C],
            out[:, 1 + 2 * C:1 + 3 * C], out[:, 1 + 3 * C:])


def masked_order(key: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of ``key`` restricted to ``mask`` lanes:
    masked-out entries take a +inf key and sort last, so the first
    ``mask.sum()`` indices are the result in ascending key order (ties in
    lane order — the interpreter's stable-sort tie order; the host
    reverses that slice for DESC, matching its reversed stable sort)."""
    masked = torch.where(mask, key, torch.inf)
    return torch.sort(masked, dim=-1, stable=True).indices
