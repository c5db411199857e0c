#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (into ``build/``) and prints the build time and ``ptxas``
   register and spill lines;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (the full-width store's KNOWS pull
   slab at B = 64; the tail reduction at B = 64, C = 4, N = 114,688; the
   GRAPE segment sum over the store's 2,162,674 edges sorted by
   destination into 114,688 segments; the SpMV on the KNOWS slab at
   B = 1): results must be bit-identical on integer inputs below 2**24,
   and within the stated tolerance on float inputs. Times each kernel,
   its plain version and, where one exists, one PyTorch call computing
   the same function;
4. serves read and hybrid templates through
   ``repro_torch.serving.QueryService`` on the full-width store
   ``snb_store(65536, 32768, 16384, seed=0)`` (114,688 vertices, 2.16M
   edges) with B = 64 requests per template: each must land on its
   expected route, every kernel's launch counter but ``spmv_ell``'s must
   move during that run, the device tail must finish on the device, every
   read result must be bag-equal to the port's own interpreter, and every
   ``grape`` result must match the same request served by
   ``QueryService(store, device="cpu")`` (the plain versions);
5. profiles the device busy share of one batch of each fragment template
   and of the pagerank template (fixpoint recomputed);
6. on the learning configuration — GraphSAGE with feature dim 32, hidden
   64, 4 classes, fanouts (15, 10) over ``rmat_store(17, 16, seed=6)``
   (131,072 vertices, 2,097,152 edges) — holds the ``sample_ell`` kernel
   bit-exact against its plain version at both hop shapes (M = 2,048,
   K = 15 and M = 30,720, K = 10) with planted edge cases on CSR and on a
   small ELL slab, and on every launch of one full-graph inference, whose
   inputs it also times the kernel on; serves
   B = 64 ``CALL gnn.infer`` requests through ``QueryService`` (route
   ``grape``, memo cleared first) with parameters crossed over from a
   reference-layout tree; requires served scores equal to the offline
   ``infer_scores`` bit for bit, and the card's draws identical to
   ``device="cpu"``'s under shared uniforms, with scores within rtol 1e-5,
   atol 1e-5 and the same top-10 rows where the score gaps exceed that;
   profiles one batch of the template;
7. prints one ``kernels`` JSON line, the device line, and last the
   ``{"ok": true, ...}`` line.

Exits non-zero, with no result line, when CUDA is absent or the port's
sources are not beside this file. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# one H100 SXM (NVIDIA data sheet): memory rate and float32 rate outside
# the tensor cores — the kernels here are float32 gathers and reductions
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

FULL = dict(n_persons=65_536, n_items=32_768, n_posts=16_384, seed=0)
B = 64
SEED = 0

TEMPLATES = [
    # (name, template, params of query b, expected route)
    ("point_lookup",
     "MATCH (v:Person {id: $c}) RETURN v.credits AS c",
     lambda b: {"c": 97 * b + 5}, "hiactor"),
    ("two_hop_group_topk",
     "MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person)-[:BUY]->(i:Item) "
     "WITH i, COUNT(*) AS k RETURN i AS i, k AS k ORDER BY k DESC LIMIT 10",
     lambda b: {"r": b % 8}, "fragment"),
    ("scalar_tail",
     "MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person) "
     "WITH COUNT(*) AS c, SUM(b.region) AS s, MIN(b.credits) AS lo, "
     "MAX(b.credits) AS hi RETURN c AS c, s AS s, lo AS lo, hi AS hi",
     lambda b: {"r": b % 8}, "fragment"),
    ("shortest_path",
     "MATCH p = shortestPath((a:Person {id: $c})-[:KNOWS*1..4]->(b:Person)) "
     "RETURN b AS b, dist AS d",
     lambda b: {"c": 1009 * b + 3}, "fragment"),
    # hybrid CALL algo.* templates: a GRAPE fixpoint per distinct argument
    # (memoized per snapshot), then the interpreter over its rows
    ("pagerank_topk",
     "CALL algo.pagerank($d) YIELD v, rank MATCH (v:Person) WHERE rank > $t "
     "RETURN v AS v, rank AS r ORDER BY r DESC LIMIT 10",
     lambda b: {"d": 0.85, "t": 1e-6 * b}, "grape"),
    ("degree_topk",
     "CALL algo.degree_centrality() YIELD v, centrality MATCH (v:Person) "
     "WHERE centrality > $t RETURN v AS v, centrality AS c "
     "ORDER BY c DESC LIMIT 10",
     lambda b: {"t": 1e-6 * b}, "grape"),
    ("bfs_count",
     "CALL algo.bfs($s) YIELD v, depth MATCH (v:Person) WHERE depth < $k "
     "WITH COUNT(v) AS n RETURN n AS n",
     lambda b: {"s": [0, 1009, 30_011, 65_000][b % 4], "k": 1 + b % 5},
     "grape"),
]
# float columns of these templates come from a float32 sum in another
# order than the CPU's: held within the reference's pagerank tolerance
# (tests/test_grape.py); every other column must be exact
RANK_TOL = {"pagerank_topk": (1e-4, 1e-7)}
# kernels the served templates do not reach: spmv_ell is an op of the
# GRAPE kernel family that no serving path calls, in the JAX package too
NOT_ON_MAIN_PATH = {"spmv_ell"}

# the learning path: the repo's GraphSAGE configuration (benchmarks/
# learning_bench.py exp5: feature dim 32, hidden 64, 4 classes, fanouts
# (15, 10)) on its R-MAT generator at 32x exp5's scale, about the size of
# ogbn-arxiv; the kernels it runs are counted in its own run
GNN_STORE = dict(scale=17, edge_factor=16, seed=6)
GNN_DIM, GNN_HIDDEN, GNN_CLASSES, GNN_FANOUTS = 32, 64, 4, (15, 10)
GNN_TEMPLATE = ("CALL gnn.infer($m) YIELD v, score "
                "RETURN v AS v, score AS s ORDER BY s DESC LIMIT 10")
GNN_KERNELS = {"sample_ell"}
# card against CPU under shared uniforms: the same draws, float32 products
# summed in another order
GNN_RTOL, GNN_ATOL = 1e-5, 1e-5
RANK_TOL["gnn_infer_topk"] = (GNN_RTOL, GNN_ATOL)
# the unit of the draw's random reads: one 32-byte sector
SECTOR = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA
    events around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, iters: int = 100) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in one CUDA
    graph and replayed under CUDA events. A kernel shorter than its host
    launch is otherwise timed at the rate the host can launch it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=10, warmup=2) / iters


def bound_ms(n_bytes: float, n_flops: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def bag_equal(a, b) -> bool:
    import numpy as np

    if set(a) != set(b):
        return False
    keys = sorted(a)
    if not keys:
        return True
    ra = np.stack([np.asarray(a[k], np.float64).ravel() for k in keys], 1)
    rb = np.stack([np.asarray(b[k], np.float64).ravel() for k in keys], 1)
    if ra.shape != rb.shape:
        return False
    ra = ra[np.lexsort(ra.T[::-1])]
    rb = rb[np.lexsort(rb.T[::-1])]
    return bool(np.array_equal(ra, rb))


def check_kernels(pg, dev):
    """Phase 3: every kernel against its plain version at main-path
    shapes; returns the per-kernel records (launches filled in later)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.storage.generators import E_KNOWS

    rng = np.random.default_rng(SEED)
    n = pg.n_vertices
    # the KNOWS pull slab of a (a)-[:KNOWS]->(b) hop at F = 1
    indptr, indices, _ = pg.sliced_csr(E_KNOWS, "in")
    ell_idx, ell_w, row_map = ops.csr_to_ell(indptr, indices.astype(np.int32))
    idx_t = torch.as_tensor(ell_idx, device=dev)
    w_t = torch.as_tensor(ell_w, device=dev)
    rm_t = torch.as_tensor(row_map, device=dev)
    R, W = ell_idx.shape
    nnz = int((ell_idx >= 0).sum())
    print(f"KNOWS slab R={R} W={W} entries={nnz} "
          f"fill={nnz / (R * W):.4%}")
    # path counts: small integers on ~20 % of the vertices
    x = np.where(rng.random((B, n)) < 0.2, rng.integers(1, 4, (B, n)), 0)
    x_t = torch.as_tensor(x.astype(np.float32), device=dev)
    # distances: 0..4 on ~10 % of the vertices, +inf elsewhere
    d = np.where(rng.random((B, n)) < 0.1,
                 rng.integers(0, 5, (B, n)).astype(np.float32), np.inf)
    d_t = torch.as_tensor(d.astype(np.float32), device=dev)
    # the tail: counts and C = 4 small integer value vectors
    C = 4
    vals = rng.integers(-8, 1000, (C, n)).astype(np.float32)
    vals[0] = rng.integers(0, 8, n)                # a region-like column
    xt = np.where(rng.random((B, n)) < 0.05, rng.integers(1, 3, (B, n)), 0)
    xt_t = torch.as_tensor(xt.astype(np.float32), device=dev)
    vals_t = torch.as_tensor(vals, device=dev)
    if (xt.astype(np.float64) @ np.abs(vals).T).max() >= 2 ** 24:
        fail("tail check inputs exceed the 2**24 certificate")

    records = []
    slab_bytes = R * W * 4 + nnz * 4 + R * 8     # idx, w where valid, row_map
    xy_bytes = B * n * 4 * 2                     # x read, y written
    cases = [
        ("frontier_ell", "src/repro_torch/kernels/csrc/frontier.cu",
         "src/repro/kernels/frontier.py:42",
         lambda: ops.frontier_step(idx_t, w_t, x_t, rm_t, n),
         lambda: ref.frontier_step_ref(idx_t, w_t, x_t, rm_t, n),
         slab_bytes + xy_bytes, 2.0 * B * nnz),
        ("frontier_ell_minplus", "src/repro_torch/kernels/csrc/frontier.cu",
         "src/repro/kernels/frontier.py:86",
         lambda: ops.frontier_minplus_step(idx_t, w_t, d_t, rm_t, n),
         lambda: ref.frontier_minplus_step_ref(idx_t, w_t, d_t, rm_t, n),
         slab_bytes + xy_bytes, 2.0 * B * nnz),
        ("tail_reduce_grid", "src/repro_torch/kernels/csrc/tail_reduce.cu",
         "src/repro/kernels/reduce.py:59",
         lambda: ops.tail_reduce(xt_t, vals_t),
         lambda: ref.tail_reduce_ref(xt_t, vals_t),
         B * n * 4 + C * n * 4 + B * (1 + 4 * C) * 4,
         B * n * (1.0 + 7 * C)),
    ]
    # yardsticks the port never calls: one PyTorch call per function
    a_csr = torch.sparse_csr_tensor(
        torch.as_tensor(indptr, device=dev),
        torch.as_tensor(indices.astype(np.int64), device=dev),
        torch.ones(len(indices), device=dev), size=(n, n))
    x_cols = x_t.t().contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    library = {
        "frontier_ell": lambda: torch.sparse.mm(a_csr, x_cols),
        "frontier_ell_minplus": None,
        "tail_reduce_grid": lambda: torch.matmul(xt_t, vals_t.T),
    }
    for name, source, replaces, kern, plain, n_bytes, n_flops in cases:
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w_ in zip(got, want):
            if g.shape != w_.shape:
                fail(f"{name}: shape {tuple(g.shape)} != {tuple(w_.shape)}")
            same = torch.equal(g, w_)
            finite = torch.isfinite(g) & torch.isfinite(w_)
            diff = (g[finite] - w_[finite]).abs()
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            if not same:
                fail(f"{name}: kernel differs from its plain version "
                     f"(max |diff| {err})")
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        lib = library[name]
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib) if lib is not None else None})
        print(f"{name}: bit-exact; kernel {records[-1]['ms']:.4f} ms, "
              f"plain {records[-1]['plain_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    records += check_grape_kernels(pg, dev, idx_t, w_t, rm_t, a_csr)
    # timing launches are not main-path launches
    ops.reset_launches()
    return records


def check_grape_kernels(pg, dev, idx_t, w_t, rm_t, a_csr):
    """segment_sum_sorted at the GRAPE superstep's shape and spmv_ell on
    the KNOWS pull slab at B = 1: bit-identical to the plain version on
    integer values, within the stated tolerance on float values."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 1)
    n = pg.n_vertices
    # the pagerank superstep: every edge's source value, combined at its
    # destination; edges sorted by destination as GrapeEngine sorts them
    indptr, indices = pg.grin.store.adjacency()
    src = np.repeat(np.arange(n), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    segs = torch.as_tensor(indices[order].astype(np.int32), device=dev)
    E = len(order)
    deg = np.maximum(np.diff(indptr), 1).astype(np.float32)
    rank = rng.random(n).astype(np.float32)
    rank /= rank.sum()
    ones = torch.ones(E, dtype=torch.float32, device=dev)
    vals = torch.as_tensor((rank / deg)[src[order]], device=dev)
    records = []

    got = ops.segment_sum(ones, segs, n)
    if not torch.equal(got, ref.segment_sum_ref(ones, segs, n)):
        fail("segment_sum_sorted: counts differ from the plain version")
    got = ops.segment_sum(vals, segs, n)
    if not torch.equal(got, ops.segment_sum(vals, segs, n)):
        fail("segment_sum_sorted: two runs gave different bits")
    want = ref.segment_sum_ref(vals, segs, n)
    err = float((got - want).abs().max())
    scale = float(ref.segment_sum_ref(vals.abs(), segs, n).max())
    print(f"segment_sum_sorted: E={E} n_out={n} hub segment "
          f"{int(torch.bincount(segs.long()).max())} entries; float max |diff| "
          f"{err:.3e} <= 1e-6 * max segment sum|.| {scale:.6e}")
    if err > 1e-6 * scale:
        fail(f"segment_sum_sorted: max |diff| {err} > 1e-6 * {scale}")
    lengths = torch.bincount(segs.long(), minlength=n)
    b_ms, b_by = bound_ms(4 * E + 4 * E + 4 * n, E)
    records.append({
        "name": "segment_sum_sorted", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum.py:42", "launches": 0,
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.segment_sum(vals, segs, n)),
        "plain_ms": time_ms(lambda: ref.segment_sum_ref(vals, segs, n),
                            iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.segment_reduce(
            vals, "sum", lengths=lengths))})

    R, W = idx_t.shape
    nnz = int((idx_t >= 0).sum())
    xi = torch.as_tensor(rng.integers(0, 8, n).astype(np.float32),
                         device=dev)
    if not torch.equal(ops.spmv(idx_t, w_t, xi, rm_t, n),
                       ref.spmv_step_ref(idx_t, w_t, xi, rm_t, n)):
        fail("spmv_ell: differs from the plain version on integer x")
    xf = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
    got = ops.spmv(idx_t, w_t, xf, rm_t, n)
    want = ref.spmv_step_ref(idx_t, w_t, xf, rm_t, n)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        fail(f"spmv_ell: beyond rtol 1e-5 of the plain version ({err})")
    b_ms, b_by = bound_ms(R * W * 4 + nnz * 4 + R * 8 + n * 4 + n * 4,
                          2.0 * nnz)
    x_col = xf[:, None]
    records.append({
        "name": "spmv_ell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spmv.cu",
        "replaces": "src/repro/kernels/spmv.py:37", "launches": 0,
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.spmv(idx_t, w_t, xf, rm_t, n)),
        "plain_ms": time_ms(lambda: ref.spmv_step_ref(idx_t, w_t, xf, rm_t,
                                                      n), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.sparse.mm(a_csr, x_col))})
    for rec in records:
        print(f"{rec['name']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
              f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"max |err| {rec['max_abs_err']:.3e}")
    return records


def rows_mismatch(name, want, got):
    """A grape response against the CPU service's: the same columns and
    rows; float columns of a RANK_TOL template within its tolerance, with
    the integer columns compared where the rank pins the row (adjacent
    ranks farther apart than the tolerance); every column of the other
    templates exact. Returns None when they match, else what differs."""
    import numpy as np

    if set(want) != set(got):
        return f"columns {sorted(got)} != {sorted(want)}"
    rtol, atol = RANK_TOL.get(name, (0.0, 0.0))
    floats = [k for k in want if np.asarray(want[k]).dtype.kind == "f"]
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        if a.shape != b.shape:
            return f"{k}: shape {b.shape} != {a.shape}"
        if a.dtype.kind == "f":
            if not np.allclose(b, a, rtol=rtol, atol=atol):
                return f"{k}: {b.tolist()} != {a.tolist()}"
            continue
        keep = np.ones(len(a), bool)
        if floats and name in RANK_TOL:
            r = np.asarray(want[floats[0]], np.float64)
            gap = np.abs(np.diff(r)) > atol + rtol * np.abs(r[1:])
            keep &= np.concatenate([[True], gap])     # apart from the left
            keep &= np.concatenate([gap, [True]])     # and from the right
        if not np.array_equal(a[keep], b[keep]):
            return f"{k}: {b.tolist()} != {a.tolist()}"
    return None


def serve(store, dev):
    """Phase 4: the main path through QueryService; returns the launch
    counts of the measured run and per-template batch latencies."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import QueryService

    svc = QueryService(store, device=dev)
    # warm-up pass: builds the hop slabs, device masks and GRAPE engine
    for _name, q, params, _route in TEMPLATES:
        svc.serve([(q, params(b)) for b in range(B)])
    torch.cuda.synchronize()
    # the measured run computes its fixpoints anew, not from the memo
    svc.procedures.clear()
    ops.reset_launches()
    latency = {}
    responses = {}
    for name, q, params, route in TEMPLATES:
        t0 = time.perf_counter()
        rs, _stats = svc.serve([(q, params(b)) for b in range(B)])
        torch.cuda.synchronize()
        latency[name] = (time.perf_counter() - t0) * 1e3
        responses[name] = rs
    launches = dict(ops.LAUNCHES)
    print("launches on the main path:", json.dumps(launches))
    # the grape answers of the port's plain versions, on the CPU
    cpu = QueryService(store, device="cpu")
    for name, q, params, route in TEMPLATES:
        rs = responses[name]
        got = {r.engine for r in rs}
        if got != {route}:
            fail(f"{name}: served on {sorted(got)}, expected {route}")
        if route == "grape":
            t0 = time.perf_counter()
            want, _ = cpu.serve([(q, params(b)) for b in range(B)])
            cpu_ms = (time.perf_counter() - t0) * 1e3
            for b, (w_, r) in enumerate(zip(want, rs)):
                why = rows_mismatch(name, w_.result, r.result)
                if why is not None:
                    fail(f"{name}: query {b} differs from the CPU service: "
                         f"{why}")
            print(f"{name}: route grape, {len(rs)} requests, batch "
                  f"{latency[name]:.3f} ms, first request (fixpoint) "
                  f"{rs[0].service_us / 1e3:.3f} ms, rest "
                  f"{sum(r.service_us for r in rs[1:]) / 1e3:.3f} ms; "
                  f"matches the CPU service ({cpu_ms:.1f} ms there)")
            continue
        plan, _ = svc.compile(q)
        for b, r in enumerate(rs):
            want = svc.gaia.execute_plan(plan.bind(params(b)))
            if not bag_equal(want, r.result):
                fail(f"{name}: query {b} differs from the interpreter")
        print(f"{name}: route {route}, {len(rs)} requests, batch "
              f"{latency[name]:.3f} ms, bag-equal to the interpreter")
    for ex in svc.gaia._frontier_execs.values():
        for key, arrs in ex._hops.items():
            for ell_idx, _w, _rm in arrs.frags:
                nnz = int((ell_idx >= 0).sum())
                print(f"slab {key[:2]}: R={ell_idx.shape[0]} "
                      f"W={ell_idx.shape[1]} entries={nnz} "
                      f"fill={nnz / ell_idx.numel():.4%}")
    profile_device_share(svc)
    tails = {k: v for ex in svc.gaia._frontier_execs.values()
             for k, v in ex.tail_stats.items()}
    if not tails.get("device"):
        fail(f"no batch finished its tail on the device: {tails}")
    for name, count in launches.items():
        if count <= 0 and name not in NOT_ON_MAIN_PATH | GNN_KERNELS:
            fail(f"kernel {name} was not launched on the main path")
    return launches, latency


def profile_device_share(svc) -> None:
    """One more batch of each fragment template, and of the pagerank
    template with its fixpoint recomputed, under torch.profiler: the
    device's busy time (kernels and copies) beside the batch's wall time;
    the rest is host work (planning, masks, row assembly, the fixpoint's
    per-superstep residual read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, q, params, route in TEMPLATES:
        if route != "fragment" and name != "pagerank_topk":
            continue
        profile_batch(svc, name, [(q, params(b)) for b in range(B)])


def profile_batch(svc, name, reqs) -> None:
    """One batch under torch.profiler, memo cleared first: its wall time,
    the device's busy time and the top device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    svc.procedures.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.serve(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  ) / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile {name}: batch {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.2%}); top: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms "
                      f"({e.count} calls)" for e in top))


def learning_store():
    """The learning configuration's graph with exp5's features (standard
    normal, dim 32, ``default_rng(0)``) and labels (0..3)."""
    import numpy as np

    from repro_torch.storage.generators import rmat_store

    g = rmat_store(**GNN_STORE)
    rng = np.random.default_rng(0)
    g._vprops["feat"] = rng.standard_normal(
        (g.n_vertices, GNN_DIM)).astype(np.float32)
    g._vprops["label"] = rng.integers(0, GNN_CLASSES,
                                      g.n_vertices).astype(np.int32)
    return g


def reference_tree():
    """GraphSAGE parameters in the JAX package's tree layout, made from the
    seed with numpy (its "fan_in" init: N(0, 1/fan_in); zero biases)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    dims = [GNN_DIM] + [GNN_HIDDEN] * len(GNN_FANOUTS)

    def fan_in(a, b):
        return (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)

    tree = {f"l{i}": {"w_self": fan_in(dims[i], dims[i + 1]),
                      "w_nbr": fan_in(dims[i], dims[i + 1]),
                      "b": np.zeros(dims[i + 1], np.float32)}
            for i in range(len(GNN_FANOUTS))}
    tree["out"] = {"w": fan_in(GNN_HIDDEN, GNN_CLASSES),
                   "b": np.zeros(GNN_CLASSES, np.float32)}
    return tree


def sample_bound(starts, deg, idx, rows, u):
    """Bytes one draw must move for these inputs and the bound they set:
    u, rows and out once each, and each distinct 32-byte sector of deg and
    starts (in-range seed rows) and of indices (valid draws) that the
    inputs touch — a row drawn from twice, or draws that share a sector,
    are counted once."""
    import torch

    M, K = u.shape
    in_range = (rows >= 0) & (rows < starts.shape[0])
    r = rows[in_range].long()
    d = deg[r][:, None]
    col = torch.minimum((u[in_range] * d.float()).to(torch.int32),
                        (d - 1).clamp_min(0))
    pos = (starts[r][:, None] + col)[(d > 0).expand_as(col)]
    sectors = (torch.unique(r // (SECTOR // 4)).numel()          # deg
               + torch.unique(r // (SECTOR // 8)).numel()        # starts
               + torch.unique(pos // (SECTOR // 4)).numel())     # indices
    n_bytes = M * K * 4 * 2 + M * 4 + SECTOR * sectors
    return bound_ms(n_bytes, 0.0)[0]


def inference_draws(ex, fanouts, key=0):
    """The sampling inputs of one full-graph ``infer_scores(key=key)``:
    for each hop, the (rows, u) of every chunk — hop 1's rows are the
    chunk's seeds, hop 2's the chunk's hop-1 draws — as the main path
    makes them (the same chunk grid and per-chunk generator seeds)."""
    import torch

    from repro_torch.learning import SageTrainer
    from repro_torch.learning.sampler import step_seed

    dev, n = ex.device, ex.n_vertices
    chunk = SageTrainer.INFER_CHUNK
    n_chunks = -(-n // chunk)
    seeds = torch.arange(n_chunks * chunk, dtype=torch.int32, device=dev)
    seeds[n:] = -1
    hops = [[] for _ in fanouts]
    for i in range(n_chunks):
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(key, i))
        us = []

        def draw(l, m, k, gen=gen, us=us):
            us.append(torch.rand((m, k), generator=gen, device=dev))
            return us[-1]
        rows = seeds[i * chunk:(i + 1) * chunk]
        layers, _, _ = ex._sample_impl(rows, fanouts, draw)
        for l in range(len(fanouts)):
            hops[l].append((rows, us[l]))
            rows = layers[l].reshape(-1)
    return hops


def check_sampler(ex, dev):
    """sample_ell against its plain version on the learning graph: at both
    hop shapes with planted edge cases (PAD and out-of-range rows,
    isolated rows, the hub, u just below 1), on CSR and on a small ELL
    slab, and on every launch of one full-graph inference — bit-exact.
    Times the kernel and its plain version over that inference's own
    inputs (its 64 launches of each hop, back to back in a CUDA graph).
    Returns its record: times and bound are means per launch over the
    inference's 128 launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.sampler import (csr_to_sample_ell,
                                             sample_draw_ref, sample_ell,
                                             sample_ell_width)
    from repro_torch.storage.generators import rmat_store

    n = ex.n_vertices
    starts, deg, idx = ex.csr_starts, ex.deg, ex.csr_indices
    isolated = torch.nonzero(deg == 0)[:, 0].to(torch.int32)
    hub = int(torch.argmax(deg))
    slab_gb = n * sample_ell_width(deg.cpu().numpy()) * 4 / 1e9
    print(f"learning graph: {n} vertices, {idx.numel() - 1} edges, max "
          f"degree {int(deg[hub])} (vertex {hub}), {isolated.numel()} "
          f"isolated; its ELL sampling slab would be {slab_gb:.3g} GB")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    one_minus = float(np.nextafter(np.float32(1), np.float32(0)))

    def planted(M, K, n_rows, iso):
        rows = torch.randint(0, n_rows, (M,), generator=gen, device=dev,
                             dtype=torch.int32)
        rows[::50] = -1
        rows[1::50] = n_rows + 7
        rows[2::50] = hub if n_rows == n else 0
        if iso.numel():
            pick = torch.randint(0, iso.numel(), (len(rows[3::50]),),
                                 generator=gen, device=dev)
            rows[3::50] = iso[pick]
        u = torch.rand((M, K), generator=gen, device=dev)
        u.view(-1)[::13] = one_minus
        return rows, u

    def same(rows, u, what):
        got = ops.sample_neighbors(starts, deg, idx, rows, u)
        want = sample_draw_ref(starts, deg, idx, rows, u)
        if got.shape != u.shape or not torch.equal(got, want):
            fail(f"sample_ell: differs from its plain version {what} "
                 f"({int((got != want).sum())} draws)")
        return int((got - want).abs().max())

    # a small ELL slab (the JAX package's layout) from the same generator
    small = rmat_store(scale=10, edge_factor=16, seed=GNN_STORE["seed"])
    ell_np, deg_np = csr_to_sample_ell(*small.adjacency())
    ell = torch.as_tensor(ell_np, device=dev)
    deg_e = torch.as_tensor(deg_np, device=dev)
    iso_e = torch.nonzero(deg_e == 0)[:, 0].to(torch.int32)
    W = ell.shape[1]
    starts_e = torch.arange(ell.shape[0], dtype=torch.int64, device=dev) * W
    err = 0
    for M, K in [(2048, GNN_FANOUTS[0]), (2048 * GNN_FANOUTS[0],
                                          GNN_FANOUTS[1])]:
        err = max(err, same(*planted(M, K, n, isolated),
                            f"at M={M}, K={K} (planted rows)"))
        rows_e, u_e = planted(M, K, ell.shape[0], iso_e)
        if not torch.equal(sample_ell(ell, deg_e, rows_e, u_e),
                           sample_draw_ref(starts_e, deg_e, ell.reshape(-1),
                                           rows_e, u_e)):
            fail(f"sample_ell: differs on the ELL slab at M={M}, K={K}")

    hops = inference_draws(ex, GNN_FANOUTS)
    stats = {"ms": [], "plain_ms": [], "bound_ms": []}
    for l, launches in enumerate(hops):
        for i, (rows, u) in enumerate(launches):
            err = max(err, same(rows, u, f"at hop {l + 1} of chunk {i}"))
        n_l = len(launches)

        def kern(launches=launches):
            for rows, u in launches:
                ops.sample_neighbors(starts, deg, idx, rows, u)

        def plain(launches=launches):
            for rows, u in launches:
                sample_draw_ref(starts, deg, idx, rows, u)
        t = time_graph_ms(kern, iters=5) / n_l
        t_eager = time_ms(kern, iters=3) / n_l
        tp = time_graph_ms(plain, iters=2) / n_l
        b = sum(sample_bound(starts, deg, idx, rows, u)
                for rows, u in launches) / n_l
        for key, val in zip(stats, (t, tp, b)):
            stats[key].append(val)
        M, K = launches[0][1].shape
        pad = sum(int((rows < 0).sum()) for rows, _ in launches) / n_l
        print(f"sample_ell hop {l + 1} (M={M}, K={K}; {pad:.1f} PAD rows "
              f"a launch): bit-exact on planted rows (CSR and ELL slab "
              f"{ell.shape[0]}x{W}) and on all {n_l} launches of one "
              f"inference; device time {t:.5f} ms a launch ({t_eager:.5f} "
              f"ms launched back to back from the host), plain "
              f"{tp:.5f} ms, bound {b:.5f} ms (bytes; {t / b:.2f}x)")
    ops.reset_launches()
    return {"name": "sample_ell", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sampler.cu",
            "replaces": "src/repro/kernels/sampler.py:94", "launches": 0,
            "max_abs_err": float(err),
            "ms": sum(stats["ms"]) / 2, "plain_ms": sum(stats["plain_ms"]) / 2,
            "bound_ms": sum(stats["bound_ms"]) / 2, "bound_by": "bytes",
            "library_ms": None}


def serve_gnn(store, dev):
    """The learning path: B = 64 ``CALL gnn.infer`` requests through
    QueryService, and its correctness checks. Returns the launch counts
    of the served batch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.learning import GraphSampler, SageTrainer
    from repro_torch.serving import QueryService

    tree = reference_tree()
    trainer = SageTrainer(GraphSampler(store, label_prop="label",
                                       device=dev),
                          GNN_HIDDEN, GNN_CLASSES, GNN_FANOUTS, params=tree)
    record = check_sampler(trainer.sampler.device_executor(), dev)
    svc = QueryService(store, device=dev)
    trainer.register_inference(svc.procedures, "sage")
    reqs = [(GNN_TEMPLATE, {"m": "sage"})] * B
    svc.serve(reqs[:1])                  # warm-up: plan, executor tables
    torch.cuda.synchronize()
    svc.procedures.clear()
    ops.reset_launches()
    t0 = time.perf_counter()
    rs, _ = svc.serve(reqs)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(ops.LAUNCHES)
    print("launches on the learning path:", json.dumps(launches))
    routes = {r.engine for r in rs}
    stats = svc.procedures.stats
    print(f"gnn_infer_topk: route {'/'.join(sorted(routes))}, {len(rs)} "
          f"requests, batch {batch_ms:.3f} ms, first request (inference) "
          f"{rs[0].service_us / 1e3:.3f} ms, rest "
          f"{sum(r.service_us for r in rs[1:]) / 1e3:.3f} ms; memo hits "
          f"{stats.hits}, misses {stats.misses}")
    if routes != {"grape"}:
        fail(f"gnn_infer_topk: served on {sorted(routes)}, expected grape")
    for name in GNN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the learning path")

    # served scores are the offline forward pass, bit for bit
    t0 = time.perf_counter()
    offline = trainer.infer_scores(key=0)
    torch.cuda.synchronize()
    print(f"offline infer_scores: {(time.perf_counter() - t0) * 1e3:.3f} ms")
    served = svc.procedures.run(store, "gnn.infer", ("sage",))
    if not np.isfinite(offline).all() or offline.shape != (store.n_vertices,):
        fail("gnn.infer: scores not finite or of the wrong shape")
    if not np.array_equal(served, offline):
        fail("gnn.infer: served scores differ from offline infer_scores")
    for r in rs:
        v = np.asarray(r.result["v"], np.int64)
        if not np.array_equal(np.asarray(r.result["s"], np.float32),
                              offline[v]) or len(v) != 10:
            fail("gnn.infer: a served top-10 differs from offline scores")

    # the card against the CPU path, under one set of uniforms drawn on
    # the card and copied to the host
    cpu_trainer = SageTrainer(GraphSampler(store, label_prop="label",
                                           device="cpu"),
                              GNN_HIDDEN, GNN_CLASSES, GNN_FANOUTS,
                              params=tree)
    ex, cpu_ex = trainer.sampler.device_executor(), \
        cpu_trainer.sampler.device_executor()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    chunk = SageTrainer.INFER_CHUNK
    n_chunks = -(-store.n_vertices // chunk)
    shapes = [(chunk, GNN_FANOUTS[0]), (chunk * GNN_FANOUTS[0],
                                        GNN_FANOUTS[1])]
    u_dev = [[torch.rand(s, generator=gen, device=dev) for s in shapes]
             for _ in range(n_chunks)]
    u_host = [[u.cpu() for u in us] for us in u_dev]
    same_draws = True
    for i in range(n_chunks):
        seeds = torch.arange(i * chunk, (i + 1) * chunk, dtype=torch.int32)
        seeds[seeds >= store.n_vertices] = -1
        a, _, _ = ex._sample_impl(seeds.to(dev), GNN_FANOUTS,
                                  lambda l, m, k, i=i: u_dev[i][l])
        b, _, _ = cpu_ex._sample_impl(seeds, GNN_FANOUTS,
                                      lambda l, m, k, i=i: u_host[i][l])
        same_draws &= all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
    if not same_draws:
        fail("gnn.infer: the card's draws differ from the CPU path's")
    svc.procedures.register_model("shared", lambda st: trainer.infer_scores(
        st, uniforms=lambda i, l, m, k: u_dev[i][l]))
    cpu_svc = QueryService(store, device="cpu")
    cpu_svc.procedures.register_model(
        "shared", lambda st: cpu_trainer.infer_scores(
            st, uniforms=lambda i, l, m, k: u_host[i][l]))
    shared = [(GNN_TEMPLATE, {"m": "shared"})]
    got, _ = svc.serve(shared)
    t0 = time.perf_counter()
    want, _ = cpu_svc.serve(shared)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    s_dev = svc.procedures.run(store, "gnn.infer", ("shared",))
    s_cpu = cpu_svc.procedures.run(store, "gnn.infer", ("shared",))
    err = float(np.abs(s_dev - s_cpu).max())
    print(f"card vs CPU under shared uniforms: draws identical over "
          f"{n_chunks} chunks; max |score diff| {err:.3e} (CPU service "
          f"{cpu_ms:.1f} ms)")
    if not np.allclose(s_dev, s_cpu, rtol=GNN_RTOL, atol=GNN_ATOL):
        fail(f"gnn.infer: card scores beyond rtol {GNN_RTOL}, atol "
             f"{GNN_ATOL} of the CPU path's (max |diff| {err})")
    why = rows_mismatch("gnn_infer_topk", want[0].result, got[0].result)
    if why is not None:
        fail(f"gnn.infer: top-10 differs from the CPU path's: {why}")
    profile_batch(svc, "gnn_infer_topk", reqs)
    return launches, record


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not under {SRC}")
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for lib, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}")

    from repro_torch.storage.generators import snb_store
    from repro_torch.storage.lpg import PropertyGraph
    t0 = time.perf_counter()
    store = snb_store(**FULL)
    print(f"store: {store.n_vertices} vertices, {store.n_edges} edges "
          f"({time.perf_counter() - t0:.2f} s)")
    records = check_kernels(PropertyGraph(store), dev)
    launches, _latency = serve(store, dev)
    del store
    t0 = time.perf_counter()
    gstore = learning_store()
    print(f"learning store: {gstore.n_vertices} vertices, "
          f"{gstore.n_edges} edges ({time.perf_counter() - t0:.2f} s)")
    gnn_launches, record = serve_gnn(gstore, dev)
    records.append(record)
    for name in GNN_KERNELS:
        launches[name] = gnn_launches[name]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
