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
6. prints one ``kernels`` JSON line, the device line, and last the
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
        if count <= 0 and name not in NOT_ON_MAIN_PATH:
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
        svc.procedures.clear()
        reqs = [(q, params(b)) for b in range(B)]
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
              + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                          for e in top))


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
