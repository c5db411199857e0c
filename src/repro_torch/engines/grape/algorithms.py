"""Built-in analytics library (paper's application layer ⑤) over
Pregel / PIE / FLASH. Each algorithm has a pure-numpy oracle at the end of
this module, for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engines.grape.engine import GrapeEngine
from repro_torch.engines.grape.flash import FlashContext
from repro_torch.engines.grape.pie import PIEProgram, run_pie
from repro_torch.engines.grape.pregel import VertexProgram, run_pregel


def _pad_state(arr, n: int, fill, device) -> torch.Tensor:
    """A warm-start vector comes trimmed to the store's vertex range; pad
    it back out to the engine's fragment width (``fill``: scalar, or
    ``"iota"`` for identity labels) so padding rows start from the same
    values a cold init would give them."""
    arr = torch.as_tensor(np.asarray(arr), dtype=torch.float32,
                          device=device)
    if arr.shape[0] >= n:
        return arr[:n]
    if fill == "iota":
        tail = torch.arange(arr.shape[0], n, dtype=torch.float32,
                            device=device)
    else:
        tail = torch.full((n - arr.shape[0],), fill, dtype=torch.float32,
                          device=device)
    return torch.cat([arr, tail])


def _source_init(n: int, source: int, device) -> torch.Tensor:
    """Distances from ``source``: 0 there, +inf elsewhere. A source
    outside the graph raises (the JAX package's scatter drops it and
    answers +inf everywhere)."""
    if not 0 <= source < n:
        raise ValueError(f"source vertex {source} is not in [0, {n})")
    d = torch.full((n,), torch.inf, dtype=torch.float32, device=device)
    d[source] = 0.0
    return d


# ----------------------------------------------------------------- PageRank
def pagerank(engine: GrapeEngine, damping: float = 0.85,
             max_steps: int = 50, tol: float = 1e-6,
             warm_start=None) -> torch.Tensor:
    """``warm_start`` (a previous snapshot's rank vector) restarts the
    contraction from that solution instead of uniform: it converges to the
    same fixpoint TOLERANCE as a cold start — results agree with cold
    start to within ``tol/(1-damping)`` in L1, not bit-exactly (the
    documented incremental contract, DESIGN.md §15)."""
    n = engine.frags.n_vertices
    dev = engine.device

    prog = VertexProgram(
        init=lambda n_: {"rank": torch.full((n_,), 1.0 / n_,
                                            dtype=torch.float32,
                                            device=dev)},
        send=lambda st, deg: st["rank"] / deg.clamp_min(1.0),
        update=lambda st, msgs, step: {
            "rank": (1.0 - damping) / n + damping * msgs},
        combiner="sum",
        residual_key="rank",
        tol=tol,
    )
    init_state = None
    if warm_start is not None:
        init_state = {"rank": _pad_state(warm_start, n, 0.0, dev)}
    return run_pregel(engine, prog, max_steps,
                      cache_key=("pagerank", damping),
                      init_state=init_state)["rank"]


# ---------------------------------------------------------------------- BFS
def bfs(engine: GrapeEngine, source: int, max_steps: int = 64,
        warm_start=None) -> torch.Tensor:
    """``warm_start`` (a previous snapshot's depth vector for the SAME
    source) is a valid upper bound on an append-only graph, so monotone
    min-propagation from it reaches the unique fixpoint BIT-EXACTLY
    (DESIGN.md §15)."""
    n = engine.frags.n_vertices
    dev = engine.device

    prog = VertexProgram(
        init=lambda n_: {"depth": _source_init(n_, source, dev)},
        send=lambda st, deg: st["depth"] + 1.0,
        update=lambda st, msgs, step: {
            "depth": torch.minimum(st["depth"], msgs)},
        combiner="min",
        residual_key="depth",
        tol=0.0,
    )
    init_state = None
    if warm_start is not None:
        d = torch.minimum(_pad_state(warm_start, n, torch.inf, dev),
                          _source_init(n, source, dev))
        init_state = {"depth": d}
    return run_pregel(engine, prog, max_steps,
                      cache_key=("bfs", source),
                      init_state=init_state)["depth"]


# --------------------------------------------------------------------- SSSP
def sssp(engine: GrapeEngine, source: int, max_steps: int = 128,
         warm_start=None) -> torch.Tensor:
    """``warm_start`` (a previous snapshot's distance vector for the SAME
    source): on an append-only graph (edges added, existing weights
    immutable) old distances upper-bound new ones and every relaxation
    candidate is the same left-associated path sum, so the min-plus
    fixpoint is reached bit-exactly (DESIGN.md §15)."""
    dev = engine.device

    prog = VertexProgram(
        init=lambda n_: {"dist": _source_init(n_, source, dev)},
        send=lambda st, deg: st["dist"],          # + w applied by engine
        update=lambda st, msgs, step: {
            "dist": torch.minimum(st["dist"], msgs)},
        combiner="min",
        use_weights=True,
        residual_key="dist",
        tol=0.0,
    )
    init_state = None
    if warm_start is not None:
        n = engine.frags.n_vertices
        d = torch.minimum(_pad_state(warm_start, n, torch.inf, dev),
                          _source_init(n, source, dev))
        init_state = {"dist": d}
    return run_pregel(engine, prog, max_steps,
                      cache_key=("sssp", source),
                      init_state=init_state)["dist"]


# ---------------------------------------------------------------------- WCC
def wcc(engine: GrapeEngine, max_steps: int = 64,
        warm_start=None) -> torch.Tensor:
    """Weakly-connected components by min-label propagation (assumes the
    graph was symmetrized by the caller for true WCC). ``warm_start`` (a
    previous snapshot's labels) upper-bounds the new labels on an
    append-only graph — components only merge — so the min-label fixpoint
    is reached bit-exactly (DESIGN.md §15)."""
    dev = engine.device
    prog = VertexProgram(
        init=lambda n_: {"lab": torch.arange(n_, dtype=torch.float32,
                                             device=dev)},
        send=lambda st, deg: st["lab"],
        update=lambda st, msgs, step: {
            "lab": torch.minimum(st["lab"], msgs)},
        combiner="min",
        residual_key="lab",
        tol=0.0,
    )
    init_state = None
    if warm_start is not None:
        init_state = {"lab": _pad_state(warm_start,
                                        engine.frags.n_vertices, "iota",
                                        dev)}
    return run_pregel(engine, prog, max_steps, cache_key=("wcc",),
                      init_state=init_state)["lab"].to(torch.int32)


# ----------------------------------------------------- equity shares (§8)
def equity_shares(engine: GrapeEngine, holder_mask: np.ndarray,
                  max_steps: int = 30, tol: float = 1e-7) -> torch.Tensor:
    """The paper's Equity Analysis: propagate ownership shares along weighted
    invest edges until fixpoint; returns effective share of each *holder*
    vertex in every company it (transitively) owns, aggregated per vertex.

    state: for each vertex, total share attributable to ultimate holders is
    obtained by propagating holder-rooted mass along edge weights."""
    hm = torch.as_tensor(np.asarray(holder_mask), dtype=torch.float32,
                         device=engine.device)

    prog = VertexProgram(
        init=lambda n_: {"share": hm},
        send=lambda st, deg: st["share"],
        update=lambda st, msgs, step: {"share": hm + msgs},
        combiner="sum",
        use_weights=True,
        residual_key="share",
        tol=tol,
    )
    return run_pregel(engine, prog, max_steps)["share"]


# ------------------------------------------------------------- PIE PageRank
def pagerank_pie(engine: GrapeEngine, damping: float = 0.85,
                 rounds: int = 30) -> torch.Tensor:
    """PageRank in the PIE model: PEval runs local iterations on the
    fragment-internal edges, IncEval folds in cross-fragment mass."""
    n = engine.frags.n_vertices
    deg = engine.out_degree.float().clamp_min(1.0)

    def peval(eng):
        rank = torch.full((n,), 1.0 / n, dtype=torch.float32,
                          device=eng.device)
        return {"rank": rank}, rank / deg

    def inc(state, msgs, r):
        rank = (1.0 - damping) / n + damping * msgs
        return {"rank": rank}, rank / deg

    prog = PIEProgram(peval=peval, inc=inc,
                      assemble=lambda st: st,
                      combiner="sum", residual_key="rank", tol=1e-6)
    return run_pie(engine, prog, rounds)["rank"]


# ------------------------------------------------------------- FLASH: k-core
def kcore(engine: GrapeEngine, k: int, max_rounds: int = 64) -> torch.Tensor:
    """FLASH-style k-core: iteratively peel vertices with degree < k.
    Returns a boolean mask of the k-core."""
    ctx = FlashContext(engine)
    alive = ctx.all_vertices()
    ones = torch.ones_like(ctx.deg)
    for _ in range(max_rounds):
        # degree counting restricted to alive endpoints: push 1 from alive
        # vertices, mask at receivers
        inbox = ctx.push(alive, ones)
        cur_deg = torch.where(alive, inbox, 0.0)
        new_alive = alive & (cur_deg >= k)
        if bool(torch.equal(new_alive, alive)):
            break
        alive = new_alive
    return alive


# ------------------------------------- FLASH: CC with pointer jumping
def cc_pointer_jumping(engine: GrapeEngine,
                       max_rounds: int = 32) -> torch.Tensor:
    """Connected components via label propagation + pointer jumping — the
    FLASH-only pattern (pointer jumping reads labels at *non-neighbor*
    vertices)."""
    ctx = FlashContext(engine)
    lab = torch.arange(ctx.n, dtype=torch.float32, device=engine.device)
    alive = ctx.all_vertices()
    for _ in range(max_rounds):
        inbox = ctx.push(alive, lab, combiner="min")
        new_lab = torch.minimum(lab, inbox)
        # pointer jumping: lab[v] = lab[lab[v]] (non-neighbor gather)
        jumped = ctx.pull_at(new_lab, new_lab.long())
        new_lab = torch.minimum(new_lab, jumped)
        if bool(torch.equal(new_lab, lab)):
            break
        lab = new_lab
    return lab.to(torch.int32)


# ------------------------------------------------ FLASH: triangle counting
def triangle_count(engine: GrapeEngine) -> int:
    """Per-edge common-neighbor intersection via N-bit membership blocks —
    the FLASH non-neighbor pattern (each edge probes arbitrary vertex rows).

    Counts directed triangles u→v→w→…: Σ_(u,v)∈E |N(u) ∩ N(v)| over the
    out-adjacency. Dense bitset rows on the host (N ≤ ~16k)."""
    fa = engine.frags
    n = fa.n_vertices
    indices = fa.indices.cpu().numpy()
    e_src = fa.e_src.cpu().numpy()
    mask = fa.e_mask.cpu().numpy()
    F = indices.shape[0]
    adj = np.zeros((n, n), bool)
    for f in range(F):
        src_global = e_src[f] + f * fa.v_per_frag
        valid = mask[f]
        adj[src_global[valid], indices[f][valid]] = True
    # per-edge intersection: Σ_e |N(u)∩N(v)|
    total = 0
    for f in range(F):
        valid = mask[f]
        u = (e_src[f] + f * fa.v_per_frag)[valid]
        v = indices[f][valid]
        total += int(np.sum(adj[u] & adj[v]))
    return total


# ------------------------------------------------- LPA (community, mode)
def lpa_communities(engine: GrapeEngine, max_rounds: int = 20,
                    n_buckets: int = 64, seed: int = 0) -> torch.Tensor:
    """Label propagation with mode aggregation, approximated by hashed
    one-hot bucket voting (dense [N, B] message matrix — the compact-buffer
    exchange carries B floats per vertex)."""
    ctx = FlashContext(engine)
    n = ctx.n
    dev = engine.device
    rng = np.random.default_rng(seed)
    bucket_of = torch.as_tensor(rng.integers(0, n_buckets, n), device=dev)
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    everyone = ctx.all_vertices()
    for _ in range(max_rounds):
        votes, mins = [], []
        for b in range(n_buckets):
            in_bucket = bucket_of[lab.long()] == b
            votes.append(ctx.push(everyone, in_bucket.float()))
            mins.append(ctx.push(everyone,
                                 torch.where(in_bucket, lab.float(),
                                             torch.inf),
                                 combiner="min"))
        votes = torch.stack(votes, dim=1)                    # [N, B]
        mins = torch.stack(mins, dim=1)                      # [N, B]
        best_bucket = torch.argmax(votes, dim=1)   # first max, as jnp's
        cand = torch.gather(mins, 1, best_bucket[:, None])[:, 0]
        has_in = votes.sum(dim=1) > 0
        new_lab = torch.where(has_in & torch.isfinite(cand),
                              cand.to(torch.int32), lab)
        if bool(torch.equal(new_lab, lab)):
            break
        lab = new_lab
    return lab


# ---------------------------------------------------------- degree metrics
def degree_centrality(engine: GrapeEngine) -> torch.Tensor:
    """In-degree centrality via one compact-buffer superstep."""
    ctx = FlashContext(engine)
    inbox = ctx.push(ctx.all_vertices(),
                     torch.ones(ctx.n, dtype=torch.float32,
                                device=engine.device))
    # divide by a tensor on the engine's device: PyTorch's CUDA division
    # by a Python scalar multiplies by its reciprocal, which rounds
    # differently from the CPU's (and the JAX package's) true division
    denom = torch.tensor(float(max(ctx.n - 1, 1)), device=engine.device)
    return inbox / denom


# ----------------------------------------------------- numpy oracles (tests)
def triangle_count_numpy(indptr, indices):
    n = len(indptr) - 1
    adj = np.zeros((n, n), bool)
    src = np.repeat(np.arange(n), np.diff(indptr))
    adj[src, indices] = True
    return int(sum(np.sum(adj[u] & adj[v]) for u, v in zip(src, indices)))


def pagerank_numpy(indptr, indices, damping=0.85, iters=50):
    n = len(indptr) - 1
    deg = np.maximum(np.diff(indptr), 1)
    src = np.repeat(np.arange(n), np.diff(indptr))
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.zeros(n)
        np.add.at(contrib, indices, rank[src] / deg[src])
        new = (1 - damping) / n + damping * contrib
        if np.abs(new - rank).sum() < 1e-6:
            rank = new
            break
        rank = new
    return rank


def bfs_numpy(indptr, indices, source):
    n = len(indptr) - 1
    depth = np.full(n, np.inf)
    depth[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        nxt = []
        for u in frontier:
            for w in indices[indptr[u]:indptr[u + 1]]:
                if depth[w] == np.inf:
                    depth[w] = d + 1
                    nxt.append(int(w))
        frontier = nxt
        d += 1
    return depth


def sssp_numpy(indptr, indices, weights, source):
    """Bellman-Ford relaxation to a fixpoint."""
    n = len(indptr) - 1
    dist = np.full(n, np.inf)
    dist[source] = 0.0
    src = np.repeat(np.arange(n), np.diff(indptr))
    for _ in range(n):
        best = np.full(n, np.inf)
        np.minimum.at(best, indices, dist[src] + weights)
        new = np.minimum(dist, best)
        if np.allclose(new, dist, equal_nan=True):
            break
        dist = new
    return dist
