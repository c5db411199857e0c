"""The port's GRAPE engine (``repro_torch.engines.grape``, on the CPU)
against the JAX package's (``repro.engines.grape`` with
``use_kernels=False``, its ``.at[].add`` form) on the same numpy-seeded
graphs, at F ∈ {1, 2, 3} and in both of the port's forms: the sorted
segment sum (``use_kernels=True``; the kernel's plain version on the CPU)
and the edge-order ``index_add_`` (``use_kernels=False``).

bfs, sssp, wcc, kcore, cc_pointer_jumping, degree_centrality and
triangle_count are min/max propagations or integer counts, so every
order gives the same float32 result: bit-exact. pagerank, pagerank_pie,
equity_shares and lpa_communities sum floats in another order: within
rtol 1e-5, atol 1e-8 (the reference's own fragment-invariance
tolerance, tests/test_grape.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engines.grape import GrapeEngine as JGrape
from repro.engines.grape import algorithms as jalg
from repro.engines.procedures import ProcedureRegistry as JRegistry
from repro.storage.csr import CSRStore as JCSR
from repro.storage.generators import rmat_store as j_rmat
from repro.storage.generators import snb_store as j_snb
from repro_torch.engines.grape import GrapeEngine as TGrape
from repro_torch.engines.grape import algorithms as talg
from repro_torch.engines.procedures import ProcedureRegistry as TRegistry
from repro_torch.kernels import ops
from repro_torch.storage.csr import CSRStore as TCSR
from repro_torch.storage.generators import rmat_store as t_rmat
from repro_torch.storage.generators import snb_store as t_snb

RTOL, ATOL = 1e-5, 1e-8
FRAGS = [1, 2, 3]
FORMS = [True, False]          # the port's use_kernels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sym(pkg_csr, store):
    """The same graph with every edge also reversed (true WCC / CC)."""
    indptr, indices = store.adjacency()
    src = np.repeat(np.arange(store.n_vertices), np.diff(indptr))
    return pkg_csr(store.n_vertices, np.concatenate([src, indices]),
                   np.concatenate([indices, src]))


def _graphs():
    """name → (reference store, port store), built from the same seeds."""
    snb = dict(n_persons=240, n_items=120, n_posts=40, seed=5)
    j9, t9 = j_rmat(scale=9, edge_factor=6, seed=2), \
        t_rmat(scale=9, edge_factor=6, seed=2)
    return {
        "snb": (j_snb(**snb), t_snb(**snb)),
        "rmat8": (j_rmat(scale=8, edge_factor=8, seed=3),
                  t_rmat(scale=8, edge_factor=8, seed=3)),
        "rmat9_sym": (_sym(JCSR, j9), _sym(TCSR, t9)),
        "rmat10": (j_rmat(scale=10, edge_factor=4, seed=11),
                   t_rmat(scale=10, edge_factor=4, seed=11)),
    }


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


def _holders(n):
    return (np.arange(n) % 7 == 0).astype(np.float32)


# name → (graph, call on an algorithms module and an engine, exact)
ALGOS = {
    "bfs": ("snb", lambda a, e: a.bfs(e, source=3), True),
    "sssp": ("rmat10", lambda a, e: a.sssp(e, source=1), True),
    "sssp_rmat8": ("rmat8", lambda a, e: a.sssp(e, source=0), True),
    "wcc": ("rmat9_sym", lambda a, e: a.wcc(e), True),
    "kcore": ("rmat8", lambda a, e: a.kcore(e, k=4), True),
    "cc_pointer_jumping": ("rmat9_sym",
                           lambda a, e: a.cc_pointer_jumping(e), True),
    "degree_centrality": ("snb", lambda a, e: a.degree_centrality(e), True),
    "triangle_count": ("rmat8", lambda a, e: a.triangle_count(e), True),
    "pagerank": ("snb", lambda a, e: a.pagerank(e), False),
    "pagerank_rmat10": ("rmat10", lambda a, e: a.pagerank(e, damping=0.9),
                        False),
    "pagerank_pie": ("rmat8", lambda a, e: a.pagerank_pie(e, rounds=25),
                     False),
    "equity_shares": ("rmat8", lambda a, e: a.equity_shares(
        e, _holders(e.frags.n_vertices), max_steps=20), False),
    "lpa_communities": ("rmat8", lambda a, e: a.lpa_communities(
        e, max_rounds=5, n_buckets=8), False),
}

_REF = {}


def reference(graphs, algo, n_frags):
    """The JAX package's answer, computed once per (algorithm, F)."""
    key = (algo, n_frags)
    if key not in _REF:
        gname, call, _ = ALGOS[algo]
        eng = JGrape(graphs[gname][0], n_frags=n_frags)
        _REF[key] = np.asarray(call(jalg, eng))
    return _REF[key]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestAlgorithmsMatchReference:
    @pytest.mark.parametrize("use_kernels", FORMS)
    @pytest.mark.parametrize("n_frags", FRAGS)
    @pytest.mark.parametrize("algo", sorted(ALGOS))
    def test_algorithm(self, graphs, algo, n_frags, use_kernels):
        gname, call, exact = ALGOS[algo]
        want = reference(graphs, algo, n_frags)
        eng = TGrape(graphs[gname][1], n_frags=n_frags,
                     use_kernels=use_kernels, device="cpu")
        got = host(call(talg, eng))
        assert got.dtype == want.dtype and got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class TestEngine:
    @pytest.mark.parametrize("n_frags", FRAGS)
    @pytest.mark.parametrize("combiner,use_weights", [
        ("sum", False), ("sum", True), ("min", False), ("min", True),
        ("max", False)])
    def test_superstep_matches_reference(self, graphs, n_frags, combiner,
                                         use_weights):
        """One superstep on integer-valued vertex values: every summation
        order is exact, so both forms are bit-identical to the reference
        (weights of 0..3, so weighted sums are integers too)."""
        js, ts = graphs["rmat8"]
        rng = np.random.default_rng(n_frags)
        w = rng.integers(0, 4, js.n_edges).astype(np.float32)
        indptr, indices = js.adjacency()
        src = np.repeat(np.arange(js.n_vertices), np.diff(indptr))
        jeng = JGrape(JCSR(js.n_vertices, src, indices,
                           edge_props={"weight": w}), n_frags=n_frags)
        vals = rng.integers(0, 50, js.n_vertices).astype(np.float32)
        want = np.asarray(jeng.superstep(jeng.owned_view(jnp.asarray(vals)),
                                         combiner, use_weights))
        for uk in FORMS:
            teng = TGrape(TCSR(ts.n_vertices, src, indices,
                               edge_props={"weight": w}),
                          n_frags=n_frags, use_kernels=uk, device="cpu")
            got = teng.superstep(teng.owned_view(torch.as_tensor(vals)),
                                 combiner, use_weights)
            np.testing.assert_array_equal(got.numpy(), want)

    def test_sum_goes_through_segment_sum(self, graphs, monkeypatch):
        """use_kernels=True combines sums with ops.segment_sum on
        destination-sorted segments; use_kernels=False never calls it."""
        calls = []
        orig = ops.segment_sum

        def spy(vals, segs, n_out):
            calls.append(segs)
            return orig(vals, segs, n_out)
        monkeypatch.setattr(ops, "segment_sum", spy)
        ts = graphs["snb"][1]
        eng = TGrape(ts, n_frags=2, device="cpu")
        talg.pagerank(eng, max_steps=3)
        assert len(calls) == 3 * 2
        for segs in calls:
            s = segs.numpy()
            assert np.all(np.diff(s) >= 0) and s.dtype == np.int32
        calls.clear()
        talg.pagerank(TGrape(ts, n_frags=2, use_kernels=False,
                             device="cpu"), max_steps=3)
        assert calls == []

    def test_mesh_waits_for_multi_gpu(self, graphs):
        with pytest.raises(NotImplementedError, match="A7"):
            TGrape(graphs["snb"][1], mesh=object(), device="cpu")

    def test_default_device_is_cuda(self, graphs):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            TGrape(graphs["snb"][1])


def _hub_graph(pkg_csr):
    """Vertex 0 is the hub (many in-edges, a self-loop) and n = 37 does
    not divide by F = 2 or 3, so the last fragment is padded; vertex 36
    has no edges at all."""
    rng = np.random.default_rng(0)
    n = 37
    src = np.concatenate([np.arange(1, 30), rng.integers(0, 36, 60), [0]])
    dst = np.concatenate([np.zeros(29, np.int64), rng.integers(0, 36, 60),
                          [0]])
    w = rng.random(len(src)).astype(np.float32)
    return pkg_csr(n, src, dst, edge_props={"weight": w})


class TestVertexZeroAndPadding:
    @pytest.mark.parametrize("use_kernels", FORMS)
    @pytest.mark.parametrize("n_frags", [2, 3])
    def test_hub_into_vertex_zero(self, n_frags, use_kernels):
        js, ts = _hub_graph(JCSR), _hub_graph(TCSR)
        jeng = JGrape(js, n_frags=n_frags)
        teng = TGrape(ts, n_frags=n_frags, use_kernels=use_kernels,
                      device="cpu")
        assert teng.frags.v_per_frag * n_frags > js.n_vertices   # padded
        for fn, exact in [(lambda a, e: a.degree_centrality(e), True),
                          (lambda a, e: a.bfs(e, source=5), True),
                          (lambda a, e: a.sssp(e, source=5), True),
                          (lambda a, e: a.pagerank(e), False)]:
            want = np.asarray(fn(jalg, jeng))
            got = host(fn(talg, teng))
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # 29 + the self-loop + the random edges that land on 0
        deg = host(talg.degree_centrality(teng)) * (js.n_vertices - 1)
        assert deg[0] >= 30 and deg[36] == 0


class VersionedStore:
    """A store stub with a versioned ``snapshot_token`` — the shape of a
    GART MVCC snapshot the registry warm-starts from (append-only edges
    between versions)."""

    def __init__(self, store, uid, version):
        self._store = store
        self.snapshot_token = ("stub", uid, version)

    def __getattr__(self, name):
        return getattr(self._store, name)


def _versions(pkg_csr, base, extra_edges):
    """Version 1 = ``base``; version 2 = base plus ``extra_edges``."""
    indptr, indices = base.adjacency()
    src = np.repeat(np.arange(base.n_vertices), np.diff(indptr))
    w = base.edge_prop("weight")
    s2 = np.concatenate([src, extra_edges[0]])
    d2 = np.concatenate([indices, extra_edges[1]])
    w2 = np.concatenate([w, np.full(len(extra_edges[0]), 0.5, np.float32)])
    v2 = pkg_csr(base.n_vertices, s2, d2, edge_props={"weight": w2})
    return VersionedStore(base, 7, 1), VersionedStore(v2, 7, 2)


class TestWarmStart:
    @pytest.mark.parametrize("algo,args", [("bfs", (2,)), ("sssp", (2,)),
                                           ("wcc", ()), ("pagerank", (0.85,))])
    def test_warm_start_contract(self, graphs, algo, args):
        """Version 2 warm-starts from version 1's fixpoint in both
        packages: bfs/sssp/wcc reach the cold fixpoint bit-exactly;
        pagerank lands within tol/(1-damping) in L1 of the cold answer."""
        rng = np.random.default_rng(4)
        extra = (rng.integers(0, 256, 40), rng.integers(0, 256, 40))
        jv1, jv2 = _versions(JCSR, graphs["rmat8"][0], extra)
        tv1, tv2 = _versions(TCSR, graphs["rmat8"][1], extra)
        jreg, treg = JRegistry(), TRegistry(device="cpu")
        first, jfirst = treg.run(tv1, algo, args), jreg.run(jv1, algo, args)
        np.testing.assert_allclose(first, jfirst, rtol=RTOL, atol=ATOL)
        warm = treg.run(tv2, algo, args)
        jwarm = jreg.run(jv2, algo, args)
        assert treg.stats.warm_starts == 1 and jreg.stats.warm_starts == 1
        cold = TRegistry(device="cpu").run(tv2._store, algo, args)
        if algo == "pagerank":
            bound = 1e-6 / (1 - 0.85)
            assert np.abs(warm - cold).sum() <= bound
            assert np.abs(warm - jwarm).sum() <= 2 * bound
        else:
            np.testing.assert_array_equal(warm, cold)
            np.testing.assert_array_equal(warm, jwarm)
