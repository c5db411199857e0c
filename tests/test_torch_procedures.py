"""The port's procedure bridge (``repro_torch.engines.procedures``) and
its ``grape`` route against the JAX package's: the registry's memo per
snapshot token, its LRU bound, warm-start lineage and model
registrations, and hybrid ``CALL algo.*`` requests (Cypher and Gremlin)
served by ``repro_torch.serving.QueryService(device="cpu")`` beside
``repro.serving.QueryService`` on the same requests — the same routes and
the same rows, ranks within rtol 1e-4, atol 1e-7 (the reference's
pagerank tolerance, tests/test_grape.py)."""

import gc

import numpy as np
import pytest
import torch

from repro.serving import QueryService as JService
from repro.storage.generators import snb_store as j_snb
from repro_torch.core.ir.dag import Const, Param, ProcedureCall
from repro_torch.core.ir.parser import parse_cypher, parse_gremlin
from repro_torch.engines.gaia import GaiaEngine
from repro_torch.engines.grape.algorithms import pagerank_numpy
from repro_torch.engines.procedures import (SPECS, ProcedureRegistry,
                                            _StorePin, normalize_proc_name,
                                            snapshot_token)
from repro_torch.serving import QueryService, plan_key
from repro_torch.storage.csr import CSRStore
from repro_torch.storage.generators import E_KNOWS, snb_store
from repro_torch.storage.lpg import PropertyGraph

RTOL, ATOL = 1e-4, 1e-7
SNB = dict(n_persons=600, n_items=300, n_posts=80, seed=7)

HYBRID = ("CALL algo.pagerank($d) YIELD v, rank "
          "MATCH (v:Person) WHERE rank > $t "
          "RETURN v AS v, rank AS r ORDER BY r DESC LIMIT 10")
HYBRID_GREMLIN = ("g.call('algo.pagerank', $d).hasLabel('Person')"
                  ".where('rank > $t').order_by('rank', 'desc')"
                  ".limit(10).values('rank')")
DEGREE = ("CALL algo.degree_centrality() YIELD v, centrality "
          "MATCH (v:Person) WHERE centrality > $t "
          "RETURN v AS v, centrality AS c ORDER BY c DESC LIMIT 10")
BFS = ("CALL algo.bfs($s) YIELD v, depth MATCH (v:Person) "
       "WHERE depth < $k WITH COUNT(v) AS n RETURN n AS n")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return snb_store(**SNB)


@pytest.fixture(scope="module")
def jstore():
    return j_snb(**SNB)


class Versioned:
    """A store stub with a versioned ``snapshot_token`` (the shape of a
    GART MVCC snapshot: (kind, store uid, version))."""

    def __init__(self, store, uid, version):
        self._store = store
        self.snapshot_token = ("stub", uid, version)

    def __getattr__(self, name):
        return getattr(self._store, name)


def with_knows(store, src, dst):
    """``store`` plus KNOWS edges src → dst (a later, append-only
    version)."""
    indptr, indices = store.adjacency()
    s0 = np.repeat(np.arange(store.n_vertices), np.diff(indptr))
    return CSRStore(store.n_vertices, np.concatenate([s0, src]),
                    np.concatenate([indices, dst]),
                    vertex_labels=store.vertex_labels(),
                    edge_labels=np.concatenate(
                        [store.edge_labels(),
                         np.full(len(src), E_KNOWS, np.int32)]),
                    vertex_props=store.subgraph_props())


def _separated(x, i):
    """True when x[i] differs from its neighbours by more than the
    tolerance, so the row at i is pinned by its rank."""
    tol = ATOL + RTOL * abs(x[i])
    return all(abs(x[i] - x[j]) > tol for j in (i - 1, i + 1)
               if 0 <= j < len(x))


def assert_rows_match(want, got):
    """Same columns and row count; float columns within the rank
    tolerance; integer columns exact wherever the float column pins the
    row (exact everywhere when there is no float column)."""
    assert set(want) == set(got)
    floats = [k for k in want if np.asarray(want[k]).dtype.kind == "f"]
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        elif not floats:
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            key = np.asarray(want[floats[0]], np.float64)
            pinned = [i for i in range(len(a)) if _separated(key, i)]
            np.testing.assert_array_equal(b[pinned], a[pinned], err_msg=k)


class TestParser:
    def test_cypher_call_round_trip(self):
        call = parse_cypher(HYBRID).ops[0]
        assert isinstance(call, ProcedureCall)
        assert (call.proc, call.args, call.yields) == \
            ("pagerank", (Param("d"),), ("v", "rank"))

    def test_literal_args_and_default_yield(self):
        call = parse_cypher("CALL algo.sssp(3) RETURN dist AS dist").ops[0]
        assert call.args == (Const(3),) and call.yields == ("v", "dist")

    def test_gremlin_call_round_trip(self):
        call = parse_gremlin(HYBRID_GREMLIN).ops[0]
        assert call.proc == "pagerank" and call.yields == ("v0", "rank")


class TestRegistry:
    def test_canonical_args_fill_defaults(self):
        spec = SPECS["pagerank"]
        assert spec.canonical_args(()) == (0.85,)
        assert spec.canonical_args((), {"damping": 0.7}) == (0.7,)
        with pytest.raises(TypeError):
            spec.canonical_args((0.9, 1))

    def test_normalize(self):
        assert normalize_proc_name("algo.bfs") == "bfs"
        assert normalize_proc_name("gnn.infer") == "gnn.infer"
        with pytest.raises(KeyError):
            normalize_proc_name("algo.unknown")

    def test_memo_hits_and_misses(self, store):
        reg = ProcedureRegistry(device="cpu")
        a = reg.run(store, "pagerank", (0.85,))
        b = reg.run(store, "pagerank", (0.85,))
        c = reg.run(store, "pagerank", (0.9,))
        assert a is b and not np.allclose(a, c)
        assert (reg.stats.hits, reg.stats.misses) == (1, 2)
        assert isinstance(a, np.ndarray) and len(a) == store.n_vertices

    def test_lru_bounds_snapshots(self, store):
        """Evicting a token drops its engine and its results together."""
        reg = ProcedureRegistry(max_snapshots=2, device="cpu")
        snaps = [Versioned(with_knows(store, [i], [i + 1]), 3, i)
                 for i in range(3)]
        for s in snaps:
            reg.run(s, "degree_centrality")
        assert len(reg._engines) == 2 and len(reg._results) == 2
        reg.run(snaps[0], "degree_centrality")   # recomputed after eviction
        assert (reg.stats.misses, reg.stats.hits) == (4, 0)

    def test_result_matches_numpy_oracle(self, store):
        got = ProcedureRegistry(device="cpu").run(store, "pagerank", (0.85,))
        want = pagerank_numpy(*store.adjacency(), damping=0.85)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_engine_on_the_registry_device(self, store):
        reg = ProcedureRegistry(device="cpu")
        reg.run(store, "degree_centrality")
        (eng,) = reg._engines.values()
        assert eng.device.type == "cpu" and eng.use_kernels

    def test_registry_default_device_is_cuda(self, store):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            ProcedureRegistry().run(store, "degree_centrality")


class TestTempProps:
    def test_call_installs_temp_vprop(self, store):
        pg = PropertyGraph(store)
        eng = GaiaEngine(pg, device="cpu")
        eng.execute("CALL algo.pagerank(0.85) YIELD v, rank "
                    "RETURN rank AS r LIMIT 1")
        assert len(pg.vprop("rank")) == store.n_vertices
        out = eng.execute("MATCH (x:Person) WHERE x.rank > 0 "
                          "RETURN x.rank AS r")
        assert len(out["r"]) > 0
        pg.drop_temp_vprop("rank")
        with pytest.raises(KeyError):
            pg.vprop("rank")


def hybrid_stream():
    """Cypher and Gremlin hybrids with rebound parameters, plus a point
    lookup and a traversal over CALL output."""
    reqs = []
    for b in range(4):
        reqs += [
            (HYBRID, {"d": 0.85, "t": 0.0002 * b}),
            (HYBRID_GREMLIN, {"d": 0.85, "t": 0.0002 * b}, "gremlin"),
            (DEGREE, {"t": 0.001 * b}),
            (BFS, {"s": 1 + 7 * b, "k": 2 + b}),
            ("MATCH (p:Person {credits: $c})-[:BUY]->(i:Item) "
             "WITH p, COUNT(i) AS cnt RETURN cnt AS cnt", {"c": 3 + b}),
        ]
    reqs += [
        (HYBRID, {"d": 0.9, "t": 0.0}),
        ("CALL algo.pagerank(0.85) YIELD v, rank "
         "MATCH (v:Person)-[:KNOWS]->(f:Person) WHERE rank > 0.001 "
         "WITH f, COUNT(v) AS fans RETURN fans AS fans "
         "ORDER BY fans DESC LIMIT 5", {}),
        ("CALL algo.sssp($s) YIELD v, dist WHERE dist < 4 "
         "WITH COUNT(*) AS n RETURN n AS n", {"s": 2}),
        ("CALL algo.wcc() YIELD v, comp MATCH (v:Person) "
         "RETURN v AS v, comp AS c ORDER BY c DESC LIMIT 7", {}),
    ]
    return reqs


class TestServedLikeReference:
    @pytest.mark.parametrize("n_frags", [1, 2])
    def test_stream_routes_and_rows(self, store, jstore, n_frags):
        reqs = hybrid_stream()
        jr, jstats = JService(jstore).serve(reqs)
        reg = ProcedureRegistry(n_frags=n_frags, device="cpu")
        tr, tstats = QueryService(store, procedures=reg,
                                  device="cpu").serve(reqs)
        assert jstats.route_counts == tstats.route_counts
        assert tstats.route_counts["grape"] == 20
        for a, b in zip(jr, tr):
            assert a.engine == b.engine
            assert_rows_match(a.result, b.result)

    def test_chip_templates_batched(self, store, jstore):
        """The three grape templates of the GPU smoke run, eight requests
        each: rows as the reference serves them."""
        reqs = ([(HYBRID, {"d": 0.85, "t": 1e-4 * b}) for b in range(8)]
                + [(DEGREE, {"t": 0.0005 * b}) for b in range(8)]
                + [(BFS, {"s": [0, 5, 17, 301][b % 4], "k": 1 + b})
                   for b in range(8)])
        jr, _ = JService(jstore).serve(reqs)
        tr, stats = QueryService(store, device="cpu").serve(reqs)
        assert stats.route_counts == {"grape": 24}
        for a, b in zip(jr, tr):
            assert_rows_match(a.result, b.result)


class TestHybridExecution:
    def test_cypher_end_to_end(self, store):
        resps, stats = QueryService(store, device="cpu").serve(
            [(HYBRID, {"d": 0.85, "t": 0.0005})])
        assert resps[0].engine == "grape"
        assert stats.route_counts == {"grape": 1}
        r = resps[0].result["r"]
        assert len(r) <= 10 and np.all(np.diff(r) <= 0) and np.all(r > 5e-4)
        assert np.all(store.vertex_labels()[resps[0].result["v"]] == 0)

    def test_gremlin_matches_cypher(self, store):
        svc = QueryService(store, device="cpu")
        params = {"d": 0.85, "t": 0.0005}
        rc, _ = svc.serve([(HYBRID, params)])
        rg, _ = svc.serve([(HYBRID_GREMLIN, params, "gremlin")])
        np.testing.assert_allclose(rg[0].result["rank"], rc[0].result["r"],
                                   rtol=1e-6)

    def test_plan_cache_hit_on_rebound_param(self, store):
        svc = QueryService(store, device="cpu")
        svc.serve([(HYBRID, {"d": 0.85, "t": 0.001})])
        misses0 = svc.cache.stats.misses
        resps, _ = svc.serve([(HYBRID, {"d": 0.9, "t": 0.001})])
        assert resps[0].cached and svc.cache.stats.misses == misses0
        assert svc.procedures.stats.misses == 2

    def test_literal_hyperparams_key_the_cache(self, store):
        a = plan_key("CALL algo.pagerank(0.85) YIELD v, rank RETURN rank AS r")
        b = plan_key("CALL algo.pagerank(0.9) YIELD v, rank RETURN rank AS r")
        assert a != b

    def test_fixpoint_memo_reused_across_requests(self, store):
        svc = QueryService(store, device="cpu")
        svc.serve([(HYBRID, {"d": 0.85, "t": 0.001})] * 4)
        assert (svc.procedures.stats.misses, svc.procedures.stats.hits) \
            == (1, 3)

    def test_shared_registry(self, store):
        reg = ProcedureRegistry(device="cpu")
        for _ in range(2):
            QueryService(store, procedures=reg, device="cpu").serve(
                [(DEGREE, {"t": 0.0})])
        assert (reg.stats.misses, reg.stats.hits) == (1, 1)

    def test_unbound_call_param_rejected(self, store):
        svc = QueryService(store, device="cpu")
        svc.submit(HYBRID, {"t": 0.001})          # $d missing
        with pytest.raises(KeyError):
            svc.flush()


class TestSnapshotPinning:
    def test_tokens(self, store):
        assert snapshot_token(Versioned(store, 1, 4)) == ("stub", 1, 4)
        assert snapshot_token(store) == ("obj", id(store))

    def test_pinned_hybrid_query(self, store):
        """A request pinned at version v sees analytics computed at v, and
        a new stub object at v reuses the memo."""
        reg = ProcedureRegistry(device="cpu")
        q = ("CALL algo.degree_centrality() YIELD v, centrality "
             "MATCH (v:Person) RETURN centrality AS c "
             "ORDER BY c DESC LIMIT 5")
        v1 = Versioned(store, 9, 1)
        r1, _ = QueryService(v1, procedures=reg, device="cpu").serve([(q, {})])
        hub = int(np.argmax(np.diff(store.adjacency()[0])))
        v2 = Versioned(with_knows(store, np.full(200, hub % 10),
                                  np.arange(200) % 50), 9, 2)
        r2, _ = QueryService(v2, procedures=reg, device="cpu").serve([(q, {})])
        assert not np.allclose(r1[0].result["c"], r2[0].result["c"])
        assert reg.stats.misses == 2
        r3, _ = QueryService(Versioned(store, 9, 1), procedures=reg,
                             device="cpu").serve([(q, {})])
        np.testing.assert_array_equal(r3[0].result["c"], r1[0].result["c"])
        assert reg.stats.hits == 1


def degree_scores(scale):
    """A stand-in trained model: (store) → scores[N]."""
    def infer(store):
        return (np.diff(store.adjacency()[0]) * scale).astype(np.float32)
    return infer


class TestGnnInferBridge:
    """``CALL gnn.infer($model)`` through the same registry and memo as
    the GRAPE procedures (the trainer itself is the learning slice)."""

    @pytest.fixture
    def reg(self):
        reg = ProcedureRegistry(device="cpu")
        reg.register_model("m", degree_scores(1.0))
        return reg

    def test_service_roundtrip(self, store, reg):
        svc = QueryService(store, procedures=reg, device="cpu")
        resps, stats = svc.serve([
            ("CALL gnn.infer($m) YIELD v, score "
             "RETURN v AS v, score AS s ORDER BY s DESC LIMIT 5",
             {"m": "m"})])
        top = np.sort(degree_scores(1.0)(store))[-5:][::-1]
        np.testing.assert_array_equal(resps[0].result["s"], top)
        assert stats.route_counts == {"grape": 1}

    def test_memo_per_registration(self, store, reg):
        a = reg.run(store, "gnn.infer", ("m",))
        assert reg.run(store, "gnn.infer", ("m",)) is a
        reg.register_model("m", degree_scores(2.0))
        np.testing.assert_array_equal(reg.run(store, "gnn.infer", ("m",)),
                                      2 * a)
        entries = [k for k in reg._results if k[1] == "gnn.infer"]
        assert len(entries) == 1                  # the old version purged

    def test_unknown_and_unregistered(self, store, reg):
        with pytest.raises(KeyError, match="no model"):
            reg.run(store, "gnn.infer", ("nope",))
        reg.unregister_model("m")
        with pytest.raises(KeyError):
            reg.run(store, "gnn.infer", ("m",))

    def test_clear_keeps_registrations(self, store, reg):
        before = reg.run(store, "gnn.infer", ("m",)).copy()
        reg.clear()
        np.testing.assert_array_equal(reg.run(store, "gnn.infer", ("m",)),
                                      before)
        assert reg.stats.misses == 1

    def test_infer_memo_pins_store(self, reg):
        g2 = snb_store(n_persons=50, n_items=20, n_posts=5, seed=1)
        scores = reg.run(g2, "gnn.infer", ("m",)).copy()
        pin = reg._engines[snapshot_token(g2)]
        assert isinstance(pin, _StorePin) and pin.store is g2
        gid = id(g2)
        del g2
        gc.collect()
        assert id(pin.store) == gid
        np.testing.assert_array_equal(
            reg.run(pin.store, "gnn.infer", ("m",)), scores)

    def test_grape_after_infer_same_token(self, store, reg):
        reg.run(store, "gnn.infer", ("m",))
        rank = reg.run(store, "pagerank", (0.85,))
        assert len(rank) == store.n_vertices and np.isfinite(rank).all()
