"""The port's serving slice end to end on the CPU:
``repro_torch.serving.QueryService(device="cpu")`` against
``repro.serving.QueryService`` on the same request streams — every
request must land on the same route and give a bag-equal result — plus
the state carried across (``store_from_arrays``, the generator), the
write route the port does not serve yet beside the grape route it does,
and the guard that importing the
port loads neither JAX nor the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import assert_results_bag_equal

from repro.serving import QueryService as JService
from repro.storage.csr import CSRStore as JCSR
from repro.storage.generators import snb_store as j_snb
from repro_torch.serving import QueryService as TService
from repro_torch.storage.csr import CSRStore as TCSR
from repro_torch.storage.csr import store_from_arrays
from repro_torch.storage.generators import snb_store as t_snb

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = dict(n_persons=300, n_items=150, n_posts=40, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jstore():
    return j_snb(**SMALL)


def stream():
    """A mixed stream: fragment templates (fixed hops with each tail
    kind, var-length, shortestPath), HiActor point lookups and
    interpreter-only shapes, interleaved, up to 8 requests a template."""
    reqs = []
    for b in range(8):
        reqs += [
            ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person)"
             "-[:BUY]->(i:Item) WITH i, COUNT(*) AS k "
             "RETURN i AS i, k AS k ORDER BY k DESC LIMIT 10", {"r": b}),
            ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person) "
             "WITH COUNT(*) AS c, SUM(b.region) AS s, MIN(b.credits) AS lo,"
             " MAX(b.credits) AS hi RETURN c AS c, s AS s, lo AS lo, "
             "hi AS hi", {"r": b}),
            ("MATCH (v:Person {id: $c})-[:KNOWS]->(f:Person) "
             "WITH v, COUNT(f) AS k RETURN k AS k", {"c": 7 * b + 1}),
            ("MATCH (a:Person)-[:KNOWS]->(b:Person) "
             "WHERE a.credits > b.credits RETURN b AS b", {}),
        ]
        if b < 4:
            reqs += [
                ("MATCH (a:Person {region: $r})-[:KNOWS*1..3]->(b:Person) "
                 "WHERE b.credits > $t RETURN b AS b", {"r": b, "t": 300}),
                ("MATCH p = shortestPath((a:Person {region: $r})"
                 "-[:KNOWS*1..4]->(b:Person)) RETURN b AS b, dist AS d",
                 {"r": b}),
                ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:BUY]->(c:Item) "
                 "WHERE c.price > $p RETURN c.price AS pr", {"p": 100 * b}),
            ]
    return reqs


def assert_same_service(jsvc, tsvc, reqs):
    jr, jstats = jsvc.serve(reqs)
    tr, tstats = tsvc.serve(reqs)
    assert len(jr) == len(tr) == len(reqs)
    for (q, p), a, b in zip(reqs, jr, tr):
        assert a.engine == b.engine, (q, p, a.engine, b.engine)
        assert_results_bag_equal(a.result, b.result)
    assert jstats.route_counts == tstats.route_counts
    return tstats


class TestServiceMatchesReference:
    @pytest.mark.parametrize("n_frags", [1, 2])
    def test_mixed_stream(self, jstore, n_frags):
        stats = assert_same_service(
            JService(jstore, n_frags=n_frags),
            TService(t_snb(**SMALL), n_frags=n_frags, device="cpu"),
            stream())
        assert {"fragment", "hiactor", "gaia"} <= set(stats.route_counts)

    def test_device_tail_off(self, jstore):
        assert_same_service(
            JService(jstore, device_tail=False),
            TService(t_snb(**SMALL), device_tail=False, device="cpu"),
            stream()[:16])

    def test_fragment_overflow_falls_back_to_interpreter(self):
        """Walk counts past 2^24 on the fragment route rerun on the
        interpreter in both, reported as engine 'gaia'."""
        src = np.concatenate([np.zeros(4096, np.int64),
                              np.ones(4097, np.int64)])
        dst = np.concatenate([np.ones(4096, np.int64),
                              np.full(4097, 2, np.int64)])
        kw = dict(vertex_labels=np.zeros(3, np.int32),
                  edge_labels=np.zeros(len(src), np.int32),
                  vertex_props={"x": np.arange(3, dtype=np.int64)})
        reqs = [("MATCH (a)-[*3..3]->(b) RETURN b AS b", {})]
        assert_same_service(
            JService(JCSR(3, src, dst, **kw), fragment_min_cost=0.0),
            TService(TCSR(3, src, dst, **kw), fragment_min_cost=0.0,
                     device="cpu"), reqs)
        tr, _ = TService(TCSR(3, src, dst, **kw), fragment_min_cost=0.0,
                         device="cpu").serve(reqs)
        assert tr[0].engine == "gaia"


class TestStateCarriedAcross:
    def test_generator_is_byte_identical(self, jstore):
        tstore = t_snb(**SMALL)
        for a, b in ((jstore.indptr, tstore.indptr),
                     (jstore.indices, tstore.indices),
                     (jstore.vertex_labels(), tstore.vertex_labels()),
                     (jstore.edge_labels(), tstore.edge_labels())):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for name in ("id", "credits", "price", "region", "is_fraud_seed"):
            assert jstore.vertex_prop(name).tobytes() == \
                tstore.vertex_prop(name).tobytes()
        for name in ("date", "rating"):
            assert jstore.edge_prop(name).tobytes() == \
                tstore.edge_prop(name).tobytes()
        assert jstore.csc_edge_map().tobytes() == \
            tstore.csc_edge_map().tobytes()

    def test_store_from_arrays_answers_as_reference(self, jstore):
        tstore = store_from_arrays(
            jstore.n_vertices, jstore.indptr, jstore.indices,
            {k: jstore.vertex_prop(k) for k in
             ("id", "credits", "price", "region", "is_fraud_seed")},
            {k: jstore.edge_prop(k) for k in ("date", "rating")},
            jstore.vertex_labels(), jstore.edge_labels())
        assert tstore.indices is not jstore.indices       # copied
        assert np.array_equal(tstore.csc_edge_map(), jstore.csc_edge_map())
        assert_same_service(JService(jstore),
                            TService(tstore, device="cpu"), stream()[:24])

    def test_store_from_arrays_rejects_bad_parts(self, jstore):
        with pytest.raises(ValueError, match="indptr"):
            store_from_arrays(jstore.n_vertices, jstore.indptr[:-1],
                              jstore.indices)


WRITE = ("MATCH (a:Person {id: $x}), (b:Person {id: $y}) "
         "CREATE (a)-[:KNOWS]->(b)")
CALL = "CALL algo.pagerank(0.85) YIELD v, rank RETURN rank AS rank"


class TestRoutesNotServedYet:
    @pytest.mark.parametrize("template", [WRITE])
    def test_rejected_and_others_requeued(self, template):
        svc = TService(t_snb(**SMALL), device="cpu")
        good = "MATCH (v:Person {id: $c}) RETURN v.credits AS c"
        svc.submit(good, {"c": 3})
        svc.submit(template, {"x": 1, "y": 2})
        with pytest.raises(NotImplementedError):
            svc.flush()
        rs, _ = svc.flush()                 # the valid request survived
        assert len(rs) == 1 and rs[0].engine == "hiactor"

    def test_call_served_on_grape_while_write_rejected(self, jstore):
        """CALL plans are served on the grape route, as the reference
        serves them; a write in the same flush is still rejected and the
        other requests are requeued."""
        svc = TService(t_snb(**SMALL), device="cpu")
        good = "MATCH (v:Person {id: $c}) RETURN v.credits AS c"
        svc.submit(good, {"c": 3})
        svc.submit(CALL)
        svc.submit(WRITE, {"x": 1, "y": 2})
        with pytest.raises(NotImplementedError, match="write"):
            svc.flush()
        rs, stats = svc.flush()
        assert [r.engine for r in rs] == ["hiactor", "grape"]
        want, _ = JService(jstore).serve([(CALL, {})])
        np.testing.assert_allclose(rs[1].result["rank"],
                                   want[0].result["rank"], rtol=1e-4,
                                   atol=1e-7)


def test_default_device_is_cuda():
    """No device means CUDA: without it the service refuses instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TService(t_snb(**SMALL))


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.serving, "
            "repro_torch.engines.frontier, repro_torch.kernels.ops, "
            "repro_torch.kernels.build, repro_torch.engines.grape, "
            "repro_torch.engines.procedures, repro_torch.learning, "
            "repro_torch.engines.sample, repro_torch.kernels.sampler; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
