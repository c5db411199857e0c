"""Var-length stages, shortestPath, parameterized batches (B ∈ {1, 8,
64}, F ∈ {1, 2, 4})
and the float32 overflow guards of the port's
``FragmentFrontierExecutor`` against the JAX package's: count matrices
and distances bit-identical, ``finish_*`` outputs identical, and
``OverflowError`` raised exactly where the reference raises it."""

import numpy as np
import pytest

import repro.engines.frontier as jfr
import repro_torch.engines.frontier as tfr
from repro.engines.gaia import GaiaEngine as JGaia
from repro.storage.csr import CSRStore as JCSR
from repro_torch.engines.gaia import GaiaEngine as TGaia
from repro_torch.storage.csr import CSRStore as TCSR
from test_torch_frontier import (CONFIGS, _one_thread, assert_exactly_equal,  # noqa: F401
                                 check, engines, run_captured)

VARLEN = [f"MATCH (a:Person {{region: 2}})-[:KNOWS*{lo}..{hi}]->(b:Person) "
          f"RETURN b AS b" for lo, hi in [(1, 2), (0, 2), (2, 3), (1, 3)]]

SHORTEST = [f"MATCH p = shortestPath((a:Person {{region: 2}})"
            f"-[:KNOWS*{lo}..{hi}]->(b:Person)) RETURN b AS b, dist AS d"
            for lo, hi in [(1, 4), (0, 3), (1, 2)]]

PARAM_QUERIES = [
    ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person)"
     "-[:KNOWS]->(c:Person) WHERE c.credits > $t RETURN c AS c"),
    ("MATCH (a:Person {region: $r})-[:KNOWS*1..2]->(b:Person) "
     "WHERE b.credits > $t RETURN b AS b"),
    ("MATCH p = shortestPath((a:Person {id: $r})-[:KNOWS*1..3]->"
     "(b:Person)) WHERE b.credits > $t RETURN a AS a, b AS b, dist AS d"),
]

class TestCountsMatchReference:
    @pytest.mark.parametrize("n_frags,use_kernels", CONFIGS)
    @pytest.mark.parametrize("query", VARLEN + SHORTEST)
    def test_single_query(self, monkeypatch, engines, query, n_frags,
                          use_kernels):
        check(monkeypatch, engines, query, [None], n_frags, use_kernels)

    @pytest.mark.parametrize("n_frags,use_kernels", CONFIGS)
    @pytest.mark.parametrize("batch", [1, 8])
    @pytest.mark.parametrize("qi", range(len(PARAM_QUERIES)))
    def test_parameterized_batch(self, monkeypatch, engines, qi, batch,
                                 n_frags, use_kernels):
        params = [{"r": b % 8, "t": 200 + 40 * b} for b in range(batch)]
        check(monkeypatch, engines, PARAM_QUERIES[qi], params, n_frags,
              use_kernels)


class TestWideConfigs:
    """F = 4 fragments and B = 64 admission batches (the GPU smoke run's
    batch width), both forms of the hop."""

    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("query", [VARLEN[3], SHORTEST[0],
                                       PARAM_QUERIES[0].replace(
                                           "$r", "2").replace("$t", "300")])
    def test_four_fragments(self, monkeypatch, engines, query, use_kernels):
        check(monkeypatch, engines, query, [None], 4, use_kernels)

    @pytest.mark.parametrize("n_frags,use_kernels", [(1, False), (4, False),
                                                     (4, True)])
    @pytest.mark.parametrize("qi", range(len(PARAM_QUERIES)))
    def test_batch_64(self, monkeypatch, engines, qi, n_frags, use_kernels):
        params = [{"r": (7 * b) % 300, "t": 100 + 13 * b}
                  for b in range(64)]
        if "region" in PARAM_QUERIES[qi]:
            params = [dict(p, r=p["r"] % 8) for p in params]
        check(monkeypatch, engines, PARAM_QUERIES[qi], params, n_frags,
              use_kernels)


def _both(src, dst, n, **props):
    """The same small hand-built graph in both packages."""
    kw = dict(vertex_labels=np.zeros(n, np.int32),
              edge_labels=np.zeros(len(src), np.int32),
              vertex_props={"x": np.arange(n, dtype=np.int64), **props})
    return JGaia(JCSR(n, src, dst, **kw)), TGaia(TCSR(n, src, dst, **kw),
                                                 device="cpu")


class TestSmallGraphs:
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("query", [
        "MATCH (a)-[]->(b) WITH b, COUNT(*) AS k RETURN b AS b, k AS k",
        "MATCH (a)-[*0..3]->(b) RETURN b AS b",
        ("MATCH p = shortestPath((a)-[*1..4]->(b)) "
         "RETURN a AS a, b AS b, dist AS d"),
    ])
    def test_multigraph_self_loops_and_vertex0(self, monkeypatch, query,
                                               use_kernels):
        """Parallel edges, self loops, an isolated vertex, edges into 0,
        and (at F = 4) fragments that own no rows."""
        src = np.array([1, 2, 2, 3, 0, 5, 5, 5, 4, 3, 3])
        dst = np.array([0, 0, 0, 3, 1, 2, 2, 4, 0, 3, 1])
        jg, tg = _both(src, dst, 7)
        for n_frags in (1, 4):
            kw = {"interpret": True} if use_kernels else {}
            jex = jfr.FragmentFrontierExecutor(
                jg.pg, n_frags=n_frags, use_kernels=use_kernels,
                device_tail=False, **kw)
            tex = tfr.FragmentFrontierExecutor(
                tg.pg, n_frags=n_frags, use_kernels=use_kernels,
                device_tail=False, device="cpu")
            (jout, jm), (tout, tm) = run_captured(
                monkeypatch, jex, tex, jg.compile(query), tg.compile(query),
                [None])
            for a, b in zip(jm, tm):
                np.testing.assert_array_equal(a, b)
            assert_exactly_equal(jout[0], tout[0])


def overflow_graphs():
    """0 →(4096 parallel edges) 1 →(4097) 2: the *3..3 walk count peaks
    at 4096·4097 ≥ 2^24 on an intermediate power while the final
    frontier is empty."""
    src = np.concatenate([np.zeros(4096, np.int64), np.ones(4097, np.int64)])
    dst = np.concatenate([np.ones(4096, np.int64),
                          np.full(4097, 2, np.int64)])
    return _both(src, dst, 3)


class TestOverflow:
    @pytest.mark.parametrize("use_kernels", [False, True])
    @pytest.mark.parametrize("query,raises", [
        ("MATCH (a)-[*3..3]->(b) RETURN b AS b", True),
        ("MATCH (a)-[*0..1]->(b) RETURN b AS b", False),
        ("MATCH (a)-[*1..3]->(b) WITH b, COUNT(*) AS k "
         "RETURN b AS b, k AS k", True),
    ])
    def test_raises_where_reference_raises(self, query, raises,
                                           use_kernels):
        jg, tg = overflow_graphs()
        outs = []
        for eng, ex in (
                (jg, jfr.FragmentFrontierExecutor(
                    jg.pg, use_kernels=use_kernels,
                    **({"interpret": True} if use_kernels else {}))),
                (tg, tfr.FragmentFrontierExecutor(
                    tg.pg, use_kernels=use_kernels, device="cpu"))):
            plan = eng.compile(query)
            if raises:
                with pytest.raises(OverflowError, match="2\\^24"):
                    ex.execute(plan, [None])
            else:
                outs.append(ex.execute(plan, [None])[0])
        if outs:
            assert_exactly_equal(*outs)

    def test_shortest_source_cap(self):
        """R·N > 2^26 sources × vertices refuses on both sides."""
        n = 70_000
        src = np.arange(n - 1)
        jg, tg = _both(src, src + 1, n)
        q = ("MATCH p = shortestPath((a)-[*1..2]->(b)) "
             "WHERE a.x < 1000 RETURN b AS b, dist AS d")
        for eng, ex in ((jg, jfr.FragmentFrontierExecutor(jg.pg)),
                        (tg, tfr.FragmentFrontierExecutor(tg.pg,
                                                          device="cpu"))):
            with pytest.raises(OverflowError, match="shortestPath"):
                ex.execute(eng.compile(q), [None])
