"""The port's fused device tail (WHERE / aggregates / ORDER BY + LIMIT on
the [B, N] counts, DESIGN.md §14) against the JAX package's fragment
executor on the same plans: the per-query views handed to
``finish_device_tail`` (counts, candidates, order, aggregates) must be
bit-identical and the results identical, values, dtypes and row order —
the reference *fragment executor* is the oracle, since its tie order
under a LIMIT differs from the interpreter's. Fallbacks (values float32
cannot carry, the tail switched off) must take the same path."""

import numpy as np
import pytest

import repro.engines.frontier as jfr
import repro_torch.engines.frontier as tfr
from repro.engines.gaia import GaiaEngine as JGaia
from repro.storage.csr import CSRStore as JCSR
from repro_torch.engines.gaia import GaiaEngine as TGaia
from repro_torch.storage.csr import CSRStore as TCSR
from test_torch_frontier import (CONFIGS, _one_thread, assert_exactly_equal,  # noqa: F401
                                 engines, executors)

# the reference suite's tail shapes (tests/test_tail.py::ELIGIBLE_QUERIES)
ELIGIBLE_QUERIES = [
    ("MATCH (a:Person {region: 2})-[:KNOWS]->(b:Person) "
     "WITH b, COUNT(*) AS k RETURN b AS v, k AS k", {}),
    ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person) "
     "WITH b, COUNT(*) AS k WHERE k > 1 "
     "RETURN b AS v, k AS k ORDER BY k DESC LIMIT 10", {"r": 2}),
    ("MATCH (a:Person {region: 1})-[:KNOWS]->(b:Person) "
     "WITH b, SUM(b.credits) AS s, MIN(b.credits) AS lo, "
     "MAX(b.credits) AS hi, AVG(b.credits) AS m "
     "RETURN b AS v, s AS s, lo AS lo, hi AS hi, m AS m "
     "ORDER BY s LIMIT 25", {}),
    ("MATCH (a:Person {region: 3})-[:KNOWS]->(b:Person) "
     "WITH COUNT(*) AS c, SUM(b.credits) AS s, MIN(b.credits) AS lo, "
     "MAX(b.credits) AS hi, AVG(b.credits) AS m "
     "RETURN c AS c, s AS s, lo AS lo, hi AS hi, m AS m", {}),
    ("MATCH (a:Person {region: 2})-[:KNOWS]->(b:Person) "
     "RETURN b AS v, b.credits AS c ORDER BY c LIMIT 20", {}),
    ("MATCH (a:Person {region: 2})-[:KNOWS]->(b:Person) "
     "WHERE b.credits > $t RETURN b AS v, b.credits AS c "
     "ORDER BY c DESC LIMIT 15", {"t": 120}),
    ("MATCH (a:Person {region: 4})-[:KNOWS*1..3]->(b:Person) "
     "WITH b, COUNT(*) AS k RETURN b AS v, k AS k "
     "ORDER BY k DESC LIMIT 12", {}),
    ("MATCH (a:Person {region: 5})-[:KNOWS]->(b:Person) "
     "WITH b, COUNT(*) AS k RETURN b AS v, k AS k "
     "ORDER BY k LIMIT 100000", {}),
    ("MATCH (a:Person {region: 2})-[:KNOWS]->(b:Person) "
     "WITH b, COUNT(*) AS k RETURN b AS v, k AS k LIMIT 7", {}),
]


def run_views(monkeypatch, jex, tex, jplan, tplan, params):
    """Execute both; return (outputs, captured device-tail views)."""
    seen = {"j": [], "t": []}

    for mod, side in ((jfr, "j"), (tfr, "t")):
        orig = mod.finish_device_tail

        def wrapped(program, tail, view, *a, _orig=orig, _side=side, **k):
            seen[_side].append(view)
            return _orig(program, tail, view, *a, **k)
        monkeypatch.setattr(mod, "finish_device_tail", wrapped)
    return ((jex.execute(jplan, params), seen["j"]),
            (tex.execute(tplan, params), seen["t"]))


def assert_views_equal(jv, tv):
    assert len(jv) == len(tv)
    for a, b in zip(jv, tv):
        assert set(a) == set(b)
        for key in a:
            if key == "aggs":
                assert set(a["aggs"]) == set(b["aggs"])
                for name in a["aggs"]:
                    np.testing.assert_array_equal(
                        np.asarray(a["aggs"][name]),
                        np.asarray(b["aggs"][name]), err_msg=name)
            else:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              np.asarray(b[key]),
                                              err_msg=key)


class TestDeviceTailMatchesReference:
    @pytest.mark.parametrize("n_frags,use_kernels", CONFIGS)
    @pytest.mark.parametrize("qi", range(len(ELIGIBLE_QUERIES)))
    def test_single_query(self, monkeypatch, engines, qi, n_frags,
                          use_kernels):
        q, params = ELIGIBLE_QUERIES[qi]
        jg, tg = engines
        jex, tex = executors(engines, n_frags, use_kernels,
                             device_tail=True)
        before = tex.tail_stats["device"]
        (jout, jv), (tout, tv) = run_views(
            monkeypatch, jex, tex, jg.compile(q), tg.compile(q),
            [params or None])
        assert tv, "the port did not finish on the device tail"
        assert tex.tail_stats["device"] == before + 1
        assert_views_equal(jv, tv)
        assert_exactly_equal(jout[0], tout[0])

    @pytest.mark.parametrize("n_frags,use_kernels", [(2, False), (1, True),
                                                     (4, False), (4, True)])
    @pytest.mark.parametrize("batch", [1, 8, 64])
    @pytest.mark.parametrize("q", [
        ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person) "
         "WHERE b.credits > $t WITH b, COUNT(*) AS k "
         "RETURN b AS v, k AS k ORDER BY k DESC LIMIT 10"),
        ("MATCH (a:Person {region: $r})-[:KNOWS]->(b:Person) "
         "WHERE b.credits > $t WITH COUNT(*) AS c, SUM(b.region) AS s, "
         "MIN(b.credits) AS lo, MAX(b.credits) AS hi "
         "RETURN c AS c, s AS s, lo AS lo, hi AS hi"),
    ])
    def test_batched_params(self, monkeypatch, engines, q, batch, n_frags,
                            use_kernels):
        jg, tg = engines
        jex, tex = executors(engines, n_frags, use_kernels,
                             device_tail=True)
        params = [{"r": b % 8, "t": 100 + 5 * b} for b in range(batch)]
        (jout, jv), (tout, tv) = run_views(
            monkeypatch, jex, tex, jg.compile(q), tg.compile(q), params)
        assert_views_equal(jv, tv)
        for a, b in zip(jout, tout):
            assert_exactly_equal(a, b)


class TestFallbacks:
    def test_non_f32_exact_param(self, engines):
        """0.1 has no exact float32 image: both finish on the
        interpreter tail."""
        q = ("MATCH (a:Person {region: 2})-[:KNOWS]->(b:Person) "
             "WITH b, COUNT(*) AS k WHERE k > $t "
             "RETURN b AS v, k AS k ORDER BY k DESC LIMIT 50")
        jg, tg = engines
        jex, tex = executors(engines, 1, True, device_tail=True)
        before = dict(tex.tail_stats)
        want = jex.execute(jg.compile(q), [{"t": 0.1}])[0]
        got = tex.execute(tg.compile(q), [{"t": 0.1}])[0]
        assert_exactly_equal(want, got)
        assert tex.tail_stats["device"] == before["device"]
        assert tex.tail_stats["interpreter"] == before["interpreter"] + 1

    def test_huge_property(self):
        """Property values at/above 2^24 cannot ride float32 lanes."""
        n = 8
        src = np.array([0, 0, 1, 2, 3])
        dst = np.array([1, 2, 3, 3, 4])
        kw = dict(vertex_labels=np.zeros(n, np.int32),
                  edge_labels=np.zeros(len(src), np.int32),
                  vertex_props={"big": np.arange(n, dtype=np.int64)
                                + 2 ** 24})
        jg, tg = JGaia(JCSR(n, src, dst, **kw)), \
            TGaia(TCSR(n, src, dst, **kw), device="cpu")
        q = ("MATCH (a)-[]->(b) WITH b, SUM(b.big) AS s "
             "RETURN b AS v, s AS s ORDER BY s LIMIT 5")
        tex = tfr.FragmentFrontierExecutor(tg.pg, use_kernels=True,
                                           device="cpu")
        want = jfr.FragmentFrontierExecutor(jg.pg).execute(
            jg.compile(q), [None])[0]
        assert_exactly_equal(want, tex.execute(tg.compile(q), [None])[0])
        assert tex.tail_stats == {"device": 0, "interpreter": 1}

    def test_tail_overflow_finishes_on_interpreter(self):
        """A SUM whose Σ|·| certificate reaches 2^24 discards the device
        tail; the counts are still exact, so the interpreter finishes."""
        n = 6
        src = np.array([0, 1, 2, 3, 4])
        dst = np.array([5, 5, 5, 5, 5])
        kw = dict(vertex_labels=np.zeros(n, np.int32),
                  edge_labels=np.zeros(len(src), np.int32),
                  vertex_props={"v": np.full(n, 2 ** 23, np.int64)})
        jg, tg = JGaia(JCSR(n, src, dst, **kw)), \
            TGaia(TCSR(n, src, dst, **kw), device="cpu")
        q = "MATCH (a)-[]->(b) WITH SUM(b.v) AS s RETURN s AS s"
        for use_kernels in (False, True):
            tex = tfr.FragmentFrontierExecutor(
                tg.pg, use_kernels=use_kernels, device="cpu")
            want = jfr.FragmentFrontierExecutor(jg.pg).execute(
                jg.compile(q), [None])[0]
            assert_exactly_equal(want, tex.execute(tg.compile(q), [None])[0])
            assert tex.tail_stats == {"device": 0, "interpreter": 1}

    def test_device_tail_off(self, engines):
        q, params = ELIGIBLE_QUERIES[1]
        jg, tg = engines
        jex, tex = executors(engines, 2, False, device_tail=False)
        assert_exactly_equal(jex.execute(jg.compile(q), [params])[0],
                             tex.execute(tg.compile(q), [params])[0])
