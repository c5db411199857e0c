"""The port's ``FragmentFrontierExecutor`` (on the CPU) against the JAX
package's, on the same graph and the same plans: the [B, N] path-count
matrices must be bit-identical and the ``finish_*`` outputs identical
(values, dtypes and row order), for the edge-list hop
(``use_kernels=False``) and the slab hop (``use_kernels=True``; the
reference's Pallas kernels in interpret mode), at F ∈ {1, 2}. This file
covers fixed-hop chains; ``test_torch_varlen.py`` reuses its helpers for
var-length stages, shortestPath, batches and overflow."""

import numpy as np
import pytest
import torch

import repro.engines.frontier as jfr
import repro_torch.engines.frontier as tfr
from repro.engines.gaia import GaiaEngine as JGaia
from repro.storage.generators import snb_store as j_snb
from repro_torch.engines.gaia import GaiaEngine as TGaia
from repro_torch.storage.generators import snb_store as t_snb


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    kw = dict(n_persons=300, n_items=150, n_posts=40, seed=3)
    return JGaia(j_snb(**kw)), TGaia(t_snb(**kw), device="cpu")


_EXECS = {}


def executors(engines, n_frags, use_kernels, device_tail=False):
    """One reference and one port executor per configuration, shared
    across tests so the reference compiles each program once."""
    key = (id(engines), n_frags, use_kernels, device_tail)
    if key not in _EXECS:
        jg, tg = engines
        jkw = {"interpret": True} if use_kernels else {}
        _EXECS[key] = (
            jfr.FragmentFrontierExecutor(jg.pg, n_frags=n_frags,
                                         use_kernels=use_kernels,
                                         device_tail=device_tail, **jkw),
            tfr.FragmentFrontierExecutor(tg.pg, n_frags=n_frags,
                                         use_kernels=use_kernels,
                                         device_tail=device_tail,
                                         device="cpu"))
    return _EXECS[key]


def assert_exactly_equal(want, got):
    assert set(want) == set(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def run_captured(monkeypatch, jex, tex, jplan, tplan, params):
    """Execute both and return (reference, port) as (outputs, captured
    per-query count rows or distance matrices)."""
    seen = {"j": [], "t": []}

    def spy(mod, side):
        for name in ("finish_frontier", "finish_shortest"):
            orig = getattr(mod, name)

            def wrapped(program, *a, _orig=orig, _name=name, **k):
                grab = a[0] if _name == "finish_frontier" else a[1]
                seen[side].append(np.array(grab))
                return _orig(program, *a, **k)
            monkeypatch.setattr(mod, name, wrapped)

    spy(jfr, "j")
    spy(tfr, "t")
    jout = jex.execute(jplan, params)
    tout = tex.execute(tplan, params)
    return (jout, seen["j"]), (tout, seen["t"])


def check(monkeypatch, engines, query, params, n_frags, use_kernels):
    jg, tg = engines
    jex, tex = executors(engines, n_frags, use_kernels)
    (jout, jm), (tout, tm) = run_captured(
        monkeypatch, jex, tex, jg.compile(query), tg.compile(query), params)
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert len(jout) == len(tout) == len(params)
    for a, b in zip(jout, tout):
        assert_exactly_equal(a, b)


QUERIES = [
    "MATCH (i:Item)<-[:BUY]-(p:Person) WHERE p.credits > 500 RETURN p AS p",
    ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:BUY]->(c:Item) "
     "RETURN c AS c"),
    ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:BUY]->(c:Item) "
     "WHERE c.price > 100 RETURN c.price AS pr"),
    ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:KNOWS]->(c:Person)"
     "-[:BUY]->(i:Item) WHERE b.credits > 200 RETURN i AS i"),
    ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[e:BUY]->(i:Item) "
     "WHERE e.rating > 3 RETURN i.price AS pr"),
    ("MATCH (a:Person)-[:BUY]->(i:Item) WITH i, COUNT(a) AS k "
     "RETURN k AS k ORDER BY k DESC LIMIT 5"),
    ("MATCH (a:Person)-[:KNOWS]->(b:Person)-[:BUY]->(c:Item) "
     "WITH c, COUNT(a) AS k RETURN k AS k"),
]

CONFIGS = [(1, False), (2, False), (1, True), (2, True)]


class TestCountsMatchReference:
    @pytest.mark.parametrize("n_frags,use_kernels", CONFIGS)
    @pytest.mark.parametrize("query", QUERIES)
    def test_fixed_hops(self, monkeypatch, engines, query, n_frags,
                        use_kernels):
        check(monkeypatch, engines, query, [None], n_frags, use_kernels)


def test_default_device_is_cuda(engines):
    """No device means CUDA: without it the executor refuses instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfr.FragmentFrontierExecutor(engines[1].pg)
