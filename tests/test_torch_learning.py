"""The port's learning stack (serving half) against the JAX package's:
GraphSAGE with the reference's parameters, ``SageTrainer.infer_scores``
on the reference's per-chunk uniforms, and ``CALL gnn.infer`` through
``repro_torch.serving.QueryService(device="cpu")`` beside
``repro.serving.QueryService``.

Scores are held within rtol 1e-5, atol 1e-6: the float32 products and
row sums of the two frameworks' matmuls run in other orders, so the last
bits differ; draws and ids are exact. Served scores equal the same
trainer's offline ``infer_scores`` bit for bit (the reference's own
contract, tests/test_procedures.py).
"""

import jax
import numpy as np
import pytest
import torch

from repro.engines.procedures import ProcedureRegistry as JRegistry
from repro.kernels.sampler import layer_uniforms
from repro.learning.gnn import GraphSAGE as JSage
from repro.learning.sampler import GraphSampler as JSampler
from repro.learning.trainer import SageTrainer as JTrainer
from repro.serving import QueryService as JService
from repro.storage.csr import CSRStore as JCSR
from repro_torch.engines.procedures import ProcedureRegistry
from repro_torch.learning import (GraphSAGE, GraphSampler, SageTrainer,
                                  params_from_reference)
from repro_torch.serving import QueryService
from repro_torch.storage.csr import CSRStore as TCSR
from repro_torch.storage.generators import rmat_edges

RTOL, ATOL = 1e-5, 1e-6
N = 2500                        # two INFER_CHUNKs, PAD seeds on the last
D, HIDDEN, CLASSES, FANOUTS = 8, 16, 3, (4, 3)
KEY = 5
TOPK = ("CALL gnn.infer($m) YIELD v, score "
        "RETURN v AS v, score AS s ORDER BY s DESC LIMIT 10")
ALL = "CALL gnn.infer('sage') YIELD v, score RETURN v AS v, score AS s"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def graph_arrays(n=N, seed=3):
    """R-MAT edges folded onto n vertices (isolated ones included), with
    features and labels."""
    src, dst = rmat_edges(12, 4, seed=seed)
    rng = np.random.default_rng(0)
    vp = {"feat": rng.standard_normal((n, D)).astype(np.float32),
          "label": rng.integers(0, CLASSES, n).astype(np.int32)}
    return n, src % n, dst % n, vp


@pytest.fixture(scope="module")
def stores():
    n, src, dst, vp = graph_arrays()
    return (JCSR(n, src, dst, vertex_props=dict(vp)),
            TCSR(n, src, dst, vertex_props=dict(vp)))


@pytest.fixture(scope="module")
def reference(stores):
    """The JAX package's trainer (initial parameters) over the store."""
    js = JSampler(stores[0], label_prop="label")
    return JTrainer(js, hidden=HIDDEN, n_classes=CLASSES,
                    fanouts=list(FANOUTS), seed=0)


def tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def chunk_uniforms(key):
    """The reference's draws: chunk i, hop l from fold_in(PRNGKey(key), i)."""
    base = jax.random.PRNGKey(key)

    def draw(i, l, m, k):
        return torch.as_tensor(np.array(layer_uniforms(
            jax.random.fold_in(base, i), l, m, k)))
    return draw


@pytest.fixture(scope="module")
def trainer(stores, reference):
    ts = GraphSampler(stores[1], label_prop="label", device="cpu")
    return SageTrainer(ts, HIDDEN, CLASSES, FANOUTS,
                       params=tree(reference.params))


class TestGraphSAGE:
    def test_state_names_and_layout(self, reference):
        model = GraphSAGE(D, HIDDEN, CLASSES, FANOUTS, device="cpu")
        sd = model.state_dict()
        assert sorted(sd) == sorted(params_from_reference(
            tree(reference.params)))
        assert tuple(sd["l0.w_self"].shape) == (D, HIDDEN)
        assert tuple(sd["l1.w_nbr"].shape) == (HIDDEN, HIDDEN)
        assert tuple(sd["out.w"].shape) == (HIDDEN, CLASSES)

    def test_logits_and_loss_match_reference(self, stores, reference):
        jm = JSage(D, HIDDEN, CLASSES, FANOUTS)
        params = jm.init(jax.random.PRNGKey(7))
        model = GraphSAGE(D, HIDDEN, CLASSES, FANOUTS, device="cpu")
        model.load_state_dict(params_from_reference(tree(params)))
        b = JSampler(stores[0], label_prop="label", seed=1).sample_batch(
            np.concatenate([np.arange(40), [-1, -1]]), list(FANOUTS))
        want = np.asarray(jm.logits(params, b.features, b.layers))
        with torch.no_grad():
            got = model.logits([torch.as_tensor(f) for f in b.features],
                               [torch.as_tensor(l) for l in b.layers])
        assert got.shape == want.shape == (42, CLASSES)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        labels = b.labels.astype(np.int32)
        want_loss = float(jm.loss(params, b.features, b.layers, labels))
        with torch.no_grad():
            got_loss = float(model.loss(
                [torch.as_tensor(f) for f in b.features],
                [torch.as_tensor(l) for l in b.layers],
                torch.as_tensor(labels)))
        np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)

    def test_seeded_init_is_deterministic(self):
        a = GraphSAGE(D, HIDDEN, CLASSES, FANOUTS, device="cpu",
                      generator=torch.Generator().manual_seed(3))
        b = GraphSAGE(D, HIDDEN, CLASSES, FANOUTS, device="cpu",
                      generator=torch.Generator().manual_seed(3))
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
        assert (a.out["b"] == 0).all()

    @pytest.mark.parametrize("caller_tf32", [True, False])
    def test_tf32_off_in_forward_only(self, monkeypatch, caller_tf32):
        # the forward runs with TF32 off and leaves the caller's setting
        model = GraphSAGE(D, HIDDEN, CLASSES, FANOUTS, device="cpu")
        seen, relu = [], torch.relu

        def spy(x):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return relu(x)
        monkeypatch.setattr(torch, "relu", spy)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            caller_tf32)
        m = 6
        feats = [torch.ones(m * int(np.prod(FANOUTS[:l])), D)
                 for l in range(len(FANOUTS) + 1)]
        nbrs = [torch.zeros(m * int(np.prod(FANOUTS[:l])), FANOUTS[l],
                            dtype=torch.int32) for l in range(len(FANOUTS))]
        with torch.no_grad():
            assert model.logits(feats, nbrs).shape == (m, CLASSES)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is caller_tf32


class TestInferScores:
    def test_matches_reference(self, stores, reference, trainer):
        want = reference.infer_scores(key=KEY)
        got = trainer.infer_scores(key=KEY, uniforms=chunk_uniforms(KEY))
        assert got.dtype == np.float32 and got.shape == (N,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_foreign_store_matches_reference(self, reference, trainer):
        """A snapshot other than the sampler's runs on its own executor."""
        n, src, dst, vp = graph_arrays(n=900, seed=8)
        jg = JCSR(n, src, dst, vertex_props=dict(vp))
        tg = TCSR(n, src, dst, vertex_props=dict(vp))
        want = reference.infer_scores(store=jg, key=2)
        got = trainer.infer_scores(store=tg, key=2,
                                   uniforms=chunk_uniforms(2))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_generator_draws_deterministic_per_key(self, trainer):
        a = trainer.infer_scores(key=1)
        np.testing.assert_array_equal(a, trainer.infer_scores(key=1))
        assert not np.array_equal(a, trainer.infer_scores(key=2))
        assert np.isfinite(a).all()

    def test_chunk_grid_fixed(self):
        import inspect
        assert SageTrainer.INFER_CHUNK == 2048
        assert "chunk" not in inspect.signature(
            SageTrainer.infer_scores).parameters

    def test_foreign_executor_cache_is_bounded(self, trainer):
        n, src, dst, vp = graph_arrays(n=300, seed=9)
        for _ in range(trainer.max_ext_executors + 3):
            g = TCSR(n, src, dst, vertex_props=dict(vp))
            trainer.infer_scores(store=g)
        assert len(trainer._ext_executors) <= trainer.max_ext_executors
        assert all(s is not None for s, _ in trainer._ext_executors.values())

    def test_training_waits_for_its_slice(self, trainer):
        for call in (lambda: trainer.sample(0),
                     lambda: trainer.train_on({}),
                     lambda: trainer.train_step_device(0),
                     lambda: trainer.train(1)):
            with pytest.raises(NotImplementedError, match="A6"):
                call()


def both_registered(reference, trainer, name="sage"):
    """Each side's model registered under one name; the port's draws are
    the reference's per-chunk uniforms."""
    jreg = JRegistry()
    reference.register_inference(jreg, name, key=0)
    reg = ProcedureRegistry(device="cpu")
    params = {k: v.clone() for k, v in trainer.params.items()}
    draws = chunk_uniforms(0)
    reg.register_model(name, lambda store: trainer.infer_scores(
        store, params=params, key=0, uniforms=draws))
    return jreg, reg


class TestGnnInferService:
    def test_call_matches_reference_service(self, stores, reference,
                                            trainer):
        jreg, reg = both_registered(reference, trainer)
        jr, jst = JService(stores[0], procedures=jreg).serve(
            [(ALL, {}), (TOPK, {"m": "sage"})])
        tr, tst = QueryService(stores[1], procedures=reg,
                               device="cpu").serve(
            [(ALL, {}), (TOPK, {"m": "sage"})])
        assert tst.route_counts == jst.route_counts == {"grape": 2}
        assert [r.engine for r in tr] == ["grape", "grape"]
        # the score vector: every vertex, within tolerance
        order = np.argsort(np.asarray(jr[0].result["v"]))
        np.testing.assert_array_equal(np.asarray(tr[0].result["v"]),
                                      np.asarray(jr[0].result["v"]))
        np.testing.assert_allclose(
            np.asarray(tr[0].result["s"], np.float32)[order],
            np.asarray(jr[0].result["s"], np.float32)[order],
            rtol=RTOL, atol=ATOL)
        # top-k: scores within tolerance, ids where the gaps exceed it
        s_want = np.asarray(jr[1].result["s"], np.float64)
        np.testing.assert_allclose(tr[1].result["s"], s_want, rtol=RTOL,
                                   atol=ATOL)
        gap = np.abs(np.diff(s_want)) > ATOL + RTOL * np.abs(s_want[1:])
        keep = np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
        assert keep.sum() >= 5
        np.testing.assert_array_equal(np.asarray(tr[1].result["v"])[keep],
                                      np.asarray(jr[1].result["v"])[keep])
        assert reg.stats.misses == 1 and reg.stats.hits == 1

    def test_served_equals_offline_bit_for_bit(self, stores, trainer):
        reg = ProcedureRegistry(device="cpu")
        trainer.register_inference(reg, "sage", key=3)
        served = reg.run(stores[1], "gnn.infer", ("sage",))
        np.testing.assert_array_equal(served, trainer.infer_scores(key=3))
        resps, stats = QueryService(stores[1], procedures=reg,
                                    device="cpu").serve([(ALL, {})])
        vs = np.asarray(resps[0].result["v"], np.int64)
        assert len(vs) == N and stats.route_counts == {"grape": 1}
        np.testing.assert_array_equal(
            np.asarray(resps[0].result["s"], np.float32),
            trainer.infer_scores(key=3)[vs])

    def test_memo_hits_and_misses(self, stores, trainer):
        reg = ProcedureRegistry(device="cpu")
        trainer.register_inference(reg, "sage")
        svc = QueryService(stores[1], procedures=reg, device="cpu")
        svc.serve([(TOPK, {"m": "sage"})] * 4)
        assert (reg.stats.misses, reg.stats.hits) == (1, 3)
        reg.run(stores[1], "gnn.infer", ("sage",))
        assert (reg.stats.misses, reg.stats.hits) == (1, 4)

    def test_reregistration_serves_fresh_scores(self, stores, trainer):
        """A registration freezes its parameters; re-registering after
        they change serves fresh scores, never the stale memo entry."""
        ts = GraphSampler(stores[1], device="cpu")
        tr = SageTrainer(ts, HIDDEN, CLASSES, FANOUTS, seed=1)
        reg = ProcedureRegistry(device="cpu")
        tr.register_inference(reg, "m")
        before = reg.run(stores[1], "gnn.infer", ("m",)).copy()
        jm = JSage(D, HIDDEN, CLASSES, FANOUTS)
        tr.model.load_state_dict(params_from_reference(
            tree(jm.init(jax.random.PRNGKey(9)))))
        # the old registration still serves the frozen parameters
        reg.clear()
        np.testing.assert_array_equal(
            reg.run(stores[1], "gnn.infer", ("m",)), before)
        tr.register_inference(reg, "m")
        after = reg.run(stores[1], "gnn.infer", ("m",))
        np.testing.assert_array_equal(after, tr.infer_scores())
        assert not np.array_equal(before, after)
        assert len([k for k in reg._results if k[1] == "gnn.infer"]) == 1

    def test_unregister_and_unknown(self, stores, trainer):
        reg = ProcedureRegistry(device="cpu")
        trainer.register_inference(reg, "tmp")
        reg.run(stores[1], "gnn.infer", ("tmp",))
        reg.unregister_model("tmp")
        with pytest.raises(KeyError):
            reg.run(stores[1], "gnn.infer", ("tmp",))
        with pytest.raises(KeyError, match="no model"):
            reg.run(stores[1], "gnn.infer", ("nope",))

    def test_clear_keeps_registrations(self, stores, trainer):
        reg = ProcedureRegistry(device="cpu")
        trainer.register_inference(reg, "sage")
        before = reg.run(stores[1], "gnn.infer", ("sage",)).copy()
        reg.clear()
        after = reg.run(stores[1], "gnn.infer", ("sage",))
        assert reg.stats.misses == 1
        np.testing.assert_array_equal(before, after)


def test_default_device_is_cuda(stores):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphSampler(stores[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphSAGE(D, HIDDEN, CLASSES, FANOUTS)
