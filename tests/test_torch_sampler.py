"""The port's neighbour sampler against the JAX package's, bit for bit.

- the draw: ``repro_torch.kernels.sampler.sample_draw_ref`` through its
  CSR and ELL wrappers against ``repro.kernels.ref.sampler_ref``, the
  Pallas ``sample_ell`` (interpret mode), ``sample_ell_jnp`` and
  ``sample_csr_jnp``, on the padding cases of ``tests/test_sampler_diff.py``;
- the executor: ``repro_torch.engines.sample.FragmentSampleExecutor``
  against ``repro.engines.sample.FragmentSampleExecutor`` for F ∈ {1, 2, 4}
  and its stacked, psum and Pallas-kernel forms, with the reference's
  ``layer_uniforms`` handed to the port (torch cannot reproduce threefry);
- the host and device backends of ``repro_torch.learning.GraphSampler``.

Draws, ids and labels must be identical and features exactly equal: the
draw is one float32 multiply and a truncation in every version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engines.sample import FragmentSampleExecutor as JExecutor
from repro.kernels.ref import sampler_ref
from repro.kernels.sampler import (csr_to_sample_ell as j_csr_to_sample_ell,
                                   layer_uniforms, sample_csr_jnp,
                                   sample_ell as j_sample_ell,
                                   sample_ell_jnp)
from repro.learning.sampler import GraphSampler as JSampler
from repro.storage.csr import CSRStore as JCSR
from repro.storage.generators import rmat_store as j_rmat
from repro_torch.engines.sample import FragmentSampleExecutor
from repro_torch.kernels import ops
from repro_torch.kernels.sampler import (csr_to_sample_ell, sample_csr,
                                         sample_draw_ref, sample_ell,
                                         sample_ell_width)
from repro_torch.learning.sampler import GraphSampler, uniform_index
from repro_torch.storage.csr import CSRStore as TCSR
from repro_torch.storage.generators import rmat_store as t_rmat
from repro_torch.storage.partition import PAD_SENTINEL

FANOUTS = (1, 4, 15)
FRAGS = (1, 2, 4)
ONE_MINUS = np.nextafter(np.float32(1), np.float32(0))


def featured(rmat, scale=8, n_feat=8, seed=4):
    g = rmat(scale=scale, edge_factor=8, seed=seed)
    n = g.n_vertices
    rng = np.random.default_rng(0)
    g._vprops["feat"] = rng.standard_normal((n, n_feat)).astype(np.float32)
    g._vprops["label"] = rng.integers(0, 3, n).astype(np.int32)
    return g


@pytest.fixture(scope="module")
def graphs():
    """(reference store, port store) of one featured R-MAT graph."""
    return featured(j_rmat), featured(t_rmat)


@pytest.fixture(scope="module")
def csr(graphs):
    indptr, indices = graphs[1].adjacency()
    return indptr, indices


def mixed_rows(n, m=130):
    """Every validity class: real rows, PAD (-1), out of range, and
    isolated rows — not a multiple of any block size."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, n, m).astype(np.int32)
    rows[5] = -1
    rows[17] = -1
    rows[29] = n + 1000
    rows[30] = n
    return rows


def uniforms(m, k, seed):
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (m, k)))
    u = np.array(u, np.float32)
    u.reshape(-1)[::7] = ONE_MINUS              # hit the deg − 1 clamp
    return u


def T(a):
    return torch.as_tensor(np.array(a))


def port_draws(indptr, indices, rows, u):
    """The port's draw through both layouts; asserts they agree."""
    deg = np.diff(indptr).astype(np.int32)
    starts = np.asarray(indptr[:-1], np.int64)
    idx = np.concatenate([indices, [PAD_SENTINEL]]).astype(np.int32)
    via_csr = sample_csr(T(starts), T(deg), T(idx), T(rows), T(u))
    ell, deg_e = csr_to_sample_ell(indptr, indices)
    via_ell = sample_ell(T(ell), T(deg_e), T(rows), T(u))
    assert torch.equal(via_csr, via_ell)
    assert torch.equal(via_csr, sample_draw_ref(T(starts), T(deg), T(idx),
                                                T(rows), T(u)))
    return via_csr.numpy()


class TestDrawVsReference:
    def test_slab_builder_is_the_reference(self, csr):
        indptr, indices = csr
        ell, deg = csr_to_sample_ell(indptr, indices)
        j_ell, j_deg = j_csr_to_sample_ell(indptr, indices)
        np.testing.assert_array_equal(ell, j_ell)
        np.testing.assert_array_equal(deg, j_deg)
        assert ell.shape[1] == sample_ell_width(deg)
        assert sample_ell_width(np.array([200], np.int32)) == 256
        assert sample_ell_width(np.zeros(0, np.int32)) == 1

    @pytest.mark.parametrize("fanout", FANOUTS)
    def test_matches_every_reference_form(self, csr, fanout):
        indptr, indices = csr
        n = len(indptr) - 1
        rows = mixed_rows(n)
        u = uniforms(len(rows), fanout, fanout)
        got = port_draws(indptr, indices, rows, u)
        ell, deg = j_csr_to_sample_ell(indptr, indices)
        np.testing.assert_array_equal(got, sampler_ref(ell, deg, rows, u))
        np.testing.assert_array_equal(got, np.asarray(j_sample_ell(
            jnp.asarray(ell), jnp.asarray(deg), jnp.asarray(rows),
            jnp.asarray(u), block_m=64, interpret=True)))
        np.testing.assert_array_equal(got, np.asarray(sample_ell_jnp(
            jnp.asarray(ell), jnp.asarray(deg), jnp.asarray(rows),
            jnp.asarray(u))))
        idx = np.concatenate([indices, [PAD_SENTINEL]]).astype(np.int32)
        np.testing.assert_array_equal(got, np.asarray(sample_csr_jnp(
            jnp.asarray(indptr[:-1].astype(np.int32)), jnp.asarray(deg),
            jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(u))))

    def test_padding_cases(self):
        """Edges into vertex 0 survive; isolated, PAD and out-of-range rows
        give PAD_SENTINEL; u = nextafter(1, 0) draws the last neighbour."""
        indptr = np.array([0, 2, 2, 5, 6])          # vertex 1 isolated
        indices = np.array([0, 3, 0, 0, 1, 0])      # edges into vertex 0
        rows = np.array([0, 1, 2, 3, -1, 4, 9, 2], np.int32)
        u = np.full((8, 3), ONE_MINUS, np.float32)
        u[:, 0] = 0.0
        got = port_draws(indptr, indices, rows, u)
        ell, deg = j_csr_to_sample_ell(indptr, indices)
        np.testing.assert_array_equal(got, sampler_ref(ell, deg, rows, u))
        np.testing.assert_array_equal(got[0], [0, 3, 3])
        np.testing.assert_array_equal(got[2], [0, 1, 1])
        np.testing.assert_array_equal(got[3], [0, 0, 0])
        for r in (1, 4, 5, 6):
            assert (got[r] == PAD_SENTINEL).all()

    def test_empty_batch_and_empty_graph(self, csr):
        indptr, indices = csr
        got = port_draws(indptr, indices, np.zeros(0, np.int32),
                         np.zeros((0, 3), np.float32))
        assert got.shape == (0, 3) and got.dtype == np.int32
        # a graph without edges: every draw is PAD
        got = port_draws(np.zeros(4, np.int64), np.zeros(0, np.int32),
                         np.array([0, 1, 2, -1], np.int32),
                         np.full((4, 2), 0.5, np.float32))
        assert (got == PAD_SENTINEL).all()


class TestDispatch:
    def args(self, device="cpu"):
        starts = torch.tensor([0, 2], dtype=torch.int64, device=device)
        deg = torch.tensor([2, 1], dtype=torch.int32, device=device)
        idx = torch.tensor([1, 0, 0, -1], dtype=torch.int32, device=device)
        rows = torch.tensor([0, 1, -1], dtype=torch.int32, device=device)
        u = torch.full((3, 2), 0.5, device=device)
        return starts, deg, idx, rows, u

    def test_unknown_device_raises(self):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            ops.sample_neighbors(*self.args("meta"))

    def test_cpu_takes_the_plain_version(self):
        before = ops.LAUNCHES["sample_ell"]
        got = ops.sample_neighbors(*self.args())
        assert ops.LAUNCHES["sample_ell"] == before      # no kernel launch
        assert got.tolist() == [[0, 0], [0, 0], [-1, -1]]

    @pytest.mark.parametrize("i,bad,match", [
        (0, torch.int32, "starts"), (1, torch.int64, "deg"),
        (2, torch.int64, "indices"), (3, torch.int64, "rows"),
        (4, torch.float64, "u")])
    def test_wrong_dtype_raises(self, i, bad, match):
        args = list(self.args())
        args[i] = args[i].to(bad)
        with pytest.raises(ValueError, match=match):
            ops.sample_neighbors(*args)

    def test_shape_mismatch_raises(self):
        starts, deg, idx, rows, u = self.args()
        with pytest.raises(ValueError, match="u must be"):
            ops.sample_neighbors(starts, deg, idx, rows[:2], u)


def oracle_walk(jgraph, seeds, key, fanouts):
    """The layered reference walk: layer_uniforms + sampler_ref."""
    indptr, indices = jgraph.adjacency()
    ell, deg = j_csr_to_sample_ell(indptr, indices)
    fr = np.asarray(seeds, np.int64)
    layers = []
    for l, k in enumerate(fanouts):
        u = np.asarray(layer_uniforms(key, l, len(fr), k))
        layers.append(sampler_ref(ell, deg, fr, u))
        fr = layers[-1].reshape(-1)
    return layers


def reference_uniforms(key, seeds, fanouts):
    """The per-hop uniforms the reference's ``_sample_impl`` draws."""
    out, m = [], len(seeds)
    for l, k in enumerate(fanouts):
        out.append(torch.as_tensor(np.array(layer_uniforms(key, l, m, k))))
        m *= k
    return out


class TestExecutorVsReference:
    SEEDS_N = 30

    def seeds(self, n):
        return np.concatenate([np.arange(self.SEEDS_N),
                               [-1, n + 5, n]]).astype(np.int32)

    @pytest.mark.parametrize("n_frags", FRAGS)
    @pytest.mark.parametrize("form", ["stacked", "psum", "kernel"])
    def test_batch_matches_reference(self, graphs, n_frags, form):
        jg, tg = graphs
        kw = ({"exchange": "psum", "use_kernels": True, "interpret": True}
              if form == "kernel" else {"exchange": form})
        jex = JExecutor(jg, n_frags=n_frags, label_prop="label", **kw)
        if form == "kernel":
            assert jex.use_kernels            # the slab fits the VMEM gate
        ex = FragmentSampleExecutor(tg, n_frags=n_frags, label_prop="label",
                                    device="cpu")
        key = jax.random.PRNGKey(11 + n_frags)
        seeds = self.seeds(tg.n_vertices)
        fanouts = (4, 3)
        j_layers, j_feats, j_lab = jex.sample(seeds, key, fanouts)
        layers, feats, lab = ex.sample(
            seeds, fanouts, uniforms=reference_uniforms(key, seeds, fanouts))
        for got, want in zip(layers, j_layers):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(feats, j_feats):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(j_lab))
        for got, want in zip(layers, oracle_walk(jg, seeds, key, fanouts)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert ex.n_frags == n_frags

    @pytest.mark.parametrize("fanout", FANOUTS)
    def test_fanouts_match_reference_impl(self, graphs, fanout):
        """Against the reference's traced ``_sample_impl`` (what its
        trainer and infer runner call)."""
        jg, tg = graphs
        jex = JExecutor(jg, n_frags=2)
        ex = FragmentSampleExecutor(tg, n_frags=2, device="cpu")
        key = jax.random.PRNGKey(13)
        seeds = np.arange(48, dtype=np.int32)
        j_layers, j_feats, _ = jex._sample_impl(
            jex._tables, jnp.asarray(seeds), key, (fanout,))
        layers, feats, lab = ex.sample(
            seeds, (fanout,),
            uniforms=reference_uniforms(key, seeds, (fanout,)))
        np.testing.assert_array_equal(layers[0].numpy(),
                                      np.asarray(j_layers[0]))
        np.testing.assert_array_equal(feats[1].numpy(),
                                      np.asarray(j_feats[1]))
        assert lab is None

    def test_shapes_and_empty_batch(self, graphs):
        ex = FragmentSampleExecutor(graphs[1], label_prop="label",
                                    device="cpu")
        gen = torch.Generator().manual_seed(0)
        layers, fts, lab = ex.sample(np.arange(6), (5, 2), generator=gen)
        assert [tuple(l.shape) for l in layers] == [(6, 5), (30, 2)]
        assert [tuple(f.shape) for f in fts] == [(6, 8), (30, 8), (60, 8)]
        assert lab.shape == (6,) and lab.dtype == torch.int32
        layers, fts, lab = ex.sample(np.zeros(0, np.int32), (4, 2),
                                     generator=gen)
        assert [tuple(l.shape) for l in layers] == [(0, 4), (0, 2)]
        assert [tuple(f.shape) for f in fts] == [(0, 8), (0, 8), (0, 8)]
        assert lab.shape == (0,)

    def test_gather_features_pads_with_zeros(self, graphs):
        tg = graphs[1]
        ex = FragmentSampleExecutor(tg, device="cpu")
        ids = np.array([3, -1, tg.n_vertices, 0])
        got = ex.gather_features(ids).numpy()
        feats = tg._vprops["feat"]
        np.testing.assert_array_equal(got[[0, 3]], feats[[3, 0]])
        assert (got[[1, 2]] == 0).all()

    def test_generator_draws_are_deterministic(self, graphs):
        ex = FragmentSampleExecutor(graphs[1], device="cpu")
        seeds = np.arange(64)
        a = ex.sample(seeds, (15, 4),
                      generator=torch.Generator().manual_seed(23))[0]
        b = ex.sample(seeds, (15, 4),
                      generator=torch.Generator().manual_seed(23))[0]
        c = ex.sample(seeds, (15, 4),
                      generator=torch.Generator().manual_seed(24))[0]
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert not torch.equal(a[0], c[0])

    def test_unported_forms_raise(self, graphs):
        tg = graphs[1]
        with pytest.raises(NotImplementedError, match="A7"):
            FragmentSampleExecutor(tg, exchange="psum", device="cpu")
        with pytest.raises(NotImplementedError, match="A7"):
            FragmentSampleExecutor(tg, mesh=object(), device="cpu")
        with pytest.raises(ValueError, match="unknown exchange"):
            FragmentSampleExecutor(tg, exchange="nope", device="cpu")
        ex = FragmentSampleExecutor(tg, device="cpu")
        with pytest.raises(NotImplementedError, match="write slice"):
            ex.advance(tg, None)

    def test_uniform_arguments_checked(self, graphs):
        ex = FragmentSampleExecutor(graphs[1], device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            ex.sample(np.arange(4), (2,))
        with pytest.raises(ValueError, match="shape"):
            ex.sample(np.arange(4), (2,), uniforms=[torch.zeros(4, 3)])
        with pytest.raises(ValueError, match="hops"):
            ex.sample(np.arange(4), (2, 2), uniforms=[torch.zeros(4, 2)])

    def test_default_device_is_cuda(self, graphs):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            FragmentSampleExecutor(graphs[1])


class TestGraphSampler:
    def test_host_backend_is_the_reference(self, graphs):
        """The host backend is a copy: one seed, the same draws."""
        jg, tg = graphs
        js = JSampler(jg, label_prop="label", seed=5)
        ts = GraphSampler(tg, label_prop="label", seed=5, device="cpu")
        seeds = np.concatenate([np.arange(16), [-1]])
        for _ in range(3):
            jb = js.sample_batch(seeds, [4, 3])
            tb = ts.sample_batch(seeds, [4, 3])
            for x, y in zip(tb.layers, jb.layers):
                np.testing.assert_array_equal(x, y)
            for x, y in zip(tb.features, jb.features):
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(tb.labels, jb.labels)

    def test_uniform_index_is_the_reference(self):
        from repro.learning.sampler import uniform_index as j_uniform_index

        u = np.random.default_rng(0).random((50, 6))
        d = np.random.default_rng(1).integers(0, 9, (50, 1))
        np.testing.assert_array_equal(uniform_index(u, d),
                                      j_uniform_index(u, d))

    def test_device_backend_shares_host_contract(self, graphs):
        tg = graphs[1]
        s = GraphSampler(tg, label_prop="label", seed=5, backend="device",
                         device="cpu")
        seeds = np.array([0, 3, -1, 7])
        b = s.sample_batch(seeds, [4, 3])
        assert [l.shape for l in b.layers] == [(4, 4), (16, 3)]
        assert all(l.dtype == np.int64 for l in b.layers)
        assert (b.layers[0][2] == -1).all()
        assert (b.features[0][2] == 0).all() and b.labels[2] == 0
        indptr, indices = tg.adjacency()
        for i, v in enumerate(seeds):
            if v < 0:
                continue
            nbrs = set(indices[indptr[v]:indptr[v + 1]].tolist())
            drawn = b.layers[0][i]
            assert set(drawn[drawn >= 0].tolist()) <= nbrs

    def test_device_steps_reproducible_and_distinct(self, graphs):
        tg = graphs[1]
        a = GraphSampler(tg, seed=5, backend="device", device="cpu")
        b = GraphSampler(tg, seed=5, backend="device", device="cpu")
        seeds = np.arange(32)
        a0, a1 = (a.sample_batch(seeds, [15]) for _ in range(2))
        b0 = b.sample_batch(seeds, [15])
        np.testing.assert_array_equal(a0.layers[0], b0.layers[0])
        assert not np.array_equal(a0.layers[0], a1.layers[0])

    def test_ncn_and_unknown_backend(self, graphs):
        tg = graphs[1]
        with pytest.raises(ValueError, match="backend"):
            GraphSampler(tg, backend="gpu", device="cpu")
        s = GraphSampler(tg, device="cpu")
        with pytest.raises(NotImplementedError, match="A6"):
            s.sample_ncn(np.array([[0, 1]]), [2])


def test_csr_store_with_isolated_tail():
    """A graph whose last vertices have no edges: the trailing sentinel
    keeps their (masked) reads in bounds, as in the reference."""
    n = 10
    src, dst = np.array([0, 1, 2]), np.array([1, 2, 0])
    feat = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    jg = JCSR(n, src, dst, vertex_props={"feat": feat})
    tg = TCSR(n, src, dst, vertex_props={"feat": feat})
    key = jax.random.PRNGKey(0)
    seeds = np.arange(n, dtype=np.int32)
    jl, jf, _ = JExecutor(jg).sample(seeds, key, (3,))
    ex = FragmentSampleExecutor(tg, device="cpu")
    tl, tf, _ = ex.sample(seeds, (3,),
                          uniforms=reference_uniforms(key, seeds, (3,)))
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
    np.testing.assert_array_equal(tf[1].numpy(), np.asarray(jf[1]))
