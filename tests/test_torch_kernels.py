"""The port's kernel layer (``repro_torch.kernels``) against the JAX
package's: the plain PyTorch versions and the CPU dispatch of the
wrappers, bit-exact against ``repro.kernels.ops`` (Pallas kernels in
interpret mode) and ``repro.kernels.ref`` on random slabs with padding,
edges into vertex 0 and split heavy rows. Inputs are small integers, so
every summation order gives the same float32 result; the segment sum and
the SpMV are also held on float inputs, within 1e-6. The segment sum is
held against ``repro.kernels.ref.segment_sum_ref``, not the reference's
Pallas kernel, which does not run on the installed JAX (ROADMAP C2).
The CUDA kernels
themselves are held against the plain versions in ``test_torch_cuda.py``,
which runs only where a GPU is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.storage.partition import PAD_SENTINEL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def random_slab(rng, R, W, n, pad=0.3, vertex0=0.1):
    """Integer-weighted pull-ELL slab: PAD_SENTINEL holes, a share of
    entries pointing at vertex 0, weights in {0, 1, 2} (0 = masked)."""
    idx = rng.integers(0, n, (R, W)).astype(np.int32)
    idx[rng.random((R, W)) < vertex0] = 0
    idx[rng.random((R, W)) < pad] = PAD_SENTINEL
    w = rng.integers(0, 3, (R, W)).astype(np.float32)
    return idx, w


def counts(rng, B, n, p=0.4):
    return np.where(rng.random((B, n)) < p, rng.integers(1, 5, (B, n)),
                    0).astype(np.float32)


def dists(rng, B, n, p=0.4):
    return np.where(rng.random((B, n)) < p,
                    rng.integers(0, 6, (B, n)).astype(np.float32),
                    np.inf).astype(np.float32)


def split_slab(rng, n, heavy=9, row_split=4):
    """csr_to_ell of a CSR whose first rows exceed ``row_split`` (so they
    split across slab rows) and whose edges include vertex 0."""
    deg = rng.integers(0, 4, n)
    deg[:3] = heavy
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    indices[::5] = 0
    j = jops.csr_to_ell(indptr, indices, row_split=row_split)
    t = ops.csr_to_ell(indptr, indices, row_split=row_split)
    return j, t


def T(a):
    return torch.as_tensor(np.asarray(a))


SHAPES = [(1, 256, 4, 64), (8, 256, 8, 64), (3, 512, 130, 200)]


class TestPlainVersions:
    @pytest.mark.parametrize("B,R,W,n", SHAPES)
    def test_frontier_ref(self, B, R, W, n):
        rng = np.random.default_rng(R * 31 + W)
        idx, w = random_slab(rng, R, W, n)
        x = counts(rng, B, n)
        want = np.asarray(jref.frontier_ref(jnp.asarray(idx),
                                            jnp.asarray(w), jnp.asarray(x)))
        got = ref.frontier_ref(T(idx), T(w), T(x)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("B,R,W,n", SHAPES)
    def test_frontier_minplus_ref(self, B, R, W, n):
        rng = np.random.default_rng(R * 37 + W)
        idx, w = random_slab(rng, R, W, n)
        d = dists(rng, B, n)
        want = np.asarray(jref.frontier_minplus_ref(
            jnp.asarray(idx), jnp.asarray(w), jnp.asarray(d)))
        got = ref.frontier_minplus_ref(T(idx), T(w), T(d)).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("B,C,N", [(1, 1, 64), (4, 3, 512),
                                       (8, 5, 1000), (2, 0, 128)])
    def test_tail_reduce_ref(self, B, C, N):
        rng = np.random.default_rng(7 + N)
        x = np.where(rng.random((B, N)) < 0.3, rng.integers(1, 9, (B, N)),
                     0).astype(np.float32)
        vals = rng.integers(-50, 50, (C, N)).astype(np.float32)
        want = jref.tail_reduce_ref(x, vals)
        got = ref.tail_reduce_ref(T(x), T(vals))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_)

    def test_gather_chunking_is_invisible(self, monkeypatch):
        """The plain version bounds its gather intermediate by chunking
        rows; the chunk size must not change the result."""
        rng = np.random.default_rng(3)
        idx, w = random_slab(rng, 256, 16, 50)
        x = counts(rng, 4, 50)
        whole = ref.frontier_ref(T(idx), T(w), T(x))
        monkeypatch.setattr(ref, "_GATHER_ELEMS", 4 * 16 * 7)
        assert torch.equal(ref.frontier_ref(T(idx), T(w), T(x)), whole)


class TestWrappersOnCpu:
    def test_csr_to_ell_matches_reference(self):
        j, t = split_slab(np.random.default_rng(0), 40)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype

    @pytest.mark.parametrize("B", [1, 5])
    def test_frontier_step_split_rows(self, B):
        rng = np.random.default_rng(B)
        n = 40
        (ji, jw, jm), (ti, tw, tm) = split_slab(rng, n)
        x = counts(rng, B, n)
        want = np.asarray(jops.frontier_step(
            jnp.asarray(ji), jnp.asarray(jw), jnp.asarray(x),
            jnp.asarray(jm), n, interpret=True))
        got = ops.frontier_step(T(ti), T(tw), T(x), T(tm), n).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("B", [1, 5])
    def test_frontier_minplus_step_split_rows(self, B):
        rng = np.random.default_rng(10 + B)
        n = 40
        (ji, jw, jm), (ti, tw, tm) = split_slab(rng, n)
        d = dists(rng, B, n)
        want = np.asarray(jops.frontier_minplus_step(
            jnp.asarray(ji), jnp.asarray(jw), jnp.asarray(d),
            jnp.asarray(jm), n, interpret=True))
        got = ops.frontier_minplus_step(T(ti), T(tw), T(d), T(tm),
                                        n).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("B,C,N", [(1, 1, 64), (4, 3, 512),
                                       (8, 5, 1000)])
    def test_tail_reduce(self, B, C, N):
        rng = np.random.default_rng(N + C)
        x = np.where(rng.random((B, N)) < 0.3, rng.integers(1, 9, (B, N)),
                     0).astype(np.float32)
        vals = rng.integers(-50, 50, (C, N)).astype(np.float32)
        want = jops.tail_reduce(x, vals, interpret=True)
        got = ops.tail_reduce(T(x), T(vals))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))

    @pytest.mark.parametrize("B,N", [(1, 16), (5, 257), (3, 1024)])
    def test_masked_order(self, B, N):
        rng = np.random.default_rng(B * N)
        key = rng.integers(0, 7, (B, N)).astype(np.float32)   # ties
        mask = rng.random((B, N)) < 0.5
        want = jref.masked_order_ref(key, mask)
        np.testing.assert_array_equal(
            np.asarray(jops.masked_order(key, mask)), want)
        np.testing.assert_array_equal(
            ops.masked_order(T(key), T(mask)).numpy(), want)

    def test_no_launch_on_cpu(self):
        ops.reset_launches()
        rng = np.random.default_rng(1)
        idx, w = random_slab(rng, 256, 4, 20)
        ops.frontier_step(T(idx), T(w), T(counts(rng, 2, 20)),
                          torch.arange(256), 256)
        assert all(v == 0 for v in ops.LAUNCHES.values())

    @pytest.mark.parametrize("bad", ["idx_dtype", "w_shape", "row_map",
                                     "x_dtype", "noncontig"])
    def test_input_checks(self, bad):
        rng = np.random.default_rng(2)
        idx, w = random_slab(rng, 256, 4, 20)
        args = dict(ell_idx=T(idx), ell_w=T(w), x=T(counts(rng, 2, 20)),
                    row_map=torch.arange(256), n_rows=256)
        if bad == "idx_dtype":
            args["ell_idx"] = args["ell_idx"].long()
        elif bad == "w_shape":
            args["ell_w"] = args["ell_w"][:, :2]
        elif bad == "row_map":
            args["row_map"] = args["row_map"].int()
        elif bad == "x_dtype":
            args["x"] = args["x"].double()
        else:
            args["x"] = T(counts(rng, 20, 2)).t()
        with pytest.raises(ValueError):
            ops.frontier_step(**args)

    def test_other_devices_raise(self):
        """Only CPU tensors take the plain version; a tensor on a device
        without a kernel raises instead of silently running elsewhere."""
        meta = torch.device("meta")
        x = torch.zeros(2, 8, device=meta)
        vals = torch.zeros(1, 8, device=meta)
        with pytest.raises(ValueError, match="no kernel"):
            ops.tail_reduce(x, vals)
        idx = torch.zeros(256, 4, dtype=torch.int32, device=meta)
        with pytest.raises(ValueError, match="no kernel"):
            ops.frontier_step(idx, torch.zeros(256, 4, device=meta), x,
                              torch.zeros(256, dtype=torch.int64,
                                          device=meta), 8)


def sorted_segments(rng, E, n_out, pad=0.2, hub=0.3):
    """Ascending segment ids with PAD_SENTINEL entries first, a hub
    segment 0 holding ``hub`` of the entries, and empty segments."""
    segs = rng.integers(0, n_out, E)
    segs[rng.random(E) < hub] = 0
    segs[rng.random(E) < pad] = PAD_SENTINEL
    return np.sort(segs).astype(np.int32)


SEG_SHAPES = [(1, 1), (7, 3), (513, 40), (4096, 1000), (5000, 64)]


class TestSegmentSumAndSpmv:
    @pytest.mark.parametrize("E,n_out", SEG_SHAPES)
    def test_segment_sum_ref_unsorted(self, E, n_out):
        """The plain version needs no order: it equals the reference's
        oracle on unsorted ids, bit for bit on integer values."""
        rng = np.random.default_rng(E)
        segs = rng.integers(-1, n_out, E).astype(np.int32)
        vals = rng.integers(-20, 20, E).astype(np.float32)
        want = np.asarray(jref.segment_sum_ref(jnp.asarray(vals),
                                               jnp.asarray(segs), n_out))
        got = ref.segment_sum_ref(T(vals), T(segs), n_out).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("E,n_out", SEG_SHAPES)
    def test_segment_sum_wrapper(self, E, n_out):
        rng = np.random.default_rng(E + n_out)
        segs = sorted_segments(rng, E, n_out)
        vals = rng.integers(0, 9, E).astype(np.float32)
        want = np.asarray(jref.segment_sum_ref(jnp.asarray(vals),
                                               jnp.asarray(segs), n_out))
        got = ops.segment_sum(T(vals), T(segs), n_out).numpy()
        np.testing.assert_array_equal(got, want)
        fv = rng.random(E).astype(np.float32)
        want = np.asarray(jref.segment_sum_ref(jnp.asarray(fv),
                                               jnp.asarray(segs), n_out))
        np.testing.assert_allclose(
            ops.segment_sum(T(fv), T(segs), n_out).numpy(), want,
            rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("segs,n_out", [
        ([0, 2, 1, 3], 4),            # unsorted
        ([3, -1, 4, 5], 6),           # padding after an id
        ([0, 1, 5], 5),               # id past n_out
    ])
    def test_segment_sum_rejects(self, segs, n_out):
        segs = torch.tensor(segs, dtype=torch.int32)
        with pytest.raises(ValueError, match="sorted"):
            ops.segment_sum(torch.ones(len(segs)), segs, n_out)

    def test_segment_sum_rechecks_after_write(self):
        """The sortedness verdict kept on a tensor lapses when the tensor
        is written in place."""
        segs = torch.tensor([-1, 0, 0, 2], dtype=torch.int32)
        vals = torch.ones(4)
        assert ops.segment_sum(vals, segs, 3).tolist() == [2.0, 0.0, 1.0]
        segs[1] = 2
        with pytest.raises(ValueError):
            ops.segment_sum(vals, segs, 3)

    @pytest.mark.parametrize("bad", ["vals_dtype", "segs_dtype", "shape"])
    def test_segment_sum_input_checks(self, bad):
        vals, segs = torch.ones(4), torch.zeros(4, dtype=torch.int32)
        if bad == "vals_dtype":
            vals = vals.double()
        elif bad == "segs_dtype":
            segs = segs.long()
        else:
            vals = vals[:3]
        with pytest.raises(ValueError):
            ops.segment_sum(vals, segs, 2)

    @pytest.mark.parametrize("R,W,n", [(256, 4, 64), (512, 130, 200)])
    def test_spmv_ref(self, R, W, n):
        rng = np.random.default_rng(R + W)
        idx, w = random_slab(rng, R, W, n)
        x = rng.integers(0, 9, n).astype(np.float32)
        want = np.asarray(jref.spmv_ref(jnp.asarray(idx), jnp.asarray(w),
                                        jnp.asarray(x)))
        np.testing.assert_array_equal(
            ref.spmv_ref(T(idx), T(w), T(x)).numpy(), want)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_spmv_split_rows(self, seed):
        """ops.spmv against the reference's ``ops.spmv`` (Pallas kernel in
        interpret mode) on a slab with split heavy rows and edges into
        vertex 0: exact on integer x, within 1e-6 on float x."""
        rng = np.random.default_rng(20 + seed)
        n = 40
        (ji, jw, jm), (ti, tw, tm) = split_slab(rng, n)
        for x, exact in ((rng.integers(0, 9, n).astype(np.float32), True),
                         (rng.random(n).astype(np.float32), False)):
            want = np.asarray(jops.spmv(jnp.asarray(ji), jnp.asarray(jw),
                                        jnp.asarray(x), jnp.asarray(jm), n,
                                        interpret=True))
            got = ops.spmv(T(ti), T(tw), T(x), T(tm), n).numpy()
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_new_wrappers_refuse_other_devices(self):
        meta = torch.device("meta")
        with pytest.raises(ValueError, match="no kernel"):
            ops.segment_sum(torch.zeros(4, device=meta),
                            torch.zeros(4, dtype=torch.int32, device=meta), 2)
        with pytest.raises(ValueError, match="no kernel"):
            ops.spmv(torch.zeros(256, 4, dtype=torch.int32, device=meta),
                     torch.zeros(256, 4, device=meta),
                     torch.zeros(8, device=meta),
                     torch.zeros(256, dtype=torch.int64, device=meta), 8)

    def test_no_launch_on_cpu(self):
        ops.reset_launches()
        ops.segment_sum(torch.ones(3), torch.tensor([0, 1, 1],
                                                    dtype=torch.int32), 2)
        assert ops.LAUNCHES["segment_sum_sorted"] == 0
