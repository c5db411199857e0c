"""Each CUDA kernel of the port against its plain PyTorch version on the
card: bit-identical on integer inputs, one launch counted per call.
Every test here needs a CUDA GPU and skips without one; this file
imports nothing of JAX, so it also runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.storage.partition import PAD_SENTINEL


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


def T(a):
    return torch.as_tensor(np.asarray(a))


SHAPES = [(1, 256, 4, 64), (8, 256, 8, 64), (3, 512, 130, 200)]


@pytest.mark.cuda
class TestCudaKernels:
    """Each CUDA kernel against its plain version on the card."""

    @pytest.fixture(autouse=True)
    def _need_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    @pytest.mark.parametrize("B,R,W,n", SHAPES + [(70, 256, 33, 90)])
    @pytest.mark.parametrize("minplus", [False, True])
    def test_frontier_kernels(self, B, R, W, n, minplus):
        rng = np.random.default_rng(B + R + W)
        idx, w = random_slab(rng, R, W, n)
        row_map = np.sort(rng.integers(0, n, R)).astype(np.int64)
        x = dists(rng, B, n) if minplus else counts(rng, B, n)
        args = [T(a).cuda() for a in (idx, w, x, row_map)] + [n]
        step, plain = ((ops.frontier_minplus_step,
                        ref.frontier_minplus_step_ref) if minplus else
                       (ops.frontier_step, ref.frontier_step_ref))
        name = "frontier_ell_minplus" if minplus else "frontier_ell"
        before = ops.LAUNCHES[name]
        got = step(*args)
        assert ops.LAUNCHES[name] == before + 1
        assert torch.equal(got, plain(*args))

    @pytest.mark.parametrize("B,C,N", [(1, 1, 64), (64, 4, 9000),
                                       (8, 9, 5000), (3, 0, 100)])
    def test_tail_reduce_kernel(self, B, C, N):
        rng = np.random.default_rng(B + C + N)
        x = np.where(rng.random((B, N)) < 0.3, rng.integers(1, 9, (B, N)),
                     0).astype(np.float32)
        vals = rng.integers(-50, 50, (C, N)).astype(np.float32)
        xt, vt = T(x).cuda(), T(vals).cuda()
        for g, w_ in zip(ops.tail_reduce(xt, vt), ref.tail_reduce_ref(xt, vt)):
            assert torch.equal(g, w_)


def sorted_segments(rng, E, n_out, pad=0.2, hub=0.3):
    """Ascending segment ids with PAD_SENTINEL entries first, a hub
    segment 0 and empty segments."""
    segs = rng.integers(0, n_out, E)
    segs[rng.random(E) < hub] = 0
    segs[rng.random(E) < pad] = PAD_SENTINEL
    return np.sort(segs).astype(np.int32)


@pytest.mark.cuda
class TestCudaGrapeKernels:
    """segment_sum_sorted and spmv_ell against their plain versions on
    the card: bit-identical on integer values, within a stated tolerance
    on float values (another summation order)."""

    @pytest.fixture(autouse=True)
    def _need_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    @pytest.mark.parametrize("E,n_out", [(1, 1), (7, 3), (513, 40),
                                         (100_000, 3000), (40, 5000)])
    def test_segment_sum_kernel(self, E, n_out):
        rng = np.random.default_rng(E + n_out)
        segs = T(sorted_segments(rng, E, n_out)).cuda()
        vals = T(rng.integers(0, 9, E).astype(np.float32)).cuda()
        before = ops.LAUNCHES["segment_sum_sorted"]
        got = ops.segment_sum(vals, segs, n_out)
        assert ops.LAUNCHES["segment_sum_sorted"] == before + 1
        assert torch.equal(got, ref.segment_sum_ref(vals, segs, n_out))
        fv = T(rng.random(E).astype(np.float32)).cuda()
        got = ops.segment_sum(fv, segs, n_out)
        # deterministic: no atomics, the same bits on every run
        assert torch.equal(got, ops.segment_sum(fv, segs, n_out))
        want = ref.segment_sum_ref(fv, segs, n_out)
        scale = ref.segment_sum_ref(fv.abs(), segs, n_out).max()
        assert float((got - want).abs().max()) <= 1e-6 * float(scale)

    def test_segment_sum_rejects_unsorted(self):
        segs = torch.tensor([0, 2, 1], dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="sorted"):
            ops.segment_sum(torch.ones(3, device="cuda"), segs, 3)

    @pytest.mark.parametrize("R,W,n", [(256, 4, 64), (512, 130, 200),
                                       (256, 33, 90)])
    def test_spmv_kernel(self, R, W, n):
        rng = np.random.default_rng(R + W)
        idx, w = random_slab(rng, R, W, n)
        row_map = np.sort(rng.integers(0, n, R)).astype(np.int64)
        args = [T(a).cuda() for a in (idx, w)]
        rm = T(row_map).cuda()
        x = T(rng.integers(0, 9, n).astype(np.float32)).cuda()
        before = ops.LAUNCHES["spmv_ell"]
        got = ops.spmv(*args, x, rm, n)
        assert ops.LAUNCHES["spmv_ell"] == before + 1
        assert torch.equal(got, ref.spmv_step_ref(*args, x, rm, n))
        xf = T(rng.random(n).astype(np.float32)).cuda()
        torch.testing.assert_close(ops.spmv(*args, xf, rm, n),
                                   ref.spmv_step_ref(*args, xf, rm, n),
                                   rtol=1e-5, atol=1e-6)


def random_csr(rng, R, max_deg, hub=None, isolated=0.2):
    """CSR adjacency (starts int64, deg int32, indices int32 with one
    trailing sentinel) with isolated rows, edges into vertex 0 and one
    hub row of ``hub`` neighbours."""
    deg = rng.integers(1, max_deg + 1, R)
    deg[rng.random(R) < isolated] = 0
    if hub is not None:
        deg[R // 2] = hub
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, R, int(indptr[-1])).astype(np.int32)
    indices[rng.random(len(indices)) < 0.1] = 0
    return (indptr[:-1].astype(np.int64), deg.astype(np.int32),
            np.concatenate([indices, [PAD_SENTINEL]]).astype(np.int32))


def draw_rows(rng, R, M):
    """Seed rows with PAD (-1), out-of-range (≥ R) and hub rows."""
    rows = rng.integers(0, R, M).astype(np.int32)
    rows[rng.random(M) < 0.1] = PAD_SENTINEL
    rows[rng.random(M) < 0.05] = R + 7
    rows[::97] = R // 2
    return rows


def draw_uniforms(rng, M, K):
    """float32 uniforms in [0, 1), with nextafter(1, 0) to hit the clamp."""
    u = rng.random((M, K)).astype(np.float32)
    u.reshape(-1)[::13] = np.nextafter(np.float32(1), np.float32(0))
    return u


@pytest.mark.cuda
class TestCudaSampler:
    """sample_ell (csrc/sampler.cu) against sample_draw_ref on the card:
    bit-exact, on CSR and on an ELL slab."""

    @pytest.fixture(autouse=True)
    def _need_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    @pytest.mark.parametrize("R,M,K,hub", [
        (1, 1, 1, None), (300, 130, 4, 5000), (5000, 2048, 15, 20000),
        (2000, 3001, 10, 70_000), (64, 0, 3, None)])
    def test_csr_draws_bit_exact(self, R, M, K, hub):
        from repro_torch.kernels.sampler import sample_draw_ref

        rng = np.random.default_rng(R + M + K)
        starts, deg, indices = (T(a).cuda() for a in
                                random_csr(rng, R, 40, hub))
        rows = T(draw_rows(rng, R, M)).cuda()
        u = T(draw_uniforms(rng, M, K)).cuda()
        before = ops.LAUNCHES["sample_ell"]
        got = ops.sample_neighbors(starts, deg, indices, rows, u)
        assert ops.LAUNCHES["sample_ell"] == before + (1 if M else 0)
        assert got.dtype == torch.int32 and got.shape == (M, K)
        assert torch.equal(got, sample_draw_ref(starts, deg, indices, rows,
                                                u))

    @pytest.mark.parametrize("R,W,M,K", [(200, 33, 500, 7), (64, 256, 64, 15)])
    def test_ell_draws_bit_exact(self, R, W, M, K):
        from repro_torch.kernels.sampler import sample_draw_ref, sample_ell

        rng = np.random.default_rng(R + W)
        deg = rng.integers(0, W + 1, R).astype(np.int32)
        ell = rng.integers(0, R, (R, W)).astype(np.int32)
        ell[np.arange(W)[None] >= deg[:, None]] = PAD_SENTINEL
        ell_t, deg_t = T(ell).cuda(), T(deg).cuda()
        rows = T(draw_rows(rng, R, M)).cuda()
        u = T(draw_uniforms(rng, M, K)).cuda()
        starts = torch.arange(R, dtype=torch.int64, device="cuda") * W
        want = sample_draw_ref(starts, deg_t, ell_t.reshape(-1), rows, u)
        assert torch.equal(sample_ell(ell_t, deg_t, rows, u), want)

    def test_rejects_wrong_dtype_and_device(self):
        rng = np.random.default_rng(0)
        starts, deg, indices = (T(a).cuda() for a in random_csr(rng, 50, 5))
        rows = T(draw_rows(rng, 50, 20)).cuda()
        u = T(draw_uniforms(rng, 20, 3)).cuda()
        with pytest.raises(ValueError, match="float32"):
            ops.sample_neighbors(starts, deg, indices, rows, u.double())
        with pytest.raises(ValueError, match="one device"):
            ops.sample_neighbors(starts, deg, indices, rows.cpu(), u)
