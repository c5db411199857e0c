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
