// Batched pull-ELL frontier hop over a whole admission batch, in the
// counting semiring (+, x) or the tropical one (min, +).
//
// Replaces the Pallas TPU kernels frontier_ell and frontier_ell_minplus
// (src/repro/kernels/frontier.py:42 and :86) together with the scatter
// that follows each in src/repro/kernels/ops.py (frontier_step :120,
// frontier_minplus_step :133): split heavy slab rows fold back onto their
// destination vertex with atomics instead of a second pass.
//
//   sum:     yT[row_map[r], b] += sum_w  xT[idx[r,w], b] * w[r,w]   (idx >= 0)
//   minplus: yT[row_map[r], b]  = min(yT, min_w xT[idx[r,w], b] + 1) (idx >= 0, w > 0)
//
// Layout. The TPU kernel keeps all of x [B, N] resident in VMEM. At the
// main path's width (B = 64, N = 114,688: 29 MB) that is far beyond a
// block's 227 KB of shared memory, so x is read from device memory (it
// fits the 50 MB L2) in vertex-major form xT [N, B]: one source vertex's
// B counts are one contiguous run, so a warp's read of a gathered source
// is coalesced. The output is vertex-major yT [n_rows, B] for the same
// reason.
//
// Work split. One warp per slab row. The warp reads 32 slab entries at a
// time (coalesced), ballots the valid ones, and walks them with shuffles;
// for each, every lane accumulates K batch columns in registers. Weights
// are read only for non-padding entries.
//
// What bounds it. Bytes: the slab (idx, and w where idx >= 0), x once,
// y once; about two flops per (valid entry, batch column). At 1.55 %
// fill the KNOWS slab is mostly padding, so idx dominates the traffic.
//
// Exactness. Path counts are integers below 2**24 and distances are small
// integers, so every summation order gives the same float32 result;
// products and sums are rounded separately (no fused multiply-add), as
// the plain version rounds them. The scatter-min uses atomicMin on the
// int32 bit pattern, which orders non-negative floats (+inf included)
// exactly as float comparison does: distances are never negative.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;                  // warps (slab rows) per block
constexpr unsigned kFull = 0xffffffffu;

template <int K, bool MINPLUS>
__global__ void __launch_bounds__(kWarps * 32)
frontier_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const long long* __restrict__ row_map,
                    const float* __restrict__ xT, float* __restrict__ yT,
                    int R, int W, int B) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = first; r < R; r += stride) {
    const int* ri = idx + r * W;
    const float* rw = w + r * W;
    float* yrow = yT + row_map[r] * (long long)B;
    for (int b0 = 0; b0 < B; b0 += 32 * K) {
      float acc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = MINPLUS ? CUDART_INF_F : 0.0f;
      for (int c0 = 0; c0 < W; c0 += 32) {
        const int c = c0 + lane;
        int s = -1;
        float wv = 0.0f;
        if (c < W) {
          s = ri[c];
          if (s >= 0) wv = rw[c];
        }
        const bool ok = MINPLUS ? (s >= 0 && wv > 0.0f) : (s >= 0);
        unsigned live = __ballot_sync(kFull, ok);
        while (live) {
          const int j = __ffs(live) - 1;
          live &= live - 1;
          const int sj = __shfl_sync(kFull, s, j);
          const float wj = __shfl_sync(kFull, wv, j);
          const float* xs = xT + (long long)sj * B;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int b = b0 + lane + 32 * k;
            if (b < B) {
              const float v = xs[b];
              acc[k] = MINPLUS ? fminf(acc[k], __fadd_rn(v, 1.0f))
                               : __fadd_rn(acc[k], __fmul_rn(v, wj));
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int b = b0 + lane + 32 * k;
        if (b >= B) continue;
        if (MINPLUS) {
          if (acc[k] < CUDART_INF_F)
            atomicMin(reinterpret_cast<int*>(yrow + b), __float_as_int(acc[k]));
        } else if (acc[k] != 0.0f) {
          atomicAdd(yrow + b, acc[k]);
        }
      }
    }
  }
}

template <bool MINPLUS>
void launch(dim3 grid, cudaStream_t stream, const int* idx, const float* w,
            const long long* row_map, const float* xT, float* yT, int R,
            int W, int B) {
  const dim3 block(kWarps * 32);
  if (B <= 32)
    frontier_ell_kernel<1, MINPLUS><<<grid, block, 0, stream>>>(
        idx, w, row_map, xT, yT, R, W, B);
  else if (B <= 64)
    frontier_ell_kernel<2, MINPLUS><<<grid, block, 0, stream>>>(
        idx, w, row_map, xT, yT, R, W, B);
  else
    frontier_ell_kernel<4, MINPLUS><<<grid, block, 0, stream>>>(
        idx, w, row_map, xT, yT, R, W, B);
}

}  // namespace

// idx int32 [R, W], w float32 [R, W], row_map int64 [R] (values in
// [0, n_rows)), xT float32 [N, B]; yT float32 [n_rows, B] pre-filled with
// 0 (sum) or +inf (minplus). Returns the cudaError_t of the launch.
extern "C" int frontier_ell_launch(const int* idx, const float* w,
                                   const long long* row_map, const float* xT,
                                   float* yT, int R, int W, int B,
                                   int minplus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || B == 0 || W == 0) return 0;
  const dim3 grid((unsigned)((R + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (minplus)
    launch<true>(grid, s, idx, w, row_map, xT, yT, R, W, B);
  else
    launch<false>(grid, s, idx, w, row_map, xT, yT, R, W, B);
  return (int)cudaGetLastError();
}
