// ELL sparse matrix times vector.
//
// Replaces the Pallas TPU kernel spmv_ell (src/repro/kernels/spmv.py:37)
// behind ops.spmv (src/repro/kernels/ops.py:109); the scatter-add of split
// rows back onto their original rows stays in the wrapper, as it stays
// outside the Pallas kernel there.
//
//   y[r] = sum_w  w[r,w] * x[idx[r,w]]      over entries with idx[r,w] >= 0
//
// Design. The TPU kernel holds x whole in VMEM and tiles 256 slab rows a
// grid step. Here x is read from device memory (it fits the 50 MB L2 at
// the main path's N). frontier.cu puts its lanes on batch columns, which
// at one column would leave 31 lanes of 32 idle, so this kernel puts one
// warp on one slab row with its lanes across W: each lane reads one slab
// entry per 32-wide chunk (coalesced), a ballot skips chunks that are all
// padding, and a fixed butterfly of shuffles sums the lane totals.
//
// What bounds it. Bytes: idx read whole, w and x only where idx >= 0, y
// written once; two operations a valid entry.
//
// Exactness. Products and sums are rounded separately (no fused
// multiply-add), as the plain version rounds them; on integer values
// below 2**24 every summation order gives the plain version's bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps (slab rows) per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
spmv_ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ x, float* __restrict__ y, int R,
                int W) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;                      // whole warp leaves together
  const int* ri = idx + r * W;
  const float* rw = w + r * W;
  float acc = 0.0f;
  for (int c0 = 0; c0 < W; c0 += 32) {
    const int c = c0 + lane;
    const int s = c < W ? ri[c] : -1;
    if (__ballot_sync(kFull, s >= 0) == 0) continue;
    if (s >= 0) acc = __fadd_rn(acc, __fmul_rn(rw[c], x[s]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) y[r] = acc;
}

}  // namespace

// idx int32 [R, W], w float32 [R, W], x float32 [N]; y float32 [R] (every
// element written). Returns the cudaError_t of the launch.
extern "C" int spmv_ell_launch(const int* idx, const float* w,
                               const float* x, float* y, int R, int W,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0) return 0;
  const dim3 grid((unsigned)((R + kWarps - 1) / kWarps));
  spmv_ell_kernel<<<grid, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(idx, w, x, y, R, W);
  return (int)cudaGetLastError();
}
