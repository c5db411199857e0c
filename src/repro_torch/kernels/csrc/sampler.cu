// Batched fixed-fanout neighbour sampling, drawn straight off CSR.
//
// Replaces the Pallas TPU kernel sample_ell (src/repro/kernels/sampler.py:
// 77-126: _sampler_kernel and its wrapper) behind ops.sample_neighbors. It
// computes the same function with CSR addressing (an ELL slab is the case
// starts[r] = r * W):
//
//   col[m,k] = min(trunc(u[m,k] * float(deg[r])), max(deg[r] - 1, 0))
//   out[m,k] = indices[starts[r] + col[m,k]],   r = rows[m]
//
// and PAD_SENTINEL (-1) where r < 0, r >= R or deg[r] == 0.
//
// Design. The TPU kernel keeps the whole [R, W] slab resident in VMEM,
// which at the learning configuration's width (max degree 19,889) would
// be 10.5 GB; here nothing is resident and the draw reads the edge list
// where it lies. One thread takes one draw: a block takes kRows seed
// rows, its first kRows threads read rows[m], deg[r] and starts[r] once
// per seed row into shared memory, and then the block's threads walk the
// tile's kRows * K draws, which lie contiguous in u and out (coalesced),
// each doing one random read of indices. A warp per seed row with its
// lanes across K leaves 32 - K lanes idle at K = 15 or 10 and measured
// slower over one inference chunk's two hops on an H100 (PERF.md).
//
// What bounds it. Bytes: u, rows and out once each, and each distinct
// 32-byte sector of indices, deg and starts that the draws touch. There is no arithmetic to speak of. The reads
// of indices depend on deg and starts, which depend on rows, so each
// draw is a chain of three dependent loads: latency, not bandwidth, is
// what a small M pays for.
//
// Exactness. The draw is __fmul_rn then __float2int_rz: a rounded float32
// multiply and a truncation, which neither --use_fast_math nor FMA
// contraction can change, so the kernel gives the plain version's bits.
// The position starts[r] + col is computed in 64 bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kRows = 16;                  // seed rows per block

__device__ __forceinline__ int draw_col(float u, int d) {
  const int col = __float2int_rz(__fmul_rn(u, __int2float_rn(d)));
  return min(col, d - 1);
}

__global__ void __launch_bounds__(kThreads)
sample_tile_kernel(const long long* __restrict__ starts,
                   const int* __restrict__ deg,
                   const int* __restrict__ indices,
                   const int* __restrict__ rows, const float* __restrict__ u,
                   int* __restrict__ out, long long M, int K, int R) {
  __shared__ long long s_start[kRows];
  __shared__ int s_deg[kRows];               // 0 for an invalid row
  const long long m0 = (long long)blockIdx.x * kRows;
  if (threadIdx.x < kRows) {
    const long long m = m0 + threadIdx.x;
    int d = 0;
    long long st = 0;
    if (m < M) {
      const int r = rows[m];
      if (r >= 0 && r < R) {
        d = deg[r];
        st = starts[r];
      }
    }
    s_deg[threadIdx.x] = d;
    s_start[threadIdx.x] = st;
  }
  __syncthreads();
  const long long here = M - m0 < kRows ? M - m0 : kRows;
  const int n = (int)here * K;
  const long long base = m0 * K;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int lm = i / K;
    const int d = s_deg[lm];
    int v = -1;
    if (d > 0) v = indices[s_start[lm] + draw_col(u[base + i], d)];
    out[base + i] = v;
  }
}

}  // namespace

// starts int64 [R], deg int32 [R], indices int32 [E], rows int32 [M],
// u float32 [M, K]; out int32 [M, K] (every element written). Returns the
// cudaError_t of the launch.
extern "C" int sample_neighbors_launch(const long long* starts,
                                       const int* deg, const int* indices,
                                       const int* rows, const float* u,
                                       int* out, long long M, int K, int R,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || K == 0) return 0;
  if ((long long)kRows * K > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + kRows - 1) / kRows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sample_tile_kernel<<<grid, kThreads, 0, s>>>(starts, deg, indices, rows, u,
                                               out, M, K, R);
  return (int)cudaGetLastError();
}
