// Masked per-row reductions of the device tail: for path counts x [B, N]
// and aggregate value vectors vals [C, N],
//   cnt[b]    = sum_v x[b,v]
//   sums[b,c] = sum_v x[b,v] * vals[c,v]
//   sabs[b,c] = sum_v x[b,v] * |vals[c,v]|   (the float32 exactness
//               certificate: below 2**24 every partial sum is exact)
//   mins/maxs[b,c] over the lanes where x[b,v] > 0 (+-inf when none).
//
// Replaces the Pallas TPU kernel tail_reduce_grid
// (src/repro/kernels/reduce.py:59, reached through ops.py:169
// tail_reduce). The TPU version walks N as a sequential grid and carries
// its sums in VMEM from one step to the next; CUDA blocks run in no
// order, so here each block reduces one chunk of N for one query row
// (an in-block loop takes the place of the sequential grid) and writes a
// partial; a second kernel folds the partials in a fixed order, so the
// result does not depend on scheduling.
//
// C is 1 to 5 on the main path: this is not tensor-core work, and
// staying off the tensor cores also keeps TF32 (which would void the
// 2**24 certificate) out. Products and sums round separately, as in the
// plain version.
//
// What bounds it. Bytes: x once (B*N*4), vals once (C*N*4; every query
// row re-reads it from L2), outputs negligible. Operations: about
// 6*C + 1 per (b, v) in float32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                  // aggregate columns per block

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// grid (S, B, ceil(C / kCols)); partial [S, B, 1 + 4C] laid out as
// [cnt | sums[C] | sabs[C] | mins[C] | maxs[C]].
__global__ void __launch_bounds__(kThreads)
tail_reduce_partial(const float* __restrict__ x, const float* __restrict__ vals,
                    float* __restrict__ partial, int B, int N, int C, int chunk) {
  const int s = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * kCols;
  const int nc = min(kCols, C - c0);
  const int lo = s * chunk, hi = min(N, lo + chunk);
  float cnt = 0.0f, sum[kCols], sab[kCols], mn[kCols], mx[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    sum[j] = 0.0f; sab[j] = 0.0f; mn[j] = CUDART_INF_F; mx[j] = -CUDART_INF_F;
  }
  const float* xr = x + (long long)b * N;
  for (int v = lo + threadIdx.x; v < hi; v += kThreads) {
    const float xv = xr[v];
    cnt = __fadd_rn(cnt, xv);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j < nc) {
        const float a = vals[(long long)(c0 + j) * N + v];
        sum[j] = __fadd_rn(sum[j], __fmul_rn(xv, a));
        sab[j] = __fadd_rn(sab[j], __fmul_rn(xv, fabsf(a)));
        if (xv > 0.0f) { mn[j] = fminf(mn[j], a); mx[j] = fmaxf(mx[j], a); }
      }
    }
  }
  // block reduction in a fixed order: warps by shuffles, then warp 0
  __shared__ float red[kThreads / 32][1 + 4 * kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cnt = warp_sum(cnt);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    sum[j] = warp_sum(sum[j]); sab[j] = warp_sum(sab[j]);
    mn[j] = warp_min(mn[j]); mx[j] = warp_max(mx[j]);
  }
  if (lane == 0) {
    red[warp][0] = cnt;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      red[warp][1 + j] = sum[j]; red[warp][1 + kCols + j] = sab[j];
      red[warp][1 + 2 * kCols + j] = mn[j]; red[warp][1 + 3 * kCols + j] = mx[j];
    }
  }
  __syncthreads();
  const int slots = 1 + 4 * kCols;
  if (threadIdx.x < slots) {
    const int t = threadIdx.x;
    const int kind = t == 0 ? 0 : 1 + (t - 1) / kCols;   // 0 cnt,1 sum,2 sab,3 min,4 max
    float acc = red[0][t];
    for (int q = 1; q < kThreads / 32; ++q) {
      const float v = red[q][t];
      acc = kind == 3 ? fminf(acc, v) : kind == 4 ? fmaxf(acc, v) : __fadd_rn(acc, v);
    }
    float* out = partial + ((long long)s * B + b) * (1 + 4 * C);
    if (kind == 0) {
      if (blockIdx.z == 0) out[0] = acc;
    } else {
      const int j = (t - 1) % kCols;
      if (j < nc) out[1 + (kind - 1) * C + c0 + j] = acc;
    }
  }
}

// one thread per output slot: fold the S partials in order
__global__ void tail_reduce_final(const float* __restrict__ partial,
                                  float* __restrict__ out, int S, int B, int C) {
  const int slots = 1 + 4 * C;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * slots) return;
  const int t = (int)(i % slots);
  const int kind = t == 0 ? 0 : 1 + (t - 1) / C;
  float acc = kind == 3 ? CUDART_INF_F : kind == 4 ? -CUDART_INF_F : 0.0f;
  for (int s = 0; s < S; ++s) {
    const float v = partial[(long long)s * B * slots + i];
    acc = kind == 3 ? fminf(acc, v) : kind == 4 ? fmaxf(acc, v) : __fadd_rn(acc, v);
  }
  out[i] = acc;
}

}  // namespace

// x float32 [B, N], vals float32 [C, N]; partial float32 [S, B, 1 + 4C]
// scratch with S = ceil(N / chunk); out float32 [B, 1 + 4C] as
// [cnt | sums | sabs | mins | maxs]. Returns the cudaError_t of the
// launches.
extern "C" int tail_reduce_launch(const float* x, const float* vals,
                                  float* partial, float* out, int B, int N,
                                  int C, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (N + chunk - 1) / chunk;
  if (S > 0) {
    const dim3 grid(S, B, C > 0 ? (C + kCols - 1) / kCols : 1);
    tail_reduce_partial<<<grid, kThreads, 0, st>>>(x, vals, partial, B, N, C, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)B * (1 + 4 * C);
  tail_reduce_final<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(partial, out, S, B, C);
  return (int)cudaGetLastError();
}
