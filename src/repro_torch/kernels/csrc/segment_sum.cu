// Sorted-segment sum: GRAPE's `sum` message combiner.
//
// Replaces the Pallas TPU kernel segment_sum_sorted
// (src/repro/kernels/segment_sum.py:42) behind ops.segment_sum
// (src/repro/kernels/ops.py:149).
//
//   y[s] = sum of vals[e] over the entries e with segs[e] == s,  0 <= s < n_out
//
// segs is sorted ascending; entries with segs < 0 (padding, sorted to the
// front) belong to no segment and are dropped.
//
// Design. The TPU kernel one-hot reduces each 512-entry tile into a
// 1,024-wide output window and carries the output across its sequential
// grid; that window, its padding of E and its unsorted fallback are TPU
// matters and are not carried over. Here one warp owns one output
// segment: lanes 0 and 1 binary-search the segment's [lo, hi) in segs,
// the lanes stride the range (each lane adds its entries in ascending
// order, eight loads in flight before the adds), then a fixed
// butterfly of shuffles sums the 32 lane totals. No atomics: every run
// gives the same bits, and each output is written once.
//
// Precision. The sums are carried in float64 and rounded to float32 once,
// at the end. A float32 running sum over the hub segment (430,193 entries
// of the full-width store, about 13,400 a lane) drifts by about 1e-5 of
// the segment's total; in float64 the result is the float32 rounding of
// the exact sum up to one unit in the last place, as the plain version's
// (which also accumulates in float64) is. Hopper runs float64 adds at
// half the float32 rate, and the kernel is bound by memory.
//
// What bounds it. Bytes: segs and vals read once (8 bytes an entry), y
// written once. A warp per segment is unbalanced on power-law graphs: the
// hub segment of the full-width store (430,193 in-edges into vertex 0)
// runs on one warp while the rest finish; a later PR splits long
// segments across warps.
//
// Exactness. On integer values below 2**24 every order gives the plain
// version's bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                  // warps (segments) per block
constexpr int kInFlight = 8;               // loads in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// first index e in [0, E) with segs[e] >= key (E if none)
__device__ long long lower_bound(const int* __restrict__ segs, long long E,
                                 int key) {
  long long lo = 0, hi = E;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (segs[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ vals,
                   const int* __restrict__ segs, float* __restrict__ y,
                   long long E, int n_out) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_out) return;                  // whole warp leaves together
  // lane 0 finds the segment's start, lane 1 its end
  const long long b = lower_bound(segs, E, s + (lane & 1));
  const long long lo = __shfl_sync(kFull, b, 0);
  const long long hi = __shfl_sync(kFull, b, 1);
  double acc = 0.0;
  for (long long base = lo; base < hi; base += 32 * kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const long long e = base + lane + 32 * k;
      v[k] = e < hi ? vals[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      acc = __dadd_rn(acc, (double)v[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __dadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) y[s] = __double2float_rn(acc);
}

}  // namespace

// vals float32 [E], segs int32 [E] sorted ascending (negative = dropped),
// y float32 [n_out] (every element written). Returns the cudaError_t of
// the launch.
extern "C" int segment_sum_launch(const float* vals, const int* segs,
                                  float* y, long long E, int n_out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_out == 0) return 0;
  const dim3 grid((unsigned)((n_out + kWarps - 1) / kWarps));
  segment_sum_kernel<<<grid, kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(vals, segs, y,
                                                            E, n_out);
  return (int)cudaGetLastError();
}
