// Masked softmax of each (b, rep) row of the raw clustered scores, the
// second stage of the three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: row_softmax (the Pallas TPU
// kernel: one (b, rep) row of S scores per grid step, whole in VMEM).
// Output: (B, R, S) fp32, y = p / max(sum(p), 1e-37) with p = exp(x - m)
// and m = max(max(x), -1e30). A row masked everywhere (every entry
// -2e38) gives m = -1e30, p = exp(-2e38 + 1e30) = 0 and so all zeros, not
// NaN. expf and IEEE division (no fast math).
//
// What bounds it: device memory: one read and one write of the (B, R, S)
// fp32 row tensor. Design: one block of 256 threads per row, looping
// over S to any length with coalesced loads; the maximum and the sum are
// block reductions (warp shuffles, then one value per warp in shared
// memory). The row is read three times (max, sum, write), from L2 after
// the first pass for the rows of a decode step (a 1024-position row is 4
// KB); keeping it in registers or shared memory would read it once.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

constexpr int kSoftmaxThreads = 256;
constexpr int kSoftmaxWarps = kSoftmaxThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reduction of one value per thread; every thread gets the
// result. ``red`` holds one value per warp.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kSoftmaxWarps; ++w)
    r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();                       // red is reused by the next call
  return r;
}

__global__ void __launch_bounds__(kSoftmaxThreads)
row_softmax_kernel(const float* __restrict__ x, float* __restrict__ y,
                   int S) {
  __shared__ float red[kSoftmaxWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * S;
  const float* xr = x + base;
  float* yr = y + base;
  float mx = kNegInf;
  for (int i = threadIdx.x; i < S; i += kSoftmaxThreads)
    mx = fmaxf(mx, xr[i]);
  const float m = fmaxf(block_reduce<true>(mx, red), -1e30f);
  float sum = 0.f;
  for (int i = threadIdx.x; i < S; i += kSoftmaxThreads)
    sum += expf(xr[i] - m);
  const float l = fmaxf(block_reduce<false>(sum, red), 1e-37f);
  for (int i = threadIdx.x; i < S; i += kSoftmaxThreads)
    yr[i] = expf(xr[i] - m) / l;
}

}  // namespace

// x, y: (rows, S) fp32, contiguous (rows = B * R). Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int row_softmax_launch(const void* x, void* y, int rows, int S,
                                  void* stream) {
  row_softmax_kernel<<<rows, kSoftmaxThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), S);
  return static_cast<int>(cudaGetLastError());
}
