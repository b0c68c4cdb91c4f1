// Broadcast-and-accumulate of the normalized clustered scores, the last
// stage of the three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_av and paged_chai_av (two
// Pallas TPU kernels with one body: a (B, H, S/ts) grid whose last axis
// carries an fp32 accumulator in VMEM scratch; the A BlockSpec reads row
// h2c[b, h], the V BlockSpec the dense tile or the block table's page).
// Output: (B, H, hd) fp32, out[b, h] = sum over ALL s of
// A[b, h2c[b, h], s] * V[b, h, s]. Neither kernel takes pos: A is zero
// past pos only because the softmax made it so, and no cut is added here.
//
// What bounds it: device memory: every head's V row over all S (B * H *
// S * hd elements) and its A row, each read once, and the (B, H, hd)
// output written. Design: no carry between blocks, so the TPU's
// sequential S axis becomes a loop inside the block. One block of 256
// threads per (b, h): each of its eight warps takes every eighth
// position, its lanes the output pairs (d, d + 1) of that V row
// (coalesced paired loads, the A value a broadcast read), accumulating
// in fp32 registers; the eight partial sums meet in shared memory. The
// paged locator reads bt_v[b, s / page] itself (the V page of head h).
// Splitting S across blocks, to fill the 132 SMs at small B * H, is left
// for later work.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

constexpr int kAvThreads = 256;
constexpr int kAvWarps = kAvThreads / 32;

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Dense V cache (B, H, S, hd).
template <typename T>
struct DenseV {
  const T* v;
  int h, s, hd;
  __device__ const T* row(int b, int hh, int i) const {
    return v + ((static_cast<size_t>(b) * h + hh) * s + i) * hd;
  }
};

// V page pool (nP, H, page, hd) through the block table bt (B, P).
template <typename T>
struct PagedV {
  const T* v;
  const int* bt;
  int h, page, hd, n_pages;
  __device__ const T* row(int b, int hh, int i) const {
    const int pg = bt[static_cast<size_t>(b) * n_pages + i / page];
    return v + ((static_cast<size_t>(pg) * h + hh) * page + i % page) * hd;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kAvThreads)
av_kernel(const float* __restrict__ a, const Rows rows,
          const int* __restrict__ h2c, float* __restrict__ out, int R,
          int H, int S, int hd) {
  extern __shared__ float2 part[];                 // kAvWarps * hd / 2
  const int hh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = hd / 2;
  const int a_row = h2c[static_cast<size_t>(b) * H + hh];
  const float* ar = a + (static_cast<size_t>(b) * R + a_row) * S;
  for (int d2 = lane; d2 < pairs; d2 += 32) {
    float2 acc = make_float2(0.f, 0.f);
    for (int s = warp; s < S; s += kAvWarps) {
      const float p = ar[s];
      const float2 vv = load_pair(rows.row(b, hh, s) + 2 * d2);
      acc.x += p * vv.x;
      acc.y += p * vv.y;
    }
    part[warp * pairs + d2] = acc;
  }
  __syncthreads();
  float* o = out + (static_cast<size_t>(b) * H + hh) * hd;
  for (int d2 = threadIdx.x; d2 < pairs; d2 += kAvThreads) {
    float2 sum = part[d2];
    for (int w = 1; w < kAvWarps; ++w) {
      sum.x += part[w * pairs + d2].x;
      sum.y += part[w * pairs + d2].y;
    }
    o[2 * d2] = sum.x;
    o[2 * d2 + 1] = sum.y;
  }
}

template <typename T, typename Rows>
int launch(const void* a, const Rows& rows, const void* h2c, void* out,
           int B, int R, int H, int S, int hd, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kAvWarps) * hd / 2 *
                      sizeof(float2);
  auto kern = av_kernel<T, Rows>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B);
  kern<<<grid, kAvThreads, smem, stream>>>(
      static_cast<const float*>(a), rows, static_cast<const int*>(h2c),
      static_cast<float*>(out), R, H, S, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (B, R, S) fp32; v: (B, H, S, hd) fp32 (v_bf16 == 0) or bf16
// (v_bf16 == 1); h2c: (B, H) int32 with values in [0, R); out: (B, H, hd)
// fp32. hd even and v aligned to two elements; all contiguous. Returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int chai_av_launch(const void* a, const void* v, const void* h2c,
                              void* out, int B, int R, int H, int S, int hd,
                              int v_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (v_bf16)
    return launch<__nv_bfloat16>(
        a, DenseV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(v), H, S,
                                 hd},
        h2c, out, B, R, H, S, hd, st);
  return launch<float>(a, DenseV<float>{static_cast<const float*>(v), H, S,
                                        hd},
                       h2c, out, B, R, H, S, hd, st);
}

// As chai_av_launch over a V page pool v_pool: (nP, H, page, hd) read
// through the block table bt_v: (B, P) int32; a: (B, R, P * page). Every
// table entry must name a page of the pool (the null page 0 included).
extern "C" int paged_chai_av_launch(const void* a, const void* v_pool,
                                    const void* bt_v, const void* h2c,
                                    void* out, int B, int R, int H, int P,
                                    int page, int hd, int v_bf16,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(bt_v);
  if (v_bf16)
    return launch<__nv_bfloat16>(
        a, PagedV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(v_pool),
                                 bt, H, page, hd, P},
        h2c, out, B, R, H, P * page, hd, st);
  return launch<float>(
      a, PagedV<float>{static_cast<const float*>(v_pool), bt, H, page, hd,
                       P},
      h2c, out, B, R, H, P * page, hd, st);
}
