// Plain MHA/GQA flash decode over a dense KV cache, for Hopper: the MHA
// baseline's decode attention (CHAI off) on the dense layouts.
//
// Replaces repro/kernels/flash_attention.py: flash_decode (the Pallas TPU
// kernel, body _decode_kernel; grid (B, H, S / ts) with the online softmax
// carried in VMEM scratch along the sequential S-tile axis). Output:
// (B, H, hd) fp32. The block body lives in decode_tiles.cuh, shared with
// the paged kernel, which stays bitwise equal to this one at ts == page.
//
// What bounds it: device memory. Per (b, KV group) it must read the K and
// V rows of the positions 0..pos (pos - window + 1..pos with a window)
// once. Design: a block is (KV group with up to 2 of its query heads, S
// split, b), so a K/V row is read once per group, not once per head, and
// the S axis is cut into the whole-tile ranges of the host's split plan
// (sixteen blocks per SM aimed at, none shorter than four tiles) merged in
// split order inside the launch (decode_tiles.cuh). The first port had
// one block per (group, b): 128 blocks for chai-llama-7b at B = 4, only
// 32 for nemotron-4-15b, each holding too few bytes in flight for the
// card's bandwidth. A loop over the block's range takes the place of the
// TPU's sequential grid axis, in chunks of 64 positions, so no whole row
// of scores is kept.

#include "decode_tiles.cuh"

namespace {

using namespace flashdec;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  float* out;
  float* mp;
  float* lp;
  float* accp;
  int* counter;
  int H, KV, S, hd, window, hb, n_hb, q_bf16;
  Plan plan;
  float scale;
};

template <typename T, int kH, int kHdMax>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Args a) {
  const int b = blockIdx.z, s = blockIdx.y, qpk = a.H / a.KV;
  const int g = blockIdx.x / a.n_hb, j0 = (blockIdx.x - g * a.n_hb) * a.hb;
  const int h0 = g * qpk + j0, nh = min(a.hb, qpk - j0);
  const size_t row0 = (static_cast<size_t>(b) * a.KV + g) * a.S * a.hd;
  const DenseRows<T> rows{static_cast<const T*>(a.k) + row0,
                          static_cast<const T*>(a.v) + row0, a.hd};
  const size_t qo = (static_cast<size_t>(b) * a.H + h0) * a.hd;
  const void* qb = a.q_bf16
      ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(a.q) + qo)
      : static_cast<const void*>(static_cast<const float*>(a.q) + qo);
  const size_t p0 = static_cast<size_t>(b) * a.plan.n_split * a.H + h0;
  const Partials part{
      a.mp ? a.mp + p0 : nullptr, a.lp ? a.lp + p0 : nullptr,
      a.accp ? a.accp + p0 * a.hd : nullptr, a.H,
      a.counter ? a.counter + static_cast<size_t>(b) * gridDim.x + blockIdx.x
                : nullptr};
  decode_block<T, kH, kHdMax>(rows, qb, a.q_bf16, a.pos[b], a.plan, s,
                              a.window, nh, a.hd, a.scale, part,
                              a.out + qo);
}

template <typename T>
struct Launch {
  Args a;
  int B;
  cudaStream_t stream;
  template <int kH, int kHdMax>
  int run() const {
    dim3 grid(a.KV * a.n_hb, a.plan.n_split, B);
    flash_decode_kernel<T, kH, kHdMax><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

// The static shared memory of the kernel serving hb heads a block.
struct SmemOf {
  template <int kH, int kHdMax>
  int run() const {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr,
                              flash_decode_kernel<__nv_bfloat16, kH, kHdMax>)
        != cudaSuccess)
      return -1;
    return static_cast<int>(attr.sharedSizeBytes);
  }
};

}  // namespace

// q: (B, H, hd) fp32 (q_bf16 == 0) or bf16; k, v: (B, KV, S, hd), fp32
// (kv_bf16 == 0) or bf16; pos: (B,) int32; out: (B, H, hd) fp32. All
// contiguous and 16-byte aligned; H % KV == 0; hd % 8 == 0, hd <= 320 (the
// instance of kHdMax 256 up to 256, the wide one of 320 above);
// the tile ts divides S. Head h reads KV row h / (H / KV); each
// block serves hb (1 or 2) heads of one group, n_hb blocks per group. The
// split plan: n_split (<= 64) ranges of ``tps`` tiles; with n_split > 1
// the scratch mp, lp (B, n_split, H), accp (B, n_split, H, hd) fp32 and
// counter (B * KV * n_hb) int32, all zero, are needed (the merge leaves
// the counters at zero again); with n_split == 1 they may be null. window
// > 0 masks positions idx <= pos - window. Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   void* mp, void* lp, void* accp,
                                   void* counter, int B, int H, int KV,
                                   int S, int hd, int ts, int window,
                                   int hb, int n_split, int tps, int q_bf16,
                                   int kv_bf16, void* stream) {
  const int n_hb = (H / KV + hb - 1) / hb;
  const Args a{q, k, v, static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), H, KV, S, hd, window, hb, n_hb,
               q_bf16, Plan{n_split, tps, S / ts, ts},
               inv_sqrt_hd(hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return with_heads(hb, hd, Launch<__nv_bfloat16>{a, B, st});
  return with_heads(hb, hd, Launch<float>{a, B, st});
}

// The static shared memory of one block serving hb heads of head dim hd
// (the instance that head dim takes), in bytes (-1 on error), for a check
// that the host's mirror (kernels/flash_attention.py:
// decode_block_smem_bytes) agrees.
extern "C" int flash_decode_smem_bytes(int hb, int hd) {
  return with_heads(hb, hd, SmemOf{});
}
