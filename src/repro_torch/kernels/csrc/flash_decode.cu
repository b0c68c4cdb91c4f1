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
// once. Design: one block per (KV group, b) serving all H / KV query
// heads of the group (up to 8 per block), so a K/V row is read once per
// group, not once per head; a loop over the S axis takes the place of the
// TPU's sequential grid axis, in chunks of 128 positions, so nothing
// carries between blocks and no whole row of scores is kept. At B = 4 the
// grid is 4 * KV blocks: 128 for chai-llama-7b (KV = 32), only 32 for
// nemotron-4-15b (KV = 8), which underfills the 132 SMs; splitting S
// across blocks with a merge of (m, l, acc), TMA and wgmma are left for
// later work.

#include "decode_tiles.cuh"

namespace {

using namespace flashdec;

template <typename T, int kH>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const void* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    float* __restrict__ out, int H, int KV, int S, int hd,
                    int step, int window, int hb, int n_hb, int q_bf16,
                    float scale) {
  const int b = blockIdx.y, qpk = H / KV;
  const int g = blockIdx.x / n_hb, j0 = (blockIdx.x - g * n_hb) * hb;
  const int h0 = g * qpk + j0, nh = min(hb, qpk - j0);
  const size_t row0 = (static_cast<size_t>(b) * KV + g) * S * hd;
  const DenseRows<T> rows{k + row0, v + row0, hd};
  const size_t qo = (static_cast<size_t>(b) * H + h0) * hd;
  const void* qb = q_bf16
      ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(q) + qo)
      : static_cast<const void*>(static_cast<const float*>(q) + qo);
  decode_block<T, kH>(rows, qb, q_bf16, pos[b], S, step, window, nh, hd,
                      scale, out + qo);
}

template <typename T>
struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const void* pos;
  void* out;
  int B, H, KV, S, hd, step, window, hb, n_hb, q_bf16;
  cudaStream_t stream;
  template <int kH>
  int run() const {
    dim3 grid(KV * n_hb, B);
    flash_decode_kernel<T, kH><<<grid, kThreads, 0, stream>>>(
        q, static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(pos), static_cast<float*>(out), H, KV, S,
        hd, step, window, hb, n_hb, q_bf16, inv_sqrt_hd(hd));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, H, hd) fp32 (q_bf16 == 0) or bf16; k, v: (B, KV, S, hd), fp32
// (kv_bf16 == 0) or bf16; pos: (B,) int32; out: (B, H, hd) fp32. All
// contiguous and 16-byte aligned; H % KV == 0; hd % 8 == 0, hd <= 256;
// ``step`` (the online-softmax step: the tile ts, or a divisor of it) <=
// 128 divides S. Head h reads KV row h / (H / KV); each block serves hb
// (<= 8) heads of one group, n_hb blocks per group. window > 0 masks
// positions idx <= pos - window. Returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   int B, int H, int KV, int S, int hd,
                                   int step, int window, int hb, int q_bf16,
                                   int kv_bf16, void* stream) {
  const int n_hb = (H / KV + hb - 1) / hb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return with_heads(hb, Launch<__nv_bfloat16>{
        q, k, v, pos, out, B, H, KV, S, hd, step, window, hb, n_hb, q_bf16,
        st});
  return with_heads(hb, Launch<float>{q, k, v, pos, out, B, H, KV, S, hd,
                                      step, window, hb, n_hb, q_bf16, st});
}
