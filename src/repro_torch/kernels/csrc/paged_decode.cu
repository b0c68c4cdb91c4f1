// Plain MHA/GQA flash decode over one shared K/V page pool read through
// block tables, for Hopper: the MHA baseline's decode attention (CHAI off)
// on the continuous engine's paged layout, the engine default.
//
// Replaces repro/kernels/flash_attention.py: paged_decode (the Pallas TPU
// kernel, body _paged_decode_kernel; its BlockSpec index maps read the
// scalar-prefetched block tables, one page per grid step). Same function
// as the dense kernel with position idx of batch row b in page
// bt_k[b, idx / page] (K) or bt_v[b, idx / page] (V) of the one pool, at
// row idx % page. Null table entries name page 0; they sit past pos and
// are never read. The block body is decode_tiles.cuh's decode_block, the
// dense kernel's own, so the two are bitwise equal when the dense tile
// equals the page.
//
// What bounds it: device memory, as for the dense kernel: the K and V
// rows of the live positions of each (b, KV group), once, plus the table
// entries of their pages. Design: the dense kernel's (one block per (KV
// group, b), all the group's heads in it), reading the pool in place: the
// block reads a step's page id from the table once per step, so no
// densifying gather of the pool runs, and the table is not staged in
// shared memory (no cap on the number of pages).

#include "decode_tiles.cuh"

namespace {

using namespace flashdec;

template <typename T, int kH>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const void* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ bt_k,
                    const int* __restrict__ bt_v,
                    const int* __restrict__ pos, float* __restrict__ out,
                    int H, int KV, int P, int page, int hd, int step,
                    int window, int hb, int n_hb, int q_bf16, float scale) {
  const int b = blockIdx.y, qpk = H / KV;
  const int g = blockIdx.x / n_hb, j0 = (blockIdx.x - g * n_hb) * hb;
  const int h0 = g * qpk + j0, nh = min(hb, qpk - j0);
  const PagedRows<T> rows{pool, bt_k + static_cast<size_t>(b) * P,
                          bt_v + static_cast<size_t>(b) * P, KV, g, page,
                          hd};
  const size_t qo = (static_cast<size_t>(b) * H + h0) * hd;
  const void* qb = q_bf16
      ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(q) + qo)
      : static_cast<const void*>(static_cast<const float*>(q) + qo);
  decode_block<T, kH>(rows, qb, q_bf16, pos[b], P * page, step, window, nh,
                      hd, scale, out + qo);
}

template <typename T>
struct Launch {
  const void* q;
  const void* pool;
  const void* bt_k;
  const void* bt_v;
  const void* pos;
  void* out;
  int B, H, KV, P, page, hd, step, window, hb, n_hb, q_bf16;
  cudaStream_t stream;
  template <int kH>
  int run() const {
    dim3 grid(KV * n_hb, B);
    paged_decode_kernel<T, kH><<<grid, kThreads, 0, stream>>>(
        q, static_cast<const T*>(pool), static_cast<const int*>(bt_k),
        static_cast<const int*>(bt_v), static_cast<const int*>(pos),
        static_cast<float*>(out), H, KV, P, page, hd, step, window, hb,
        n_hb, q_bf16, inv_sqrt_hd(hd));
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, H, hd) fp32 (q_bf16 == 0) or bf16; pool: (nP, KV, page, hd),
// fp32 (kv_bf16 == 0) or bf16; bt_k, bt_v: (B, P) int32 page ids into the
// pool; pos: (B,) int32; out: (B, H, hd) fp32. All contiguous and 16-byte
// aligned; H % KV == 0; hd % 8 == 0, hd <= 256; ``step`` (the
// online-softmax step: the page, or a divisor of it) <= 128. Head h reads
// KV row h / (H / KV); each block serves hb (<= 8) heads of one group.
// window > 0 masks positions idx <= pos - window. Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int paged_decode_launch(const void* q, const void* pool,
                                   const void* bt_k, const void* bt_v,
                                   const void* pos, void* out, int B, int H,
                                   int KV, int P, int page, int hd, int step,
                                   int window, int hb, int q_bf16,
                                   int kv_bf16, void* stream) {
  const int n_hb = (H / KV + hb - 1) / hb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return with_heads(hb, Launch<__nv_bfloat16>{
        q, pool, bt_k, bt_v, pos, out, B, H, KV, P, page, hd, step, window,
        hb, n_hb, q_bf16, st});
  return with_heads(hb, Launch<float>{q, pool, bt_k, bt_v, pos, out, B, H,
                                      KV, P, page, hd, step, window, hb,
                                      n_hb, q_bf16, st});
}
