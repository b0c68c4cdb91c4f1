// One-pass fused clustered decode (CHAI STEADY attention) over block-table
// page pools, for Hopper: the continuous engine's paged STEADY decode.
//
// Replaces repro/kernels/chai_attention.py: paged_chai_fused_decode (the
// Pallas TPU kernel; its BlockSpec index maps read the scalar-prefetched
// block tables, one page per grid step). Same function as the dense kernel
// with tile t of batch row b located at page bt_k[b, t] of the K pool
// (the clustered pool, k_max rows) and page bt_v[b, t] of the V pool (the
// dense per-head pool): K and V take different tables. The tile size is
// the page. The block body is chai_decode_tiles.cuh's decode_block, the
// dense kernel's own, so the two are bitwise equal when the dense tile
// equals the page.
//
// What bounds it: device memory, as for the dense kernel: the K rows of
// reps that have members and every head's V row, only the pages up to pos.
// Design: the dense kernel's (one block per (b, rep)), plus the row's two
// block-table rows copied into shared memory once per block, so every
// tile address is one shared-memory read away. Only pages t <= pos / page
// are read, and every entry of a block table is a page id the engine
// allocated or the null page 0, so the mixed step's rows that are not
// STEADY (a WARMUP row's K table is all null page 0; a FREE row has pos 0)
// read in-bounds pages only; their outputs are discarded by the caller.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_chai_fused_decode_kernel(const float* __restrict__ q,
                               const T* __restrict__ k_pool,
                               const T* __restrict__ v_pool,
                               const int* __restrict__ bt_k,
                               const int* __restrict__ bt_v,
                               const int* __restrict__ h2c,
                               const int* __restrict__ pos,
                               float* __restrict__ out, int R, int H,
                               int kv_k, int kv_v, int P, int page, int hd,
                               int rpg, int v_rep, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  int* bt_s = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) +
                                     block_smem_bytes(hd, P, page, H));
  for (int t = threadIdx.x; t < P; t += kThreads) {
    bt_s[t] = bt_k[static_cast<size_t>(b) * P + t];
    bt_s[P + t] = bt_v[static_cast<size_t>(b) * P + t];
  }
  // decode_block's first barrier orders these writes before any tile read.
  const PagedTiles<T> tiles{k_pool, v_pool, bt_s, bt_s + P, kv_k, kv_v,
                            page, hd};
  decode_block<T>(tiles, q, h2c, pos, out, R, H, P, page, hd, rpg, v_rep,
                  window, scale, smem);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* bt_k, const void* bt_v, const void* h2c,
           const void* pos, void* out, int B, int R, int H, int kv_k,
           int kv_v, int P, int page, int hd, int rpg, int v_rep, int window,
           cudaStream_t stream) {
  const size_t smem = block_smem_bytes(hd, P, page, H) +
                      2 * static_cast<size_t>(P) * sizeof(int);
  auto kern = paged_chai_fused_decode_kernel<T>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(R, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(bt_k),
      static_cast<const int*>(bt_v), static_cast<const int*>(h2c),
      static_cast<const int*>(pos), static_cast<float*>(out), R, H, kv_k,
      kv_v, P, page, hd, rpg, v_rep, window, inv_sqrt_hd(hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, R, hd) fp32; k_pool: (nPk, kv_k, page, hd); v_pool:
// (nPv, kv_v, page, hd), both fp32 (kv_bf16 == 0) or bf16 (kv_bf16 == 1);
// bt_k, bt_v: (B, P) int32 page ids into their pools; h2c: (B, H) int32
// with values in [0, R); pos: (B,) int32; out: (B, H, hd) fp32. All
// contiguous; hd even and the pools aligned to two elements. Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int paged_chai_fused_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* bt_k,
    const void* bt_v, const void* h2c, const void* pos, void* out, int B,
    int R, int H, int kv_k, int kv_v, int P, int page, int hd, int rpg,
    int v_rep, int window, int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, bt_k, bt_v, h2c, pos,
                                 out, B, R, H, kv_k, kv_v, P, page, hd, rpg,
                                 v_rep, window, st);
  return launch<float>(q, k_pool, v_pool, bt_k, bt_v, h2c, pos, out, B, R,
                       H, kv_k, kv_v, P, page, hd, rpg, v_rep, window, st);
}
