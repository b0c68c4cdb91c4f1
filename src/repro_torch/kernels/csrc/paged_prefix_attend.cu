// A prefill chunk's queries over the pages that earlier chunks wrote, for
// Hopper.
//
// Replaces repro/kernels/flash_attention.py: paged_prefix_attend (the Pallas
// TPU kernel; grid (B, H, T/tq, P) with the logical-page axis sequential,
// scalar-prefetched block tables driving the K/V index maps, pages past the
// prefix redirected to the null page 0 and skipped). Every query attends
// every cached position < plen[b], with no causal mask (all of them precede
// the chunk). K and V are distinct pages of one pool (nP, KV, page, hd),
// reached through two block tables; head h reads KV head h / (H / KV). The
// output is the head-major online-softmax state m, l (B, H, T) and acc
// (B, H, T, hd) in fp32, merged with flash_prefill's state over the chunk
// itself. A row with plen == 0 reads no page and writes the exact merge
// identity (m = -2e38, l = 0, acc = 0).
//
// What bounds it: the prefix's K and V pages, read once (at a chunk of 128
// queries over 384 cached positions, 32 heads of 128 in bf16: ~6.3 MB of
// pages beside ~1 MB of queries and ~2 MB of fp32 state), so device memory.
// Design: flash_prefill's block (16 query rows of one head) and tile steps
// (flash_tiles.cuh), with the key tile gathered row by row (16-byte loads)
// through the batch row's two block tables, so only positions < plen are read:
// whole pages up to the last one, which is masked at plen inside the page.
// The block reads the tables itself; nothing is densified.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T>
struct PagedRows {                 // pool (nP, KV, page, hd)
  const T* pool;
  const int* bt_k;                 // the batch row's P entries
  const int* bt_v;
  int kv_k, kvh, page, hd;
  __device__ const T* row(const int* bt, int j) const {
    const int lp = j / page;
    return pool + ((static_cast<size_t>(bt[lp]) * kv_k + kvh) * page +
                   (j - lp * page)) * hd;
  }
  __device__ const T* krow(int j) const { return row(bt_k, j); }
  __device__ const T* vrow(int j) const { return row(bt_v, j); }
};

struct AllVisible {                // positions past plen never enter a tile
  __device__ bool operator()(int, int) const { return true; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefix_attend_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                           const int* __restrict__ bt_k,
                           const int* __restrict__ bt_v,
                           const int* __restrict__ plen,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out, int n_q, int H,
                           int KV, int P, int page, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Tile<HD> sm(smem);
  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z;
  // plen past the table is cut to the table's positions, as the TPU grid
  // over P pages does.
  const int n_keys = max(0, min(plen[b], P * page));
  load_queries<T, HD>(sm, q, b, h, q0, n_q, H);
  const PagedRows<T> rows{pool, bt_k + static_cast<size_t>(b) * P,
                          bt_v + static_cast<size_t>(b) * P, KV,
                          h / (H / KV), page, HD};
  float acc[Acc<HD>::kSlots];
#pragma unroll
  for (int i = 0; i < Acc<HD>::kSlots; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < n_keys; k0 += kTs) {
    load_keys<T, HD>(sm, rows, k0, min(kTs, n_keys - k0));
    __syncthreads();
    attend_tile<HD>(sm, min(kTs, n_keys - k0), AllVisible{}, scale, acc);
  }
  __syncthreads();
  store_rows<T, HD>(sm, acc, b, h, q0, n_q, H, nullptr, m_out, l_out,
                    acc_out);
}

template <typename T>
int launch(const void* q, const void* pool, const void* bt_k,
           const void* bt_v, const void* plen, void* m_out, void* l_out,
           void* acc_out, int B, int n_q, int H, int KV, int P, int page,
           int hd, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = Tile<HD>::bytes();
    auto kern = paged_prefix_attend_kernel<T, HD>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n_q + kTq - 1) / kTq, H, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(pool),
        static_cast<const int*>(bt_k), static_cast<const int*>(bt_v),
        static_cast<const int*>(plen), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(acc_out), n_q, H,
        KV, P, page, inv_sqrt_hd(HD));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q: (B, n_q, H, hd); pool: (nP, KV, page, hd), both fp32 (bf16 == 0) or
// bf16 (bf16 == 1); bt_k, bt_v: (B, P) int32 page ids into the pool; plen:
// (B,) int32 cached positions; m_out, l_out: (B, H, n_q) and acc_out:
// (B, H, n_q, hd) fp32. All contiguous and 16-byte aligned; H % KV == 0,
// hd a power of two from 8 to 256 (else cudaErrorInvalidValue). Returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int paged_prefix_attend_launch(const void* q, const void* pool,
                                          const void* bt_k, const void* bt_v,
                                          const void* plen, void* m_out,
                                          void* l_out, void* acc_out, int B,
                                          int n_q, int H, int KV, int P,
                                          int page, int hd, int bf16,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, pool, bt_k, bt_v, plen, m_out, l_out,
                                 acc_out, B, n_q, H, KV, P, page, hd, st);
  return launch<float>(q, pool, bt_k, bt_v, plen, m_out, l_out, acc_out, B,
                       n_q, H, KV, P, page, hd, st);
}
