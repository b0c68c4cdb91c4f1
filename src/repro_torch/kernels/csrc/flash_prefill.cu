// Causal flash attention over a prefill chunk, for Hopper.
//
// Replaces repro/kernels/flash_attention.py: flash_prefill (the Pallas TPU
// kernel; grid (B, H, T/tq, S/ts) with the kv-tile axis sequential and the
// online-softmax state in VMEM scratch). Queries at absolute positions
// offset + t attend keys 0 .. S-1 with key <= query; head h reads KV head
// h / (H / KV) (GQA). The output is either finalized, (B, T, H, hd) in the
// input dtype, or the head-major online-softmax state m, l (B, H, T) and
// acc (B, H, T, hd) in fp32, which the chunked prefill merges with
// paged_prefix_attend's state over the earlier chunks.
//
// What bounds it: at a chunk of T = 128 queries the work is small (q, k, v
// and the output are ~1 MB each in bf16 at 32 heads of 128), so the least
// time is the bytes over device memory. Design: one block per (query tile
// of 16 rows, head, batch row); the Pallas kv-tile axis is a loop inside
// the block over 64-key tiles staged in shared memory (flash_tiles.cuh),
// stopping at the block's causal edge, so tiles wholly above the diagonal
// are never read. T and S need not be multiples of the tiles: rows and keys
// past the edges are masked in the kernel. The offset is read from device
// memory, so a traced start position costs no host sync.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T>
struct DenseRows {                 // k, v: (B, S, KV, hd)
  const T* k;
  const T* v;
  size_t base;                     // element offset of (b, key 0, kv head)
  int stride;                      // elements between consecutive keys
  __device__ const T* krow(int j) const {
    return k + base + static_cast<size_t>(j) * stride;
  }
  __device__ const T* vrow(int j) const {
    return v + base + static_cast<size_t>(j) * stride;
  }
};

struct CausalMask {                // absolute positions: key <= query
  int q_first;                     // position of the block's row 0
  int k0;                          // position of the tile's key 0
  __device__ bool operator()(int r, int j) const {
    return k0 + j <= q_first + r;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ offset,
                     T* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ acc_out,
                     int n_q, int S, int H, int KV, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Tile<HD> sm(smem);
  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = offset[0];
  load_queries<T, HD>(sm, q, b, h, q0, n_q, H);
  // The block's last real query sits at off + min(q0 + kTq, n_q) - 1: key
  // tiles past it are masked for every row and would leave the state
  // bitwise unchanged.
  const int q_last = off + min(q0 + kTq, n_q) - 1;
  const int n_tiles =
      q_last < 0 ? 0 : min((S + kTs - 1) / kTs, q_last / kTs + 1);
  const DenseRows<T> rows{k, v,
                          (static_cast<size_t>(b) * S * KV + kvh) * HD,
                          KV * HD};
  float acc[Acc<HD>::kSlots];
#pragma unroll
  for (int i = 0; i < Acc<HD>::kSlots; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTs;
    load_keys<T, HD>(sm, rows, k0, min(kTs, S - k0));
    __syncthreads();
    attend_tile<HD>(sm, min(kTs, S - k0), CausalMask{off + q0, k0}, scale,
                    acc);
  }
  __syncthreads();
  store_rows<T, HD>(sm, acc, b, h, q0, n_q, H, out, m_out, l_out, acc_out);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* offset,
           void* out, void* m_out, void* l_out, void* acc_out, int B,
           int n_q, int S, int H, int KV, int hd, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = Tile<HD>::bytes();
    auto kern = flash_prefill_kernel<T, HD>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n_q + kTq - 1) / kTq, H, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(offset),
        static_cast<T*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(acc_out), n_q, S, H,
        KV, inv_sqrt_hd(HD));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q: (B, n_q, H, hd); k, v: (B, S, KV, hd), all fp32 (bf16 == 0) or bf16
// (bf16 == 1), contiguous; offset: (1,) int32, the position of query 0.
// emit_state == 0: out (B, n_q, H, hd) in the input dtype, m_out, l_out and
// acc_out unused; emit_state == 1: m_out, l_out (B, H, n_q) and acc_out
// (B, H, n_q, hd) fp32, out unused. H % KV == 0, hd a power of two from
// 8 to 256 (else cudaErrorInvalidValue), every tensor 16-byte aligned.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* offset,
                                    void* out, void* m_out, void* l_out,
                                    void* acc_out, int B, int n_q, int S,
                                    int H, int KV, int hd, int emit_state,
                                    int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emit_state) out = nullptr;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, offset, out, m_out, l_out, acc_out,
                                 B, n_q, S, H, KV, hd, st);
  return launch<float>(q, k, v, offset, out, m_out, l_out, acc_out, B, n_q,
                       S, H, KV, hd, st);
}
