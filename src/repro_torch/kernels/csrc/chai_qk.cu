// Raw masked representative-head scores, the first stage of the
// three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_qk, chai_qk_i8 and
// paged_chai_qk (three Pallas TPU kernels with one body: a (B, R, S/ts)
// grid, one K tile per step, located densely or through the block table).
// Output: (B, R, S) fp32, scores[b, j, s] = dot(q[b, j], K[kv_row, s]) *
// (1 / sqrt(hd)) with rep j reading K row j / reps_per_group, exactly
// -2e38 where s > pos[b] or (window > 0 and pos[b] - s >= window). The
// int8 kernel applies the per-row fp32 scale after the dot, in the Pallas
// kernel's order: dot(k_i8, q) * k_scale[row] * (1 / sqrt(hd)).
//
// What bounds it: device memory. It must read the K rows of every valid
// position once per rep (R * n_valid * hd elements: one byte each for
// int8, which is that kernel's whole point) and write the (B, R, S) fp32
// scores. Design: every output position is independent, so the grid is
// (S / 64, R, B) to fill the 132 SMs with blocks; a block keeps its rep
// query in shared memory, and each of its four warps takes one position
// at a time: the 32 lanes read that K row with coalesced paired loads (2
// elements a lane: 8 bytes fp32, 4 bf16, 2 int8), then a shuffle
// reduction. A masked position writes -2e38 and reads no K byte. The
// paged locator reads bt[b, s / page] itself. Splitting a K row over
// fewer lanes (16-byte loads) and sharing one K row between the reps of a
// GQA group are left for later work.

#include <stdint.h>

#include <type_traits>

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

constexpr int kPositions = 64;   // positions per block (16 per warp)

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// Dense cache (B, kv, S, hd): row r of batch b at position s. The scale
// rows (int8 only) are (B, kv, S).
template <typename T>
struct DenseRows {
  const T* k;
  int kv, s, hd;
  __device__ size_t index(int b, int r, int i) const {
    return (static_cast<size_t>(b) * kv + r) * s + i;
  }
  __device__ const T* row(int b, int r, int i) const {
    return k + index(b, r, i) * hd;
  }
};

// Page pool (nP, kv, page, hd) through the block table bt (B, P):
// position s of batch row b is row s % page of page bt[b, s / page].
template <typename T>
struct PagedRows {
  const T* k;
  const int* bt;
  int kv, page, hd, n_pages;
  __device__ const T* row(int b, int r, int i) const {
    const int pg = bt[static_cast<size_t>(b) * n_pages + i / page];
    return k + ((static_cast<size_t>(pg) * kv + r) * page + i % page) * hd;
  }
};

template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
qk_kernel(const float* __restrict__ q, const Rows rows,
          const float* __restrict__ k_scale, const int* __restrict__ pos,
          float* __restrict__ out, int R, int S, int hd, int rpg, int window,
          float scale) {
  extern __shared__ float q_s[];                         // hd
  const int j = blockIdx.y, b = blockIdx.z;
  const size_t row = static_cast<size_t>(b) * R + j;
  for (int d = threadIdx.x; d < hd; d += kThreads) q_s[d] = q[row * hd + d];
  __syncthreads();
  const int p = pos[b], kv_row = j / rpg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* o = out + row * S;
  const int s_end = min(S, static_cast<int>(blockIdx.x + 1) * kPositions);
  for (int s = blockIdx.x * kPositions + warp; s < s_end; s += kWarps) {
    bool valid = s <= p;
    if (window > 0) valid = valid && (p - s) < window;
    if (!valid) {                         // masked: no K byte is read
      if (lane == 0) o[s] = kNegInf;
      continue;
    }
    const auto* kr = rows.row(b, kv_row, s);
    float dot = 0.f;
    for (int d = 2 * lane; d < hd; d += 64) {
      const float2 kk = load_pair(kr + d);
      dot += q_s[d] * kk.x + q_s[d + 1] * kk.y;
    }
    dot = warp_sum(dot);
    if (lane == 0) {
      if constexpr (std::is_same<T, int8_t>::value)
        o[s] = dot * k_scale[rows.index(b, kv_row, s)] * scale;
      else
        o[s] = dot * scale;
    }
  }
}

template <typename T, typename Rows>
int launch(const void* q, const Rows& rows, const void* k_scale,
           const void* pos, void* out, int B, int R, int S, int hd, int rpg,
           int window, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(hd) * sizeof(float);
  auto kern = qk_kernel<T, Rows>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kPositions - 1) / kPositions, R, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), rows,
      static_cast<const float*>(k_scale), static_cast<const int*>(pos),
      static_cast<float*>(out), R, S, hd, rpg, window, inv_sqrt_hd(hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, R, hd) fp32; k: (B, kv, S, hd) fp32 (kv_bf16 == 0) or bf16
// (kv_bf16 == 1); pos: (B,) int32; out: (B, R, S) fp32. R == kv * rpg;
// hd even and k aligned to two elements; all contiguous. Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int chai_qk_launch(const void* q, const void* k, const void* pos,
                              void* out, int B, int R, int kv, int S, int hd,
                              int rpg, int window, int kv_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(
        q, DenseRows<__nv_bfloat16>{
               static_cast<const __nv_bfloat16*>(k), kv, S, hd},
        nullptr, pos, out, B, R, S, hd, rpg, window, st);
  return launch<float>(
      q, DenseRows<float>{static_cast<const float*>(k), kv, S, hd}, nullptr,
      pos, out, B, R, S, hd, rpg, window, st);
}

// As chai_qk_launch over an int8 cache k: (B, kv, S, hd) with fp32 row
// scales k_scale: (B, kv, S).
extern "C" int chai_qk_i8_launch(const void* q, const void* k,
                                 const void* k_scale, const void* pos,
                                 void* out, int B, int R, int kv, int S,
                                 int hd, int rpg, int window, void* stream) {
  return launch<int8_t>(
      q, DenseRows<int8_t>{static_cast<const int8_t*>(k), kv, S, hd},
      k_scale, pos, out, B, R, S, hd, rpg, window,
      static_cast<cudaStream_t>(stream));
}

// As chai_qk_launch over a page pool k_pool: (nP, kv, page, hd) read
// through the block table bt: (B, P) int32; S == P * page. Every table
// entry a valid position reaches must name a page of the pool.
extern "C" int paged_chai_qk_launch(const void* q, const void* k_pool,
                                    const void* bt, const void* pos,
                                    void* out, int B, int R, int kv, int P,
                                    int page, int hd, int rpg, int window,
                                    int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt_i = static_cast<const int*>(bt);
  if (kv_bf16)
    return launch<__nv_bfloat16>(
        q, PagedRows<__nv_bfloat16>{
               static_cast<const __nv_bfloat16*>(k_pool), bt_i, kv, page,
               hd, P},
        nullptr, pos, out, B, R, P * page, hd, rpg, window, st);
  return launch<float>(
      q, PagedRows<float>{static_cast<const float*>(k_pool), bt_i, kv, page,
                          hd, P},
      nullptr, pos, out, B, R, P * page, hd, rpg, window, st);
}
