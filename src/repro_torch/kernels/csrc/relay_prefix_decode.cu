// Relay shared-prefix decode: one attention pass per relay group over the
// group's packed shared prefix, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: relay_prefix_decode (the
// Pallas TPU kernel, body _relay_prefix_kernel). The STEADY slots of a
// relay group share the pages of one radix chain (a cached system
// prompt); their rep queries are stacked along one row axis (NR =
// Nmax * R per group), so the prefix is read once per group and not once
// per slot. Three int32 maps route the rows: k_row (query row -> K row),
// a_row (acc row -> query row: the head -> cluster broadcast, deferred
// here from the slot's own decode) and v_row (acc row -> V row). Mask:
// idx < plen[g] (every prefix position precedes every decode query, so no
// causal mask; the same test hides the zero tail of a shorter group's
// view). Output: the unnormalized online-softmax state m, l (G, NR) and
// acc (G, A, hd), fp32, which the caller merges with each slot's suffix
// pass (the fused decode's state mode) before normalizing.
//
// The TPU kernel spells each routing as a one-hot matmul; every one-hot
// row has one nonzero, so here they are index reads and a member list.
// Design: the decode kernels' streamed block body (unit_block in
// chai_decode_tiles.cuh) with one split, one block per (member slice,
// query row i, group g): the row's query and its K row k_row[g, i], scores over
// positions < plen streamed in chunks with fixed shared memory (so no
// prefix is too long), the online softmax over steps in order, then
// every acc row a with a_row[g, a] == i (up to eight per slice), reading
// V row v_row[g, a].
// Padded members carry index 0 in every map: their rows read in-bounds
// rows and compute values the caller's scatter discards.
//
// What bounds it: device memory. Per group it must read the K rows the
// query rows name and the V rows the acc rows name, positions < plen,
// once. At the full-width relay step (G = 1 group of 4 slots: NR = 4 x 25
// = 100 rows, A = 128, plen 256) 100 blocks do the work (the slices past
// a row's members return at once), which underfills the 132 SMs, and a K
// row named by several query rows is read once per row; sharing rows
// across blocks and splitting Sp are left for later work.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

template <typename T>
__global__ void __launch_bounds__(kThreads)
relay_prefix_decode_kernel(const float* __restrict__ q,
                           const T* __restrict__ k, const T* __restrict__ v,
                           const int* __restrict__ k_row,
                           const int* __restrict__ a_row,
                           const int* __restrict__ v_row,
                           const int* __restrict__ plen,
                           float* __restrict__ m, float* __restrict__ l,
                           float* __restrict__ acc, int NR, int A, int KV,
                           int VR, int Sp, int hd, int ts, int step,
                           int n_cap, float scale) {
  extern __shared__ float4 smem_raw[];
  const int z = blockIdx.x, i = blockIdx.y, g = blockIdx.z;
  const size_t row = static_cast<size_t>(g) * NR + i;
  DenseTiles<T> tiles{k + static_cast<size_t>(g) * KV * Sp * hd,
                      v + static_cast<size_t>(g) * VR * Sp * hd, Sp, hd};
  const Members mem{a_row + static_cast<size_t>(g) * A,
                    v_row + static_cast<size_t>(g) * A, A, 1, i, 1};
  const Outputs o{acc + static_cast<size_t>(g) * A * hd, m + row, l + row};
  const Plan plan{1, Sp / ts, Sp / ts, ts, step};
  unit_block<T, 1, true>(tiles, reinterpret_cast<float*>(smem_raw),
                         q + row * hd, 1, k_row[row], mem, plan, 0, z,
                         plen[g] - 1, 0, hd, n_cap, scale, o, Partials{});
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* k_row,
           const void* a_row, const void* v_row, const void* plen, void* m,
           void* l, void* acc, int G, int NR, int A, int KV, int VR, int Sp,
           int hd, int ts, int step, int n_cap, cudaStream_t stream) {
  const size_t smem = block_smem_bytes(1, hd, A, n_cap);
  auto kern = relay_prefix_decode_kernel<T>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((A + n_cap - 1) / n_cap, NR, G);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(k_row),
      static_cast<const int*>(a_row), static_cast<const int*>(v_row),
      static_cast<const int*>(plen), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), NR, A, KV, VR, Sp,
      hd, ts, step, n_cap, inv_sqrt_hd(hd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (G, NR, hd) fp32; k: (G, KV, Sp, hd); v: (G, VR, Sp, hd), both fp32
// (kv_bf16 == 0) or bf16 (kv_bf16 == 1); k_row: (G, NR) int32 in [0, KV);
// a_row: (G, A) int32 in [0, NR); v_row: (G, A) int32 in [0, VR); plen:
// (G,) int32 in [0, Sp]; m, l: (G, NR) fp32; acc: (G, A, hd) fp32. All
// contiguous and 16-byte aligned; hd % 8 == 0, hd <= 256; Sp % ts == 0;
// ``step`` (<= 128) divides ts; a block serves n_cap (1..8) acc rows of
// its query row. Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int relay_prefix_decode_launch(const void* q, const void* k,
                                          const void* v, const void* k_row,
                                          const void* a_row,
                                          const void* v_row,
                                          const void* plen, void* m, void* l,
                                          void* acc, int G, int NR, int A,
                                          int KV, int VR, int Sp, int hd,
                                          int ts, int step, int n_cap,
                                          int kv_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(q, k, v, k_row, a_row, v_row, plen, m, l,
                                 acc, G, NR, A, KV, VR, Sp, hd, ts, step,
                                 n_cap, st);
  return launch<float>(q, k, v, k_row, a_row, v_row, plen, m, l, acc, G, NR,
                       A, KV, VR, Sp, hd, ts, step, n_cap, st);
}
