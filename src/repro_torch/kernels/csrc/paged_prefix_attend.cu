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
// Design: flash_prefill's block (4 query warps of 16 rows of one head, for
// the even and for the odd key tiles, merged at the end) and tile steps
// (flash_tiles.cuh: cp.async staging in the pool's dtype, double-buffered,
// both products on the tensor cores), with the key tile
// gathered row by row (16-byte copies) through the batch row's two block
// tables, so only positions < plen are read: whole pages up to the last
// one, which is masked at plen inside the page. The block reads the tables
// itself; nothing is densified.
//
// The int8 mode (an int8 pool with its scale pools (nP, KV, page)): the
// tile's codes are staged as the queries' type (exact: |c| <= 127), with
// plain loads and stores instead of cp.async, and each key's K and V
// scales beside them in shared memory. The K scale multiplies the score
// after the dot and the V scale the probability before p.V, so the tensor
// cores see the codes themselves; p * vs is split into its bf16 pieces
// (or tf32 halves) after that product (flash_tiles.cuh: attend_tile).
// The two scale pools are independent, as the Pallas kernel reads them.
// The pairings the serving paths run keep their instances as they were
// (kPool 0: a pool in the queries' type without scales; kPool 1: an int8
// pool with both); every other pairing takes the general instance (kPool
// 2): an int8 pool (staged as in kPool 1) or one in the queries' type
// (staged by cp.async as in kPool 0), chosen at run time, with each scale
// pool or none: a null one stages scale 1 for every key (its side read as
// values).
//
// The softcap mode (gemma2's attention-logit cap, ``cap`` != 0): each
// scaled score (int8: after the K scale, then 1/sqrt(hd), the Pallas
// kernel's order) becomes cap * tanh(score / cap) in the shared tile step.
//
// Head dim 320 (gemma3-4b's global layers) runs the wide block of
// flash_tiles.cuh (the two warp groups split the output columns over
// every key tile, one tile a round), every kPool instance, built into its
// own library (FLASH_FIXED_HD=320, kernels/build.py: VARIANTS).

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename P, bool kOptional>
struct PagedRows {                 // pool (nP, KV, page, hd)
  const P* pool;
  const float* ks;                 // scale pools (nP, KV, page), or null
  const float* vs;
  const int* bt_k;                 // the batch row's P entries
  const int* bt_v;
  int kv_k, kvh, page, hd;
  __device__ size_t at(const int* bt, int j) const {  // (page, KV row, pos)
    const int lp = j / page;
    return (static_cast<size_t>(bt[lp]) * kv_k + kvh) * page +
           (j - lp * page);
  }
  __device__ const P* krow(int j) const { return pool + at(bt_k, j) * hd; }
  __device__ const P* vrow(int j) const { return pool + at(bt_v, j) * hd; }
  // kOptional: a side without scales reads as scale 1
  __device__ float kscale(int j) const {
    if constexpr (kOptional) return ks ? ks[at(bt_k, j)] : 1.f;
    return ks[at(bt_k, j)];
  }
  __device__ float vscale(int j) const {
    if constexpr (kOptional) return vs ? vs[at(bt_v, j)] : 1.f;
    return vs[at(bt_v, j)];
  }
};

struct AllVisible {                // positions past plen never enter a tile
  __device__ bool operator()(int, int) const { return true; }
};

// kPool: 0 a pool in T without scales; 1 int8 codes with both scales; 2
// either pool (int8 when pool_i8), each scale optional.
template <typename T, int HD, int kPool>
__global__ void __launch_bounds__(kThreads)
paged_prefix_attend_kernel(const T* __restrict__ q,
                           const void* __restrict__ pool,
                           const float* __restrict__ ks_pool,
                           const float* __restrict__ vs_pool,
                           const int* __restrict__ bt_k,
                           const int* __restrict__ bt_v,
                           const int* __restrict__ plen,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out, int n_q, int H,
                           int KV, int P, int page, float scale, float cap,
                           int pool_i8) {
  using L = Layout<T, HD>;
  constexpr int kTs = L::kTs;
  constexpr int kPer = L::kRoundTiles;  // tiles a round
  constexpr bool kI8 = kPool == 1, kScaled = kPool != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockRows * L::kStride;    // kStages x kPer K tiles
  T* vs = ks + kStages * kPer * kTs * L::kStride;   // and V tiles
  // scaled: the tiles' K and V scales, kTs floats each per tile slot
  float* ksc =
      reinterpret_cast<float*>(vs + kStages * kPer * kTs * L::kStride);
  float* vsc = ksc + kStages * kPer * kTs;
  const int tid = threadIdx.x, warp = tid / 32;
  const int wq = warp % kWarps, kg = warp / kWarps;  // row group, key group
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  // plen past the table is cut to the table's positions, as the TPU grid
  // over P pages does.
  const int n_keys = max(0, min(plen[b], P * page));
  const int n_tiles = (n_keys + kTs - 1) / kTs;
  const int n_rounds = (n_tiles + kPer - 1) / kPer;
  using Pool = typename std::conditional<kI8, int8_t, T>::type;
  const PagedRows<Pool, false> rows{static_cast<const Pool*>(pool), ks_pool,
                                    vs_pool, bt_k + static_cast<size_t>(b) * P,
                                    bt_v + static_cast<size_t>(b) * P, KV,
                                    h / (H / KV), page, HD};
  // the general instance's two views of the pool
  const PagedRows<T, true> rows_t{static_cast<const T*>(pool), ks_pool,
                                  vs_pool, rows.bt_k, rows.bt_v, KV, rows.kvh,
                                  page, HD};
  const PagedRows<int8_t, true> rows_i8{static_cast<const int8_t*>(pool),
                                        ks_pool, vs_pool, rows.bt_k,
                                        rows.bt_v, KV, rows.kvh, page, HD};
  if (n_tiles > 0) {
    stage_rows<T, HD>(qs, kBlockRows, n_q - q0, [&](int r) {
      return q + ((static_cast<size_t>(b) * n_q + q0 + r) * H + h) * HD;
    }, tid, kThreads);
  }
  // tile t of round r = t / kPer sits in buffer slot
  // (r % kStages) * kPer + t % kPer
  auto tile_slot = [&](int t) {
    return (t / kPer) % kStages * kPer + t % kPer;
  };
  auto slot = [&](int t) { return tile_slot(t) * kTs * L::kStride; };
  auto stage_round = [&](int r) {
    for (int t = r * kPer; t < min(n_tiles, (r + 1) * kPer); ++t) {
      const int k0 = t * kTs, n = min(kTs, n_keys - k0);
      if constexpr (kPool == 2) {
        const int sc0 = tile_slot(t) * kTs;
        if (pool_i8) {
          stage_codes<T, HD>(
              ks + slot(t), ksc + sc0, kTs, n,
              [&](int j) { return rows_i8.krow(k0 + j); },
              [&](int j) { return rows_i8.kscale(k0 + j); }, tid, kThreads);
          stage_codes<T, HD>(
              vs + slot(t), vsc + sc0, kTs, n,
              [&](int j) { return rows_i8.vrow(k0 + j); },
              [&](int j) { return rows_i8.vscale(k0 + j); }, tid, kThreads);
        } else {
          stage_rows<T, HD>(ks + slot(t), kTs, n,
                            [&](int j) { return rows_t.krow(k0 + j); }, tid,
                            kThreads);
          stage_rows<T, HD>(vs + slot(t), kTs, n,
                            [&](int j) { return rows_t.vrow(k0 + j); }, tid,
                            kThreads);
          for (int j = tid; j < kTs; j += kThreads) {
            ksc[sc0 + j] = j < n ? rows_t.kscale(k0 + j) : 0.f;
            vsc[sc0 + j] = j < n ? rows_t.vscale(k0 + j) : 0.f;
          }
        }
      } else if constexpr (kI8) {
        const int sc0 = tile_slot(t) * kTs;
        stage_codes<T, HD>(
            ks + slot(t), ksc + sc0, kTs, n,
            [&](int j) { return rows.krow(k0 + j); },
            [&](int j) { return rows.kscale(k0 + j); }, tid, kThreads);
        stage_codes<T, HD>(
            vs + slot(t), vsc + sc0, kTs, n,
            [&](int j) { return rows.vrow(k0 + j); },
            [&](int j) { return rows.vscale(k0 + j); }, tid, kThreads);
      } else {
        stage_rows<T, HD>(ks + slot(t), kTs, n,
                          [&](int j) { return rows.krow(k0 + j); }, tid,
                          kThreads);
        stage_rows<T, HD>(vs + slot(t), kTs, n,
                          [&](int j) { return rows.vrow(k0 + j); }, tid,
                          kThreads);
      }
    }
  };
  if (n_rounds > 0) stage_round(0);
  cp_async_commit();
  const int r0 = q0 + wq * kRows;
  const bool w_live = r0 < n_q;
  // the wide block: every warp reads the round's one tile, at its
  // column group's first column of V
  const int v_col = L::kWide ? kg * L::kCols : 0;
  State<L::kCols> st;
  st.init();
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) {
      stage_round(r + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = r * kPer + (L::kWide ? 0 : kg);
    if (t < n_tiles && w_live)
      attend_tile<T, HD, kScaled>(qs + wq * kRows * L::kStride, ks + slot(t),
                              vs + slot(t) + v_col,
                              min(kTs, n_keys - t * kTs),
                              AllVisible{}, scale, cap, st,
                              ksc + tile_slot(t) * kTs,
                              vsc + tile_slot(t) * kTs);
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (!L::kWide)
    merge_key_groups<HD>(st, reinterpret_cast<float*>(ks));
  if ((L::kWide || kg == 0) && w_live)
    store_rows<T, HD>(st, b, h, r0, n_q, H, nullptr, m_out, l_out, acc_out);
}

template <typename T, int kPool>
int launch(const void* q, const void* pool, const void* ks_pool,
           const void* vs_pool, const void* bt_k, const void* bt_v,
           const void* plen, void* m_out, void* l_out, void* acc_out, int B,
           int n_q, int H, int KV, int P, int page, int hd, float cap,
           int pool_i8, cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    using L = Layout<T, HD>;
    // scaled: the tiles' scales after the tiles (a key's K and V scale)
    constexpr size_t smem =
        L::kBytes + (kPool ? 2 * kStages * L::kRoundTiles * L::kTs * 4 : 0);
    auto kern = paged_prefix_attend_kernel<T, HD, kPool>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n_q + kBlockRows - 1) / kBlockRows, H, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), pool, static_cast<const float*>(ks_pool),
        static_cast<const float*>(vs_pool),
        static_cast<const int*>(bt_k), static_cast<const int*>(bt_v),
        static_cast<const int*>(plen), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(acc_out), n_q, H,
        KV, P, page, inv_sqrt_hd(HD), cap, pool_i8);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q: (B, n_q, H, hd); pool: (nP, KV, page, hd), both fp32 (bf16 == 0) or bf16
// (bf16 == 1), or an int8 pool (i8 == 1) beside a q of either type; ks_pool,
// vs_pool (nP, KV, page) fp32 scale pools, each null or not (a null one reads
// its side as values); ``kind`` (kernels/chai_attention.py: kv_body, with
// raw int8 V a general pairing): 0 a pool in q's type without scales, 1
// an int8 pool with both scale pools, 2 any other pairing (kPool); bt_k,
// bt_v: (B, P) int32 page ids into the pool; plen:
// (B,) int32 cached positions; m_out, l_out: (B, H, n_q) and acc_out: (B, H,
// n_q, hd) fp32. All contiguous and 16-byte aligned; H % KV == 0, hd a power
// of two from 8 to 256 or 224 (the wide library: 320; else
// cudaErrorInvalidValue); cap != 0: the softcap. Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int paged_prefix_attend_launch(
    const void* q, const void* pool, const void* ks_pool, const void* vs_pool,
    const void* bt_k, const void* bt_v, const void* plen, void* m_out,
    void* l_out, void* acc_out, int B, int n_q, int H, int KV, int P,
    int page, int hd, int bf16, int i8, int kind, float cap,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto t) {
    using T = decltype(t);
    auto run = [&](auto kind_c) {
      return launch<T, decltype(kind_c)::value>(
          q, pool, ks_pool, vs_pool, bt_k, bt_v, plen, m_out, l_out, acc_out,
          B, n_q, H, KV, P, page, hd, cap, i8, st);
    };
    if (kind == 1) return run(std::integral_constant<int, 1>());
    if (kind == 2) return run(std::integral_constant<int, 2>());
    return run(std::integral_constant<int, 0>());
  };
  return bf16 ? go(__nv_bfloat16()) : go(0.f);
}
