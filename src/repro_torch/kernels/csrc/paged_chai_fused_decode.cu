// One-pass fused clustered decode (CHAI STEADY attention) over block-table
// page pools, for Hopper: the continuous engine's paged STEADY decode.
//
// Replaces repro/kernels/chai_attention.py: paged_chai_fused_decode (the
// Pallas TPU kernel; its BlockSpec index maps read the scalar-prefetched
// block tables, one page per grid step). Same function as the dense kernel
// with tile t of batch row b located at page bt_k[b, t] of the K pool
// (the clustered pool, k_max rows) and page bt_v[b, t] of the V pool (the
// dense per-head pool): K and V take different tables. The tile size is
// the page. The block body is chai_decode_tiles.cuh's unit_block, the
// dense kernel's own, over the same split plan, so the two are bitwise
// equal when the dense tile equals the page.
//
// What bounds it: device memory, as for the dense kernel: the K rows of
// reps that have members and every head's V row, only the pages up to pos.
// Design: the dense kernel's (one block per (member slice, S split, batch
// row, K row), splits merged in order inside the launch), with each chunk's entries of
// the row's two block tables staged in shared memory, so shared memory
// stays fixed whatever the table's length. Only pages t <= pos / page are
// read, and every entry of a block table is a page id the engine
// allocated or the null page 0, so the mixed step's rows that are not
// STEADY (a WARMUP row's K table is all null page 0; a FREE row has pos 0)
// read in-bounds pages only; their outputs are discarded by the caller.
// The K and V scale pools (nP, rows, page), each optional as in the dense
// kernel, are read through the same staged table entries
// (chai_decode_tiles.cuh: PagedTiles), so every K/V pairing (the int8
// mode among them) stays bitwise equal to the dense kernel's. The share mode
// (share_values) reads V from the clustered pool through its own table
// (the engine's ``bt_vc``), as the dense kernel's share mode does, and the
// softcap mode (``cap``) is the dense kernel's too.

#include "chai_decode_tiles.cuh"

// The head dim of this library's instances: 0, the call's (any multiple
// of 8 up to kMaxHd), or fixed at compile time at kWideHd (320): the
// wide-head library is this source built again with
// -DCHAI_FIXED_HD=320 (kernels/build.py: VARIANTS), so the two share every
// line and the head dims up to 256 keep their own library and instances.
// The wide library's launcher takes hd == 320 and the serving paths' K/V
// pairings only (one float type, or int8 with its scales); built once
// more with -DCHAI_WIDE_GENERAL=1 as well, it takes hd == 320 and the
// general body's pairings only (lib<kernel>_wide_kv.so), so neither wide
// library's build holds the other's instances.
#ifndef CHAI_FIXED_HD
#define CHAI_FIXED_HD 0
#endif
#ifndef CHAI_WIDE_GENERAL
#define CHAI_WIDE_GENERAL 0
#endif

namespace {

using namespace chai;

constexpr int kFixedHd = CHAI_FIXED_HD;
static_assert(kFixedHd == 0 || kFixedHd == kWideHd,
              "the wide-head instance is kWideHd");
// The kernel's head dim: the call's (a.hd), or kFixedHd. An expression,
// not a variable, so that at kFixedHd 0 the compiler sees the kernel of
// head dims up to 256 exactly as it was: every use reads the parameter.
#define CHAI_HD (kFixedHd ? kFixedHd : a.hd)

struct Args {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* ks_pool;   // (nPk, kv_k, page) scales of K, or null
  const float* vs_pool;   // (nPv, kv_v, page) scales of V, or null
  const int* bt_k;
  const int* bt_v;
  const int* h2c;
  const int* pos;
  float* out;
  float* m;
  float* l;
  float* mp;
  float* lp;
  float* accp;
  int* counter;
  int share;   // share_values: V rows are the R reps' (kv_v == R, rpg 1)
  int R, H, kv_k, kv_v, P, page, hd, rpg, v_rep, window, n_cap;
  Plan plan;
  float scale;
  float cap;   // the softcap mode: cap * tanh(score / cap); 0 = off
};

template <typename TK, typename TV, int kQ, bool kEmit, bool kGeneral>
__global__ void __launch_bounds__(kThreads)
paged_chai_fused_decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  const int z = blockIdx.x, s = blockIdx.y, u = blockIdx.z;
  const int b = u / a.kv_k, g = u - b * a.kv_k;
  PagedTiles<TK, TV> tiles{static_cast<const TK*>(a.k_pool),
                           static_cast<const TV*>(a.v_pool), a.ks_pool,
                           a.vs_pool, a.bt_k + static_cast<size_t>(b) * a.P,
                           a.bt_v + static_cast<size_t>(b) * a.P,
                           a.kv_k, a.kv_v, a.page, CHAI_HD,
                           (a.page & (a.page - 1)) ? -1 : __ffs(a.page) - 1,
                           nullptr, 0};
  const Members mem{a.h2c + static_cast<size_t>(b) * a.H, nullptr, a.H,
                    a.rpg, g, a.v_rep, a.share != 0};
  // acc rows of a batch row: the heads, or the reps under share_values
  const int rows = a.share ? a.R : a.H;
  const size_t rep0 = static_cast<size_t>(b) * a.R + g * a.rpg;
  // the state mode: fixed by kEmit, or (the general body) by a.m
  const bool emit = kGeneral ? a.m != nullptr : kEmit;
  const Outputs o{a.out + static_cast<size_t>(b) * (emit ? rows : a.H) *
                              CHAI_HD,
                  emit ? a.m + rep0 : nullptr, emit ? a.l + rep0 : nullptr};
  const int ns = a.plan.n_split;
  const size_t part0 = static_cast<size_t>(b) * ns * a.R + g * a.rpg;
  const Partials part{
      a.mp ? a.mp + part0 : nullptr, a.lp ? a.lp + part0 : nullptr,
      a.accp ? a.accp + static_cast<size_t>(b) * ns * rows * CHAI_HD
             : nullptr,
      a.R, static_cast<size_t>(rows) * CHAI_HD,
      a.counter ? a.counter + u : nullptr};
  unit_block<TK, TV, kQ, kEmit, kGeneral>(
      tiles, reinterpret_cast<float*>(smem_raw), a.q + rep0 * CHAI_HD,
      a.rpg, g, mem, a.plan, s, z, a.pos[b], a.window, CHAI_HD, a.n_cap,
      a.scale, a.cap, o, part);
}

template <typename TK, typename TV, bool kGeneral>
struct Launch {
  Args a;
  int B;
  cudaStream_t stream;
  template <int kQ>
  int run() const {
    const size_t smem = block_smem_bytes(kQ, a.hd, a.H, a.n_cap);
    // m and l null: the finalized mode; else the state mode (a run-time
    // test in the general body, which has one instance for both)
    void (*kern)(const Args) = nullptr;
    if constexpr (kGeneral)
      kern = paged_chai_fused_decode_kernel<TK, TV, kQ, false, true>;
    else
      kern = a.m ? paged_chai_fused_decode_kernel<TK, TV, kQ, true, false>
                 : paged_chai_fused_decode_kernel<TK, TV, kQ, false, false>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // share_values: one accumulator row a unit, one slice
    const int n_slices = a.share ? 1 : (a.H + a.n_cap - 1) / a.n_cap;
    dim3 grid(n_slices, a.plan.n_split, B * a.kv_k);
    kern<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, R, hd) fp32; k_pool: (nPk, kv_k, page, hd) and v_pool:
// (nPv, kv_v, page, hd), each fp32 (type 0), bf16 (1) or int8 codes (2) by
// k_type / v_type; ks_pool: (nPk, kv_k, page) and vs_pool: (nPv, kv_v,
// page) fp32 row scales read through the same tables, each null or not
// whatever the types; ``body`` as in chai_fused_decode_launch;
// bt_k, bt_v: (B, P) int32 page ids into their pools; h2c: (B, H) int32
// with values in [0, R); pos: (B,) int32; out: (B, H, hd) fp32; m, l:
// (B, R) fp32, or both null (finalized output; otherwise the state mode,
// as in chai_fused_decode_launch; ``share`` as there, v_pool then the
// clustered pool read through bt_v). The split plan (n_split ranges of
// ``tps`` pages), ``step`` (a divisor of the page, <= 128), the scratch
// and n_cap as in chai_fused_decode_launch. All contiguous and 16-byte
// aligned; hd % 8 == 0, hd <= 256 (the wide-head libraries: hd == 320,
// the serving pairings in one, the general ones in the other); ``cap`` (the softcap mode, 0 = off) as
// in chai_fused_decode_launch. Returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int paged_chai_fused_decode_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* ks_pool, const void* vs_pool, const void* bt_k,
    const void* bt_v, const void* h2c, const void* pos, void* out, void* m,
    void* l, void* mp, void* lp, void* accp, void* counter, int B, int R,
    int H, int kv_k, int kv_v, int P, int page, int hd, int step, int rpg,
    int v_rep, int window, int n_split, int tps, int n_cap, int share,
    int k_type, int v_type, int body, float cap, void* stream) {
  const Args a{static_cast<const float*>(q), k_pool, v_pool,
               static_cast<const float*>(ks_pool),
               static_cast<const float*>(vs_pool),
               static_cast<const int*>(bt_k), static_cast<const int*>(bt_v),
               static_cast<const int*>(h2c), static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), share, R, H, kv_k, kv_v, P, page, hd,
               rpg, v_rep, window, n_cap,
               Plan{n_split, tps, P, page, step}, inv_sqrt_hd(hd), cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kFixedHd ? hd != kFixedHd : hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
#if CHAI_WIDE_GENERAL
  // the wide general library serves the general body only
  if (body != kBodyGeneral) return static_cast<int>(cudaErrorInvalidValue);
#else
  if (body != kBodyGeneral)   // one type for K and V
    return with_elem(k_type, [&](auto t) {
      using T = decltype(t);
      return with_queries(rpg, Launch<T, T, false>{a, B, st});
    });
#endif
#if CHAI_FIXED_HD == 0 || CHAI_WIDE_GENERAL
  return with_kv_types(k_type, v_type, [&](auto tk, auto tv) {
    return Launch<decltype(tk), decltype(tv), true>{a, B, st}
        .template run<kGeneralQ>();
  });
#else
  // the wide serving library serves the serving paths' pairings only
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}
