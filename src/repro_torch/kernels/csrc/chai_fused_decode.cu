// One-pass fused clustered decode (CHAI STEADY attention) over a dense
// cache, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_fused_decode (the Pallas
// TPU kernel, tile body _fused_tile; grid (B, S / ts) with the online
// softmax carried in VMEM scratch along the sequential S-tile axis).
// Output: (B, H, hd) fp32, or the unnormalized state (emit_state). The
// block body lives in chai_decode_tiles.cuh, shared with the paged kernel,
// which stays bitwise equal to this one at equal tile size.
//
// What bounds it: device memory. Per batch row it must read the K rows of
// the reps that have members and every head's V row at the positions
// 0..pos, once; at 1-5 queries per K row the multiply-adds are far below
// the tensor cores' line, so no wgmma. Design: the grid is (member
// slices, n_split, B * KVk): one block per (member slice, S split, batch
// row, K row), serving every rep of that K row and up to eight of their
// member heads, so a K row is read once for all its reps, a rep with many
// members spreads its V rows over several blocks, and the card holds
// enough blocks (the host's split plan aims at sixteen per SM: short
// splits keep each block's chain of memory round trips short). Each
// block streams its range in chunks with fixed shared memory (no sequence
// length is too long), scores one position per thread and sums V with
// 16-byte loads, and the splits merge in split order inside the launch
// (the unit's last block to arrive), so the call stays one launch with
// run-to-run identical bits. Each block is a chain of dependent memory
// round trips (positions, member list, K, V, the merge's reads), so at
// the main path's sizes the time is that chain, not the bytes.
//
// K and V each on its own (the Pallas tile casts each and applies each
// scale only when passed): the pairings the serving paths run keep their
// own body (one element type; K scaled iff int8), and every other pair of
// K and V element types (fp32, bf16, int8) takes the general body, in
// which each side's row scales are a run-time null test
// (chai_decode_tiles.cuh: kGeneral). The int8 mode (an
// int8 KV cache) is the int8 instance with both scales: 8-byte loads of
// codes and one fp32 scale per
// row and position (hd + 4 bytes a row where bf16 moves 2 hd), the K
// scale on the score after the dot and the V scale on the V row before
// A.V, as the Pallas tile does. A null scale reads the codes as values; a
// scale beside float rows multiplies them the same way.
//
// The share mode (share_values, CHAI-QKV: the Pallas kernel's
// ``share_values``): V is clustered like K, one row per rep, and each
// unit keeps one accumulator row, its rep's; the finalized rows go to the
// member heads after the division, the state mode emits (B, R, hd). Under
// int8 its V codes come without scales and are read as values (the
// reference writes them by a plain cast and reads them scale-less).
//
// The softcap mode (gemma2's ``attn_logit_softcap``, the Pallas kernel's
// ``softcap``): a runtime ``cap``; each score, once scaled, becomes
// cap * tanhf(score / cap) before the validity mask, in the shared score
// step of chai_decode_tiles.cuh, so it composes with fp32/bf16, int8,
// share, the state mode and MHA/GQA alike.

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
  const void* k;
  const void* v;
  const float* ks;   // (B, kv_k, S) scales of K's rows, or null
  const float* vs;   // (B, kv_v, S) scales of V's rows, or null
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
  int R, H, kv_k, kv_v, S, hd, rpg, v_rep, window, n_cap;
  Plan plan;
  float scale;
  float cap;   // the softcap mode: cap * tanh(score / cap); 0 = off
};

template <typename TK, typename TV, int kQ, bool kEmit, bool kGeneral>
__global__ void __launch_bounds__(kThreads)
chai_fused_decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  const int z = blockIdx.x, s = blockIdx.y, u = blockIdx.z;
  const int b = u / a.kv_k, g = u - b * a.kv_k;
  const TK* k = static_cast<const TK*>(a.k);
  const TV* v = static_cast<const TV*>(a.v);
  const size_t kb = static_cast<size_t>(b) * a.kv_k * a.S;
  const size_t vb = static_cast<size_t>(b) * a.kv_v * a.S;
  DenseTiles<TK, TV> tiles{k + kb * CHAI_HD, v + vb * CHAI_HD,
                           a.ks ? a.ks + kb : nullptr,
                           a.vs ? a.vs + vb : nullptr, a.S, CHAI_HD};
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
      kern = chai_fused_decode_kernel<TK, TV, kQ, false, true>;
    else
      kern = a.m ? chai_fused_decode_kernel<TK, TV, kQ, true, false>
                 : chai_fused_decode_kernel<TK, TV, kQ, false, false>;
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

// q: (B, R, hd) fp32; k: (B, kv_k, S, hd) and v: (B, kv_v, S, hd), each
// fp32 (type 0), bf16 (1) or int8 codes (2) by k_type / v_type; ks:
// (B, kv_k, S) and vs: (B, kv_v, S) fp32 row scales, each null or not
// whatever the types (null: the rows read as values); ``body``
// (kernels/chai_attention.py: kv_body): 2 the general body, else the
// serving paths' body of k_type (v_type == k_type, ks set iff int8, vs
// null beside float rows); h2c: (B, H) int32
// with values in
// [0, R); pos: (B,) int32; out: (B, H, hd) fp32; m, l: (B, R) fp32, or
// both null. All contiguous and 16-byte aligned; hd % 8 == 0, hd <= 256
// (the wide-head libraries: hd == 320, the serving pairings in one, the
// general ones in the other);
// R == kv_k * rpg with rpg <= 8; S % ts == 0; ``step`` (<= 128) divides
// ts. The split plan: n_split (<= 64) ranges of ``tps`` tiles; with
// n_split > 1 the scratch mp, lp (B, n_split, R), accp (B, n_split, H,
// hd) fp32 and counter (B * kv_k) int32, all zero, are needed (the merge
// leaves the counters at zero again); with n_split == 1 they may be null.
// A block serves n_cap (1..8) member heads of its unit. With m and l null, out
// is the finalized output; otherwise the state mode writes the
// unnormalized acc to out and each rep's m and l (emit_state). share != 0
// (share_values): kv_v == R and rpg == 1, rep j reads V row j, and the
// state mode's out
// and accp hold R acc rows, (B, R, hd) and (B, n_split, R, hd). Returns
// the launch's cudaError_t (0 on success); does not synchronise. ``cap``
// != 0: the softcap mode, every score cap * tanh(score / cap) before the
// mask (composes with every other mode).
extern "C" int chai_fused_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* h2c, const void* pos, void* out, void* m,
    void* l, void* mp, void* lp, void* accp, void* counter, int B, int R,
    int H, int kv_k, int kv_v, int S, int hd, int ts, int step, int rpg,
    int v_rep, int window, int n_split, int tps, int n_cap, int share,
    int k_type, int v_type, int body, float cap, void* stream) {
  const Args a{static_cast<const float*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(h2c), static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), share, R, H, kv_k, kv_v, S, hd, rpg,
               v_rep, window, n_cap,
               Plan{n_split, tps, S / ts, ts, step}, inv_sqrt_hd(hd), cap};
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

// The dynamic shared memory of one block in bytes, for a check that the
// host's mirror (kernels/chai_attention.py) agrees.
// ``general``: the general body's (a pairing the serving paths do not run).
extern "C" int chai_decode_smem_bytes(int rpg, int hd, int n_map, int n_cap,
                                      int general) {
  return static_cast<int>(block_smem_bytes(
      general ? kGeneralQ : query_bucket(rpg), hd, n_map, n_cap));
}
