// Tile steps of the prefill attention kernels, shared by flash_prefill.cu
// (causal attention of a chunk over its own keys) and
// paged_prefix_attend.cu (the chunk's queries over the pages that earlier
// chunks wrote). Both products run on the tensor cores (mma.sync).
//
// A block owns kWarps * 16 query rows of one (batch, head) and has two
// key groups of kWarps warps: warp (g, w) owns rows 16w .. 16w + 15 (the M
// of an m16n8 mma) over the key tiles t = g, g + 2, ... of Layout::kTs
// keys (the Pallas grid's sequential kv axis becomes this loop, split in
// two so that each warp's serial chain of tiles is half as long). The two
// groups' states for a row merge in shared memory at the end. Each round's
// two tiles of K and V rows are staged in shared memory in their own
// dtype by 16-byte cp.async copies, double-buffered: round r + 1 loads
// while round r computes. Rows past the edges are zero-filled
// by the copy itself (source size 0), so no garbage reaches a product.
// Each warp keeps its rows' online-softmax state in registers (the FA2
// layout): the thread of lane (g = lane / 4, c = lane % 4) holds rows g
// and g + 8 of its warp, their m and l, and output columns 8n + 2c,
// 8n + 2c + 1 of every 8-column slice n.
//
// Arithmetic per tile, as the TPU tile body: scores q.k * 1/sqrt(hd),
// then, in the softcap mode (gemma2's attention-logit cap, a runtime
// ``cap`` != 0), cap * tanhf(score / cap) (exact tanhf and division; one
// uniform branch, cap == 0 leaves every other mode's bits as they were),
// masked positions -2e38, m_new = max(m, max(tile), -1e30), alpha =
// exp(m - m_new), p = exp(sc - m_new), l = l * alpha + sum(p), acc = acc *
// alpha + p.V. A masked score sits 2e38 below the clamped max, so it adds
// exactly 0 whatever the tile. A row that sees no visible key (no tile,
// or only masked ones: a sliding window past every key) ends with l = 0
// and acc = 0, and store_rows writes its m as -2e38: the exact identity
// of the state merge.
//
// Precision. The reference computes in fp32 and keeps p in fp32 before
// the p.V dot; the card check holds the state at 2e-5. Rounding p to bf16
// (as a bf16 attention does) costs ~4e-3, so the operands are split:
// - bf16 inputs: Q.K^T is an m16n8k16 bf16 mma with fp32 accumulation
//   (bf16 products are exact in fp32; only the summation order differs);
//   p.V is three m16n8k16 bf16 mmas, p1.V + p2.V + p3.V with p1 = bf16(p),
//   p2 = bf16(p - p1), p3 = bf16(p - p1 - p2): the three carry all 24 bits
//   of p, and bf16 V is exact. (Two tf32 pieces, tf32(p) and tf32(p -
//   tf32(p)), give ~2^-20 too, but take four k = 8 mmas for every 16
//   keys where the bf16 pieces take three k = 16 ones, and V's fragments
//   from scalar loads: slower on the card.)
// - fp32 inputs: both products as 3xTF32, a_hi.b_hi + a_hi.b_lo +
//   a_lo.b_hi, with tf32(x) x rounded to nearest at 10 mantissa bits, its
//   low 13 bits zero (what the tensor core ignores); each k-step of
//   Q.K^T is summed there from zeros and added to the score in fp32. Both
//   answer states that the card held outside 2e-5 at scores of std 4:
//   carried through the tensor core's own accumulator, the scores drifted
//   (an fp32 state to 4.5e-5 at hd 128, 2.5e-5 at hd 224), and split by
//   truncation, hi + lo missed x by up to 2^-20 |x|, twice the score
//   error of an fp32 product (rounded: 2^-22).
// tests/test_torch_prefill_precision.py emulates these roundings on the
// CPU. The tensor core truncates its own sums, so each tile's p.V is
// summed there from zeros and added to acc in fp32 on the CUDA cores: acc
// carried through the mmas drifted past 2e-5 on a row of 512 keys.
//
// Fragments: the bf16 Q and K fragments come from ldmatrix, V's from
// ldmatrix.trans (rows padded by 16 bytes, so the eight rows of a matrix
// hit different banks); the score fragments of two 8-key slices are the
// A fragment of the next product as they stand. The tf32 fragments are
// plain 32-bit shared loads; there the key axis of p.V is permuted (A's
// k = c <-> key 2c, k = c + 4 <-> key 2c + 1, and V's rows alike), so no
// shuffle moves p between lanes.
//
// The head dim HD is a template parameter (a power of two from 8 to 256,
// or 224, gemma2-9b's 3584 / 16; chosen at launch by with_head_dim): 224
// is 14 k-steps of 16 for bf16 Q.K^T and 28 column slices of 8, and
// takes the 32-key (bf16) or 16-key (fp32) tiles of rows over 256 bytes.
// bf16 rows shorter than the mma's k of 16 are staged zero-padded to 16.
// The wrappers require 16-byte aligned tensors.
//
// The wide head (kWideHd = 320, gemma3-4b's 2560 / 8) has a block of its
// own (Layout::kWide). Its per-thread acc alone would be HD / 2 = 160
// registers, and the tile's p.V sums as many again: the design of the
// head dims up to 256 (which already spills at 224 and 256) cannot hold
// both. So the two warp groups split the output columns instead of the
// key tiles: warp (g, w) owns rows 16w .. 16w + 15 and columns
// 160g .. 160g + 159 (Layout::kCols) over every key tile, and each round
// stages one tile that both groups read. Both groups compute the whole
// Q.K^T of their rows (the same instructions on the same data: the same
// scores, m and l bit for bit), so nothing merges at the end: group g
// writes its columns, group 0 the m and l. The p.V of a tile runs in
// chunks of 80 columns (pv_wide), so a chunk's tile sums and V fragments
// sit beside the 80-register acc. Its bf16 Q.K^T sums each k-step from
// zeros and adds it to the score in fp32, as fp32 inputs do everywhere
// (a 320-long dot in the tensor core's own accumulator drifted past 2e-5
// on the card). Shared memory: the 64-row Q tile and
// kStages rounds of one 16-key K and V tile, 84 KB (bf16) or 166 KB
// (fp32), above the 48 KB default (allow_smem opts in). Its instances
// are built only in the wide libraries (FLASH_FIXED_HD=320,
// kernels/build.py: VARIANTS), so the instances up to 256 keep their code.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -2.0e38f;
constexpr float kMinM = -1.0e30f;
constexpr int kRows = 16;       // query rows of a warp (the mma's M)
constexpr int kWarps = 4;       // query warps of a key group (timed: 1, 2, 4)
constexpr int kKeyGroups = 2;   // key groups of a block: tiles 2r and 2r + 1
constexpr int kGroupThreads = kWarps * 32;
constexpr int kThreads = kGroupThreads * kKeyGroups;
constexpr int kBlockRows = kWarps * kRows;
constexpr int kStages = 2;      // rounds of tiles in flight (double buffering)
constexpr int kWideHd = 320;    // the wide libraries' head dim (gemma3-4b)

// The head dim of a library's instances: 0, every head dim up to 256 that
// with_head_dim lists; or kWideHd alone, the wide library (the source
// built again with -DFLASH_FIXED_HD=320, kernels/build.py: VARIANTS).
#ifndef FLASH_FIXED_HD
#define FLASH_FIXED_HD 0
#endif
static_assert(FLASH_FIXED_HD == 0 || FLASH_FIXED_HD == kWideHd,
              "FLASH_FIXED_HD: 0 or the wide head dim");

// Calls f(std::integral_constant<int, HD>()) for a supported head dim and
// returns its result; cudaErrorInvalidValue for any other.
template <typename F>
int with_head_dim(int hd, F&& f) {
#if FLASH_FIXED_HD
  if (hd == FLASH_FIXED_HD)
    return f(std::integral_constant<int, FLASH_FIXED_HD>());
#else
  switch (hd) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 224: return f(std::integral_constant<int, 224>());
    case 256: return f(std::integral_constant<int, 256>());
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// The staged row layout of element type T at head dim HD.
template <typename T, int HD>
struct Layout {
  static_assert(HD == 8 || (HD % 16 == 0 && HD <= 256) || HD == kWideHd,
                "head dim");
  // the wide block: the warp groups split the columns, not the key tiles
  static constexpr bool kWide = HD > 256;
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kVec = 16 / sizeof(T);               // T per copy
  static constexpr int kDim = (kBf16 && HD < 16) ? 16 : HD;  // staged width
  static constexpr int kStride = kDim + kVec;                // +16 bytes
  static constexpr int kVecs = kDim / kVec;                  // copies a row
  static constexpr int kLive = HD / kVec;                    // of real data
  // keys per tile: 64 where a row is at most 256 bytes (bf16 up to 128
  // wide), 32 up to 512 bytes, else 16, so every block fits (64 was faster
  // than 32 at the chunk's shapes on the card)
  static constexpr int kTs =
      sizeof(T) * HD <= 256 ? 64 : sizeof(T) * HD <= 512 ? 32 : 16;
  // key tiles a round: one per key group, or (wide) one both groups read
  static constexpr int kRoundTiles = kWide ? 1 : kKeyGroups;
  // output columns a warp accumulates: all, or (wide) its group's half
  static constexpr int kCols = kWide ? HD / kKeyGroups : HD;
  // the K and V tiles of kStages rounds of kRoundTiles tiles
  static constexpr size_t kTileBytes =
      static_cast<size_t>(2 * kStages * kRoundTiles * kTs) * kStride *
      sizeof(T);
  // Shared memory of a block, in bytes: the queries, then the tiles.
  static constexpr size_t kBytes =
      static_cast<size_t>(kBlockRows) * kStride * sizeof(T) + kTileBytes;
  // the tiles' space holds the key groups' exchange at the end (the wide
  // block has no exchange)
  static_assert(kWide ||
                    kTileBytes >= (HD / 2 + 4) * kGroupThreads * sizeof(float),
                "exchange");
};

// ------------------------------------------------------------- PTX ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 zero-fills them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, tf32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32: to nearest at 10 mantissa bits (ties away from zero),
// the low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 x): hi = tf32(x), lo = tf32(x - hi); x - hi is
// exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

// (x, y) = hi + mid + lo, each a packed bf16 pair (x in the low half):
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), every
// difference exact in fp32, so the three carry all 24 bits of x.
__device__ __forceinline__ void split_bf16x3(float x, float y, uint32_t& hi,
                                             uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ----------------------------------------------------------- staging ----
// Stage n_rows rows into dst (Layout's stride): row r from src(r) for
// r < n_valid, zeros past it and in the pad columns of a short bf16 row.
// Threads tid, tid + n_threads, ... each issue some 16-byte copies; the
// caller commits the group.
template <typename T, int HD, typename Src>
__device__ void stage_rows(T* dst, int n_rows, int n_valid, const Src& src,
                           int tid, int n_threads) {
  using L = Layout<T, HD>;
  for (int e = tid; e < n_rows * L::kVecs; e += n_threads) {
    const int r = e / L::kVecs, c = e - r * L::kVecs;
    const bool live = r < n_valid && c < L::kLive;
    const T* g = live ? src(r) + c * L::kVec : src(0);
    cp_async16(dst + r * L::kStride + c * L::kVec, g, live ? 16 : 0);
  }
}

// Stage n_rows int8 rows as T (codes are exact in bf16 and in tf32): row r
// from src(r) for r < n_valid, 8 codes a load, zeros past n_valid and in
// the pad columns of a short bf16 row; and each row's scale, scale(r), into
// sc (zero past n_valid). Plain loads and stores: the caller's barrier
// makes them visible.
template <typename T, int HD, typename Src, typename Scale>
__device__ void stage_codes(T* dst, float* sc, int n_rows, int n_valid,
                            const Src& src, const Scale& scale, int tid,
                            int n_threads) {
  using L = Layout<T, HD>;
  constexpr int kGroups = L::kDim / 8;     // 8-code groups of a staged row
  for (int e = tid; e < n_rows * kGroups; e += n_threads) {
    const int r = e / kGroups, c = e - r * kGroups;
    float f[8];
    if (r < n_valid && c * 8 < HD) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src(r) + c * 8);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = static_cast<float>(b[u]);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) f[u] = 0.f;
    }
    T* d = dst + r * L::kStride + c * 8;
    if constexpr (L::kBf16) {
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
        w[u] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      reinterpret_cast<float4*>(d)[0] = make_float4(f[0], f[1], f[2], f[3]);
      reinterpret_cast<float4*>(d)[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  for (int r = tid; r < n_rows; r += n_threads)
    sc[r] = r < n_valid ? scale(r) : 0.f;
}

// ------------------------------------------------------------- state ----
// A warp's 16 rows: this thread's rows g and g + 8 (index i = 0, 1).
template <int HD>
struct State {
  float m[2];
  float l[2];
  float acc[HD / 8][4];   // [slice n][c0 c1 (row g), c2 c3 (row g + 8)]

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
};

// The wide block's acc += p . V over its warp's kCols columns (``vs``:
// the tile's V rows from the warp's first column), in chunks of kPvCols
// columns: each chunk's tile product is summed in the tensor core from
// zeros and added to acc in fp32, with the operand splits of the blocks
// up to 256 (bf16: p in three bf16 pieces, 16 keys an mma, V's fragments
// by ldmatrix.trans; fp32: 3xTF32, 8 keys an mma on the permuted key
// axis). A chunk's sums over the tile's keys run in the same order as a
// whole row's would, so the chunking changes no bit.
template <typename T, int HD>
__device__ __forceinline__ void pv_wide(float (&s)[Layout<T, HD>::kTs / 8][4],
                                        const T* vs, int n_keys,
                                        State<Layout<T, HD>::kCols>& st) {
  using L = Layout<T, HD>;
  constexpr int kNt = L::kTs / 8;     // 8-key slices of the tile
  constexpr int kPvCols = 80;         // columns a chunk: 10 slices of 8
  static_assert(L::kCols % kPvCols == 0, "column chunks");
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  if constexpr (L::kBf16) {
    constexpr int kNp = kPvCols / 16;     // pairs of 8-column slices
#pragma unroll
    for (int c0 = 0; c0 < L::kCols; c0 += kPvCols) {
      float t[2 * kNp][4];
#pragma unroll
      for (int n = 0; n < 2 * kNp; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kNt / 2; ++j) {
        if (j * 16 >= n_keys) break;
        uint32_t pa[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* sp = s[2 * j + r / 2] + 2 * (r % 2);
          split_bf16x3(sp[0], sp[1], pa[0][r], pa[1][r], pa[2][r]);
        }
        uint32_t b[kNp][4];
#pragma unroll
        for (int np = 0; np < kNp; ++np)
          ldmatrix_x4_trans(b[np], vs + (j * 16 + lane % 8 +
                                         ((lane / 8) % 2) * 8) * L::kStride +
                                       c0 + np * 16 + (lane / 16) * 8);
#pragma unroll
        for (int piece = 2; piece >= 0; --piece)
#pragma unroll
          for (int np = 0; np < kNp; ++np) {
            mma_bf16(t[2 * np], pa[piece], b[np][0], b[np][1]);
            mma_bf16(t[2 * np + 1], pa[piece], b[np][2], b[np][3]);
          }
      }
#pragma unroll
      for (int n = 0; n < 2 * kNp; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st.acc[c0 / 8 + n][e] += t[n][e];
    }
  } else {
    uint32_t ph[kNt][4], pl[kNt][4];
#pragma unroll
    for (int kc = 0; kc < kNt; ++kc) {
      split_tf32(s[kc][0], ph[kc][0], pl[kc][0]);
      split_tf32(s[kc][2], ph[kc][1], pl[kc][1]);
      split_tf32(s[kc][1], ph[kc][2], pl[kc][2]);
      split_tf32(s[kc][3], ph[kc][3], pl[kc][3]);
    }
#pragma unroll
    for (int c0 = 0; c0 < L::kCols; c0 += kPvCols) {
      float t[kPvCols / 8][4];
#pragma unroll
      for (int n = 0; n < kPvCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kNt; ++kc) {
        if (kc * 8 >= n_keys) break;
#pragma unroll
        for (int n = 0; n < kPvCols / 8; ++n) {
          const T* v0 = vs + (kc * 8 + 2 * c) * L::kStride + c0 + n * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(to_f32(v0[0]), bh0, bl0);
          split_tf32(to_f32(v0[L::kStride]), bh1, bl1);
          mma_tf32(t[n], pl[kc], bh0, bh1);
          mma_tf32(t[n], ph[kc], bl0, bl1);
          mma_tf32(t[n], ph[kc], bh0, bh1);
        }
      }
#pragma unroll
      for (int n = 0; n < kPvCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st.acc[c0 / 8 + n][e] += t[n][e];
    }
  }
}

// One online-softmax update of a warp's 16 rows with the staged tile of
// n_keys keys. qs: the warp's 16 staged query rows; ks, vs: the tile's K
// and V rows; ``valid(r, j)`` masks (warp row r, tile key j); with kCap,
// ``cap`` != 0 caps each scaled score (the softcap mode; an instance
// without kCap has no such step at all). kScaled (an
// int8 cache, its codes staged as T: exact for |c| <= 127): ksc, vsc hold
// the tile keys' K and V row scales (zero past n_keys); the score is
// (q . codes) * ksc[j] * scale, and p * vsc[j] (the V row's dequantization
// moved onto p) enters p.V, split into its pieces after that product.
template <typename T, int HD, bool kScaled = false, bool kCap = true,
          typename Mask>
__device__ __forceinline__ void attend_tile(
    const T* qs, const T* ks, const T* vs, int n_keys, const Mask& valid,
    float scale, float cap, State<Layout<T, HD>::kCols>& st,
    const float* ksc = nullptr, const float* vsc = nullptr) {
  using L = Layout<T, HD>;
  constexpr int kNt = L::kTs / 8;  // 8-key slices of the tile
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;

  // scores: s[n] is rows (g, g + 8) x keys (8n + 2c, 8n + 2c + 1)
  float s[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (L::kBf16 && L::kWide) {
    // The wide head's 320-long dot: each k-step of 16 summed in the tensor
    // core from zeros and added to the score in fp32 (carried through the
    // tensor core's truncating accumulator over 20 k-steps, the state
    // drifted past 2e-5 at scores of std 4 on the card).
#pragma unroll
    for (int kk = 0; kk < L::kDim; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (lane % 16) * L::kStride + kk + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (n * 8 + lane % 8 + (lane / 16) * 8) *
                                L::kStride + kk + ((lane / 8) % 2) * 8);
        float z0[4] = {0.f, 0.f, 0.f, 0.f}, z1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(z0, a, b[0], b[1]);
        mma_bf16(z1, a, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] += z0[e];
          s[n + 1][e] += z1[e];
        }
      }
    }
  } else if constexpr (L::kBf16) {
#pragma unroll
    for (int kk = 0; kk < L::kDim; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (lane % 16) * L::kStride + kk + (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < kNt; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (n * 8 + lane % 8 + (lane / 16) * 8) *
                                L::kStride + kk + ((lane / 8) % 2) * 8);
        mma_bf16(s[n], a, b[0], b[1]);
        mma_bf16(s[n + 1], a, b[2], b[3]);
      }
    }
  } else {
    // The tensor core truncates its own sums: each k-step's three
    // products are summed there from zeros and added to the score in fp32
    // on the CUDA cores (the p.V rule below).
#pragma unroll 4
    for (int kk = 0; kk < HD; kk += 8) {
      const T* qr = qs + g * L::kStride + kk + c;
      uint32_t ah[4], al[4];
      split_tf32(to_f32(qr[0]), ah[0], al[0]);
      split_tf32(to_f32(qr[8 * L::kStride]), ah[1], al[1]);
      split_tf32(to_f32(qr[4]), ah[2], al[2]);
      split_tf32(to_f32(qr[8 * L::kStride + 4]), ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const T* kr = ks + (n * 8 + g) * L::kStride + kk + c;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(to_f32(kr[0]), bh0, bl0);
        split_tf32(to_f32(kr[4]), bh1, bl1);
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(z, al, bh0, bh1);
        mma_tf32(z, ah, bl0, bl1);
        mma_tf32(z, ah, bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += z[e];
      }
    }
  }

  // scale, mask, running max, rescale, probabilities and sums; a row's
  // values sit in the four lanes of its group (xor 1, 2)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * c + (e & 1), r = g + (e >> 1) * 8;
      float x = kNegInf;
      if (j < n_keys && valid(r, j)) {
        if constexpr (kScaled) {
          x = s[n][e] * ksc[j] * scale;
        } else {
          x = s[n][e] * scale;
        }
        if constexpr (kCap) {                       // the softcap mode
          if (cap != 0.f) x = cap * tanhf(x / cap);
        }
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(fmaxf(st.m[i], mx[i]), kMinM);
    alpha[i] = expf(st.m[i] - m_new);
    st.m[i] = m_new;
  }
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[n][e] - st.m[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    st.l[i] = st.l[i] * alpha[i] + sum[i];
  }
  if constexpr (kScaled) {   // p.(codes * vs) as (p * vs).codes
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= vsc[n * 8 + 2 * c + (e & 1)];
  }
#pragma unroll
  for (int n = 0; n < L::kCols / 8; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }

  // acc += p . V. The tile's product for each 8-column slice n is summed
  // in the tensor core from zeros and added to acc in fp32 once a tile.
  if constexpr (L::kWide) {
    pv_wide<T, HD>(s, vs, n_keys, st);
  } else if constexpr (L::kBf16) {
    // p = p1 + p2 + p3 in bf16 (24 bits: p itself), 16 keys an mma. The
    // score fragments of key slices 2j, 2j + 1 are the A fragment of key
    // chunk j as they stand; V's B fragments come from ldmatrix.trans.
    // The loops run piece by piece over every slice, so 2 * kDim / 16
    // independent sums keep the tensor core busy (a chain per slice, one
    // mma after another, took most of the kernel's time).
    constexpr int kNp = L::kDim / 16;     // pairs of 8-column slices
    float t[2 * kNp][4];
#pragma unroll
    for (int n = 0; n < 2 * kNp; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNt / 2; ++j) {
      if (j * 16 >= n_keys) break;
      uint32_t pa[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* sp = s[2 * j + r / 2] + 2 * (r % 2);
        split_bf16x3(sp[0], sp[1], pa[0][r], pa[1][r], pa[2][r]);
      }
      uint32_t b[kNp][4];
#pragma unroll
      for (int np = 0; np < kNp; ++np)
        ldmatrix_x4_trans(b[np], vs + (j * 16 + lane % 8 +
                                       ((lane / 8) % 2) * 8) * L::kStride +
                                     np * 16 + (lane / 16) * 8);
#pragma unroll
      for (int piece = 2; piece >= 0; --piece)
#pragma unroll
        for (int np = 0; np < kNp; ++np) {
          mma_bf16(t[2 * np], pa[piece], b[np][0], b[np][1]);
          mma_bf16(t[2 * np + 1], pa[piece], b[np][2], b[np][3]);
        }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[n][e] += t[n][e];
  } else {
    // fp32: 3xTF32, 8 keys an mma (A's k = c <-> key 2c, c + 4 <-> 2c + 1)
    uint32_t ph[kNt][4], pl[kNt][4];
#pragma unroll
    for (int kc = 0; kc < kNt; ++kc) {
      split_tf32(s[kc][0], ph[kc][0], pl[kc][0]);
      split_tf32(s[kc][2], ph[kc][1], pl[kc][1]);
      split_tf32(s[kc][1], ph[kc][2], pl[kc][2]);
      split_tf32(s[kc][3], ph[kc][3], pl[kc][3]);
    }
    float t[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kNt; ++kc) {
      if (kc * 8 >= n_keys) break;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const T* v0 = vs + (kc * 8 + 2 * c) * L::kStride + n * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(to_f32(v0[0]), bh0, bl0);
        split_tf32(to_f32(v0[L::kStride]), bh1, bl1);
        mma_tf32(t[n], pl[kc], bh0, bh1);
        mma_tf32(t[n], ph[kc], bl0, bl1);
        mma_tf32(t[n], ph[kc], bh0, bh1);
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.acc[n][e] += t[n][e];
  }
}

// Merge the two key groups' states of each row into group 0's threads
// (the state merge: m = max(m0, m1), c_g = exp(m_g - m), l and acc summed
// with those factors; a group that saw no key holds the exact identity,
// and two identities stay one). ``xch``: (HD / 2 + 4) * kGroupThreads
// floats of shared memory no thread still reads. Starts and ends with
// every thread of the block at a barrier.
template <int HD>
__device__ void merge_key_groups(State<HD>& st, float* xch) {
  const int g = threadIdx.x / kGroupThreads;
  const int t = threadIdx.x - g * kGroupThreads;
  constexpr int kAcc = HD / 2;   // this thread's acc values
  if (g == 1) {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(n * 4 + e) * kGroupThreads + t] = st.acc[n][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xch[(kAcc + i) * kGroupThreads + t] = st.m[i];
      xch[(kAcc + 2 + i) * kGroupThreads + t] = st.l[i];
    }
  }
  __syncthreads();
  if (g == 0) {
    float c0[2], c1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = xch[(kAcc + i) * kGroupThreads + t];
      const float l1 = xch[(kAcc + 2 + i) * kGroupThreads + t];
      const float m = fmaxf(st.m[i], m1);
      c0[i] = expf(st.m[i] - m);
      c1[i] = expf(m1 - m);
      st.l[i] = st.l[i] * c0[i] + l1 * c1[i];
      st.m[i] = m;
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st.acc[n][e] = st.acc[n][e] * c0[e >> 1] +
                       xch[(n * 4 + e) * kGroupThreads + t] * c1[e >> 1];
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Write a warp's rows (t = r0 + row < n_q, r0 its first row in the
// sequence) of (b, h). With ``out``: the finalized acc / max(l, 1e-37)
// into out (B, n_q, H, HD); else the head-major state m, l (B, H, n_q)
// and acc (B, H, n_q, HD), a row with l == 0 (no visible key: every
// visible key adds exp(0) = 1 at its max) as the exact merge identity,
// m = -2e38, whichever tiles it went through. The wide block: the warp's
// column group (threadIdx.x / kGroupThreads) writes its kCols columns,
// group 0 the m and l.
template <typename T, int HD>
__device__ void store_rows(const State<Layout<T, HD>::kCols>& st, int b,
                           int h, int r0, int n_q, int H, T* out,
                           float* m_out, float* l_out, float* acc_out) {
  using L = Layout<T, HD>;
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const int col0 = L::kWide ? threadIdx.x / kGroupThreads * L::kCols : 0;
  const size_t bh = static_cast<size_t>(b) * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + g + 8 * i;
    if (t >= n_q) continue;
    if (out == nullptr) {
      if (c == 0 && col0 == 0) {
        m_out[bh * n_q + t] = st.l[i] > 0.f ? st.m[i] : kNegInf;
        l_out[bh * n_q + t] = st.l[i];
      }
      float* row = acc_out + (bh * n_q + t) * HD + col0 + 2 * c;
#pragma unroll
      for (int n = 0; n < L::kCols / 8; ++n)
        store2(row + n * 8, st.acc[n][2 * i], st.acc[n][2 * i + 1]);
    } else {
      const float den = fmaxf(st.l[i], 1e-37f);
      T* row = out + ((static_cast<size_t>(b) * n_q + t) * H + h) * HD +
               col0 + 2 * c;
#pragma unroll
      for (int n = 0; n < L::kCols / 8; ++n)
        store2(row + n * 8, st.acc[n][2 * i] / den,
               st.acc[n][2 * i + 1] / den);
    }
  }
}

// Raise the kernel's dynamic shared memory limit when it needs more than
// the default 48 KB. Returns the cudaError_t of the attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

inline float inv_sqrt_hd(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

}  // namespace flash
