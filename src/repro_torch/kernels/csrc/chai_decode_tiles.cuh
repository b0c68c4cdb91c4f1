// Tile steps of the one-pass fused clustered decode (CHAI STEADY
// attention), shared by the dense kernel (chai_fused_decode.cu) and the
// paged kernel (paged_chai_fused_decode.cu).
//
// Both kernels run the same block body, ``decode_block``, over a "where is
// tile t" object: ``DenseTiles`` for a (B, rows, S, hd) cache, ``PagedTiles``
// for (nP, rows, page, hd) pools read through block tables. The arithmetic
// and its order are the same code in both, so at equal tile size (dense
// ts == page) the two kernels are bitwise equal.
//
// The relay kernel (relay_prefix_decode.cu) runs the same row body,
// ``attend_row``, over a packed prefix with its own routing maps.
//
// Per block (b, j): rep j's masked scores against its K row, the online
// softmax state (running max m, sum l) over tiles in order, and
// acc = acc * alpha_t + p_t . V_t for every member head h with
// h2c[b, h] == j. Arithmetic follows the TPU tile body step for step:
// scale 1/sqrt(hd), mask idx <= pos (and pos - idx < window when
// window > 0) to -2e38, the running max clamped >= -1e30, alpha =
// exp(m_prev - m_new), p = exp(sc - m_new), l = l * alpha + sum(p), one
// update per tile; output acc[h] / max(l, 1e-37), or in the state mode
// (emit_state) m, l and the raw acc[h]. K/V elements are fp32 or
// bf16, all math in fp32. Rep j reads K row j / reps_per_group; head h
// reads V row h / v_rep (GQA). Tiles past pos are skipped: they are fully
// masked and would leave m, l and acc bitwise unchanged.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace chai {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Dense cache (B, rows, S, hd): tile t of row r of batch b starts at
// position t * ts, rows of hd elements one after another.
template <typename T>
struct DenseTiles {
  const T* k;
  const T* v;
  int kv_k, kv_v, s, ts, hd, b;
  __device__ const T* k_tile(int row, int t) const {
    return k + ((static_cast<size_t>(b) * kv_k + row) * s +
                static_cast<size_t>(t) * ts) * hd;
  }
  __device__ const T* v_tile(int row, int t) const {
    return v + ((static_cast<size_t>(b) * kv_v + row) * s +
                static_cast<size_t>(t) * ts) * hd;
  }
};

// Page pools (nP, rows, page, hd): tile t of batch row b is page bt[t] of
// that row's block table (K and V have tables of their own), one page per
// tile. ``bt_k``/``bt_v`` point at the row's P entries.
template <typename T>
struct PagedTiles {
  const T* k;
  const T* v;
  const int* bt_k;
  const int* bt_v;
  int kv_k, kv_v, page, hd;
  __device__ const T* k_tile(int row, int t) const {
    return k + ((static_cast<size_t>(bt_k[t]) * kv_k + row) * page) * hd;
  }
  __device__ const T* v_tile(int row, int t) const {
    return v + ((static_cast<size_t>(bt_v[t]) * kv_v + row) * page) * hd;
  }
};

// Step 1: masked, scaled scores of tiles [0, n_live) into sc_s.
template <typename T, typename Tiles>
__device__ void tile_scores(const Tiles& tiles, int n_live, int ts, int hd,
                            const float* q_s, int k_row, int pos, int window,
                            float scale, float* sc_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < n_live * ts; g += kWarps) {
    const int t = g / ts, i = g - t * ts;
    const T* kr = tiles.k_tile(k_row, t) + static_cast<size_t>(i) * hd;
    float dot = 0.f;
    for (int d = lane; d < hd; d += 32) dot += q_s[d] * to_f32(kr[d]);
    dot = warp_sum(dot);
    if (lane == 0) {
      bool valid = g <= pos;
      if (window > 0) valid = valid && (pos - g) < window;
      sc_s[g] = valid ? dot * scale : kNegInf;
    }
  }
}

// Step 2: the online-softmax recurrence over tiles, in tile order:
// m_new = max(m, max(tile), -1e30), alpha_t = exp(m - m_new), scores ->
// p = exp(sc - m_new) in place, l = l * alpha_t + sum(p_t). Leaves alpha_s
// and returns l (same value in every thread).
__device__ inline float softmax_scan(int n_live, int ts, float* sc_s,
                                     float* alpha_s, float* m_s,
                                     float* stat_s, float* l_s) {
  for (int t = threadIdx.x; t < n_live; t += kThreads) {
    float mx = kNegInf;
    for (int j = 0; j < ts; ++j) mx = fmaxf(mx, sc_s[t * ts + j]);
    stat_s[t] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = kNegInf;
    for (int t = 0; t < n_live; ++t) {
      const float m_new = fmaxf(fmaxf(m, stat_s[t]), -1e30f);
      alpha_s[t] = expf(m - m_new);
      m_s[t] = m_new;
      m = m_new;
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < n_live * ts; g += kThreads)
    sc_s[g] = expf(sc_s[g] - m_s[g / ts]);
  __syncthreads();
  for (int t = threadIdx.x; t < n_live; t += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < ts; ++j) sum += sc_s[t * ts + j];
    stat_s[t] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int t = 0; t < n_live; ++t) l = l * alpha_s[t] + stat_s[t];
    *l_s = l;
  }
  __syncthreads();
  return *l_s;
}

// Step 3: for output elements (d, d + 1) of member head h,
// acc = acc * alpha_t + sum_j p[t, j] * V[h / v_rep, t * ts + j, d:d+2].
template <typename T, typename Tiles>
__device__ float2 tile_av(const Tiles& tiles, int n_live, int ts, int hd,
                          int v_row, int d, const float* p_s,
                          const float* alpha_s) {
  float2 acc = make_float2(0.f, 0.f);
  for (int t = 0; t < n_live; ++t) {
    const T* vt = tiles.v_tile(v_row, t) + d;
    const float* p = p_s + t * ts;
    float2 pv = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < ts; ++j) {
      const float2 vv = load2(vt + static_cast<size_t>(j) * hd);
      pv.x += p[j] * vv.x;
      pv.y += p[j] * vv.y;
    }
    acc.x = acc.x * alpha_s[t] + pv.x;
    acc.y = acc.y * alpha_s[t] + pv.y;
  }
  return acc;
}

// Dynamic shared memory the block body needs, in bytes: the query row
// (hd), every score of the row (n_tiles * ts), three per-tile scalars and
// the member list (n_map entries).
__host__ __device__ inline size_t block_smem_bytes(int hd, int n_tiles,
                                                   int ts, int n_map) {
  return (static_cast<size_t>(hd) + static_cast<size_t>(n_tiles) * ts +
          3 * static_cast<size_t>(n_tiles)) * sizeof(float) +
         static_cast<size_t>(n_map) * sizeof(int);
}

// The accumulator rows one block owns: entry e of ``map`` (n entries) is
// a member iff map[e] == row; its acc row is e, written at out + e * hd,
// and it reads V row ``v_rows[e]``, or e / v_rep when v_rows is null.
struct Members {
  const int* map;
  const int* v_rows;
  int n, row, v_rep;
};

// One query row against one K row, every member acc row of it: scores
// over positions 0..pos (and pos - idx < window when window > 0), the
// online softmax over tiles in order, and per member the AV sum. Writes
// acc / max(l, 1e-37) per member, or in the state mode (kEmit) the
// unnormalized state instead: the row's m (the final running max,
// clamped >= -1e30; -1e30 when no tile is live) and l to m_out/l_out and
// the raw acc per member. A row with no member writes nothing in the
// finalized mode and only its m and l in the state mode. The mode is a
// template parameter, so the finalized kernels carry no state-mode code.
// Starts with a barrier of its own, so a caller may fill shared memory
// past block_smem_bytes (the paged kernel's block-table rows) just
// before.
template <typename T, bool kEmit, typename Tiles>
__device__ void attend_row(const Tiles& tiles, const float* q, int k_row,
                           int pos, int window, const Members mem,
                           float* out, float* m_out, float* l_out,
                           int n_tiles, int ts, int hd, float scale,
                           float* smem) {
  float* q_s = smem;                                     // hd
  float* sc_s = q_s + hd;                                // n_tiles * ts
  float* alpha_s = sc_s + static_cast<size_t>(n_tiles) * ts;  // n_tiles
  float* m_s = alpha_s + n_tiles;                        // n_tiles
  float* stat_s = m_s + n_tiles;                         // n_tiles
  int* members = reinterpret_cast<int*>(stat_s + n_tiles);  // mem.n
  __shared__ int n_mem_s;
  __shared__ float l_s;

  if (threadIdx.x == 0) {
    int n = 0;
    for (int e = 0; e < mem.n; ++e)
      if (mem.map[e] == mem.row) members[n++] = e;
    n_mem_s = n;
  }
  for (int d = threadIdx.x; d < hd; d += kThreads) q_s[d] = q[d];
  __syncthreads();
  const int n_mem = n_mem_s;
  if (n_mem == 0 && !kEmit) return;  // no member: nothing to compute

  const int n_live = pos < 0 ? 0 : min(pos / ts, n_tiles - 1) + 1;
  tile_scores<T>(tiles, n_live, ts, hd, q_s, k_row, pos, window, scale, sc_s);
  __syncthreads();
  const float l = softmax_scan(n_live, ts, sc_s, alpha_s, m_s, stat_s, &l_s);
  if (kEmit && threadIdx.x == 0) {
    *m_out = n_live ? m_s[n_live - 1] : -1e30f;
    *l_out = l;
  }
  const float denom = fmaxf(l, 1e-37f);

  const int pairs = hd / 2;
  for (int e = threadIdx.x; e < n_mem * pairs; e += kThreads) {
    const int i = e / pairs, d = 2 * (e - i * pairs);
    const int a = members[i];
    const int v_row = mem.v_rows ? mem.v_rows[a] : a / mem.v_rep;
    const float2 acc = tile_av<T>(tiles, n_live, ts, hd, v_row, d, sc_s,
                                  alpha_s);
    float* o = out + static_cast<size_t>(a) * hd + d;
    if (kEmit) {
      o[0] = acc.x;
      o[1] = acc.y;
    } else {
      o[0] = acc.x / denom;
      o[1] = acc.y / denom;
    }
  }
}

// The decode kernels' block (b = blockIdx.y, rep j = blockIdx.x): rep j's
// query, K row j / rpg, the heads h with h2c[b, h] == j, V row h / v_rep,
// output rows out[b, h]; the state mode (kEmit) writes m[b, j] and
// l[b, j] too (the relay decode's suffix pass).
template <typename T, bool kEmit, typename Tiles>
__device__ void decode_block(const Tiles& tiles, const float* q,
                             const int* h2c, const int* pos, float* out,
                             float* m, float* l, int R, int H, int n_tiles,
                             int ts, int hd, int rpg, int v_rep, int window,
                             float scale, float* smem) {
  const int j = blockIdx.x, b = blockIdx.y;
  const size_t row = static_cast<size_t>(b) * R + j;
  const Members mem{h2c + static_cast<size_t>(b) * H, nullptr, H, j, v_rep};
  attend_row<T, kEmit>(tiles, q + row * hd, j / rpg, pos[b], window, mem,
                       out + static_cast<size_t>(b) * H * hd, m + row,
                       l + row, n_tiles, ts, hd, scale, smem);
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

}  // namespace chai
