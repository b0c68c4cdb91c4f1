// Block body of the plain (MHA/GQA) flash decode, shared by the dense
// kernel (flash_decode.cu) and the paged kernel (paged_decode.cu).
//
// Both kernels run ``decode_block`` over a "where is the row of position
// idx" object: ``DenseRows`` for one (b, kv group) row of a (B, KV, S, hd)
// cache, ``PagedRows`` for (nP, KV, page, hd) pools read through the
// batch row's block tables (K and V have tables of their own). The
// arithmetic and its order are the same code in both, so at equal tile
// size (dense ts == page) the two kernels are bitwise equal.
//
// One block serves the query heads [h0, h0 + nh) of one KV group g (head
// h reads KV row h / (H / KV)), so each K/V row it streams is read once
// for all of them. The S axis is streamed, never held whole: positions go
// through in chunks of kChunk (one per thread in the score phase), each
// chunk a whole number of online-softmax steps of ``step`` positions. Per
// chunk:
//   1. scores: thread i reads the K row of chunk position i with 16-byte
//      loads and computes its dot with every query of the block; scale
//      1/sqrt(hd), masked to -2e38 outside idx <= pos (and pos - idx <
//      window when window > 0);
//   2. online softmax, one warp per head, steps in order: m_new =
//      max(m, max(step), -1e30), alpha = exp(m - m_new), p = exp(sc -
//      m_new) in place, l = l * alpha + sum(p);
//   3. AV: thread d owns output element d of every head of the block, so
//      a V row is read once per block; per step acc = acc * alpha + p . V
//      over the step's positions, V rows loaded kBatch ahead.
// The output is acc / max(l, 1e-37), fp32. Those are the TPU tile body's
// steps (repro/kernels/flash_attention.py: _decode_kernel) with the
// kernel's step as its tile. Steps with no live position (past pos, or
// before pos - window + 1) are skipped: they would leave m, l and acc
// bitwise unchanged (a leading masked tile scales an all-zero state by
// alpha = 0). Masked positions of a live step read no K or V byte.
//
// Shared memory is fixed (the block's queries, one chunk of scores and
// its step scalars: about 16 KB at 8 heads), so no sequence length is
// too long.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace flashdec {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;     // positions per chunk; a step is <= kChunk
constexpr int kMaxHd = 256;     // head_dim: a multiple of 8, at most 256
constexpr int kBatch = 16;      // V rows loaded ahead in the AV phase

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of a row as floats: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// One (b, g) row of a dense cache: position idx at k + idx * hd.
template <typename T>
struct DenseRows {
  const T* k;
  const T* v;
  int hd;
  __device__ const T* k_row(int idx) const {
    return k + static_cast<size_t>(idx) * hd;
  }
  __device__ const T* v_row(int idx) const {
    return v + static_cast<size_t>(idx) * hd;
  }
};

// Group g of a page pool (nP, kv, page, hd): position idx of the batch
// row lives in page bt[idx / page] at row idx % page. ``bt_k``/``bt_v``
// point at the batch row's P entries.
template <typename T>
struct PagedRows {
  const T* pool;
  const int* bt_k;
  const int* bt_v;
  int kv, g, page, hd;
  __device__ const T* row(const int* bt, int idx) const {
    const int t = idx / page;
    return pool + ((static_cast<size_t>(bt[t]) * kv + g) * page +
                   (idx - t * page)) * static_cast<size_t>(hd);
  }
  __device__ const T* k_row(int idx) const { return row(bt_k, idx); }
  __device__ const T* v_row(int idx) const { return row(bt_v, idx); }
};

// The block: queries q (nh rows of hd, fp32 or bf16 by ``q_bf16``),
// positions 0 .. n_pos - 1 of ``rows``, output rows out (nh, hd) fp32.
// ``step`` divides the dense tile (and the page), and is <= kChunk.
template <typename T, int kH, typename Rows>
__device__ void decode_block(const Rows& rows, const void* q, int q_bf16,
                             int pos, int n_pos, int step, int window,
                             int nh, int hd, float scale, float* out) {
  constexpr int kHW = (kH + kWarps - 1) / kWarps;   // heads per warp
  __shared__ float q_s[kH * kMaxHd];
  __shared__ float sc_s[kH * kChunk];
  __shared__ float alpha_s[kH * kChunk];
  __shared__ float l_s[kH];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kH * hd; e += kThreads) {
    float x = 0.f;
    if (e < nh * hd)
      x = q_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(q)[e])
                 : static_cast<const float*>(q)[e];
    q_s[e] = x;
  }
  float m_w[kHW], l_w[kHW];
#pragma unroll
  for (int r = 0; r < kHW; ++r) {
    m_w[r] = kNegInf;
    l_w[r] = 0.f;
  }
  float acc[kH][2];
#pragma unroll
  for (int j = 0; j < kH; ++j) acc[j][0] = acc[j][1] = 0.f;
  __syncthreads();

  const int hi = min(pos, n_pos - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int spc = kChunk / step;            // steps per chunk
  const int chunk = spc * step;
  for (int c0 = hi >= lo ? (lo / step) * step : hi + 1; c0 <= hi;
       c0 += chunk) {
    const int n_steps = min(spc, (hi - c0) / step + 1);
    const int n = n_steps * step;

    // 1. scores of the chunk, one position per thread
    for (int i = tid; i < n; i += kThreads) {
      const int idx = c0 + i;
      const bool valid = idx >= lo && idx <= hi;
      float dot[kH];
#pragma unroll
      for (int j = 0; j < kH; ++j) dot[j] = 0.f;
      if (valid) {
        const T* kr = rows.k_row(idx);
#pragma unroll 4
        for (int d = 0; d < hd; d += Vec16<T>::n) {
          float kv[Vec16<T>::n];
          Vec16<T>::load(kr + d, kv);
#pragma unroll
          for (int j = 0; j < kH; ++j)
#pragma unroll
            for (int u = 0; u < Vec16<T>::n; ++u)
              dot[j] += q_s[j * hd + d + u] * kv[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kH; ++j)
        sc_s[j * kChunk + i] = valid ? dot[j] * scale : kNegInf;
    }
    __syncthreads();

    // 2. the online-softmax recurrence, one warp per head, steps in order
#pragma unroll
    for (int r = 0; r < kHW; ++r) {
      const int j = warp + r * kWarps;
      if (j < nh) {
        float* sc = sc_s + j * kChunk;
        for (int k = 0; k < n_steps; ++k) {
          float* st = sc + k * step;
          float mx = kNegInf;
          for (int i = lane; i < step; i += 32) mx = fmaxf(mx, st[i]);
          mx = warp_max(mx);
          const float m_new = fmaxf(fmaxf(m_w[r], mx), -1e30f);
          const float alpha = expf(m_w[r] - m_new);
          float sum = 0.f;
          for (int i = lane; i < step; i += 32) {
            const float p = expf(st[i] - m_new);
            st[i] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          l_w[r] = l_w[r] * alpha + sum;
          m_w[r] = m_new;
          if (lane == 0) alpha_s[j * kChunk + k] = alpha;
        }
      }
    }
    __syncthreads();

    // 3. AV: output element d of every head, V rows read once per block
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = tid + e * kThreads;
      if (d < hd) {
        for (int k = 0; k < n_steps; ++k) {
          const int s0 = c0 + k * step;
          const T* vb = rows.v_row(s0) + d;     // a step lies in one page
          const float* p = sc_s + k * step;
          float pv[kH];
#pragma unroll
          for (int j = 0; j < kH; ++j) pv[j] = 0.f;
          for (int i0 = 0; i0 < step; i0 += kBatch) {
            float vv[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int idx = s0 + i0 + u;
              vv[u] = (i0 + u < step && idx >= lo && idx <= hi)
                          ? to_f32(vb[static_cast<size_t>(i0 + u) * hd])
                          : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (i0 + u < step) {
#pragma unroll
                for (int j = 0; j < kH; ++j)
                  pv[j] += p[j * kChunk + i0 + u] * vv[u];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kH; ++j)
            acc[j][e] = acc[j][e] * alpha_s[j * kChunk + k] + pv[j];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kHW; ++r) {
    const int j = warp + r * kWarps;
    if (j < nh && lane == 0) l_s[j] = l_w[r];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int d = tid + e * kThreads;
    if (d < hd) {
#pragma unroll
      for (int j = 0; j < kH; ++j)
        if (j < nh) out[j * hd + d] = acc[j][e] / fmaxf(l_s[j], 1e-37f);
    }
  }
}

inline float inv_sqrt_hd(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

// Launch ``Launch::run<kH>()`` for the smallest kH in {1, 2, 4, 8} that
// holds hb heads (a block serves at most 8 query heads). Returns the
// launch's cudaError_t.
template <typename Launch>
int with_heads(int hb, const Launch& launch) {
  if (hb <= 1) return launch.template run<1>();
  if (hb <= 2) return launch.template run<2>();
  if (hb <= 4) return launch.template run<4>();
  return launch.template run<8>();
}

}  // namespace flashdec
