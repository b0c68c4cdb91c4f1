// Tile steps of the prefill attention kernels, shared by flash_prefill.cu
// (causal attention of a chunk over its own keys) and
// paged_prefix_attend.cu (the chunk's queries over the pages that earlier
// chunks wrote).
//
// One block owns kTq query rows of one (batch, head). It walks its key
// tiles of kTs keys in order (the Pallas grid's sequential kv axis becomes
// this loop), staging each tile's K and V rows in shared memory as fp32,
// and keeps the online-softmax state per query row: the running max m
// (shared memory), the sum l (shared memory) and the accumulator acc
// (registers: kTq * HD / kThreads elements per thread). Arithmetic follows
// the TPU tile body step for step: scores q.k * 1/sqrt(hd), masked
// positions -2e38, m_new = max(m, max(tile), -1e30), alpha =
// exp(m - m_new), p = exp(sc - m_new), l = l * alpha + sum(p),
// acc = acc * alpha + p.V, one update per tile. A row that sees no tile
// keeps m = -2e38, l = 0, acc = 0, the exact identity of the state merge.
// Q/K/V elements are fp32 or bf16; all math is fp32.
//
// The head dim HD is a template parameter (a power of two from 8 to 256,
// chosen at launch by with_head_dim), so every index of the tile steps is a
// constant shift: with a runtime head dim, the accumulator update's
// indexing took most of the kernel's time. Rows are staged with 16-byte
// loads, kBatch of them in flight per thread before any is stored. The
// wrappers require 16-byte aligned tensors.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace flash {

constexpr float kNegInf = -2.0e38f;
constexpr float kMinM = -1.0e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTq = 16;                          // query rows per block
constexpr int kTs = 64;                          // keys per tile
constexpr int kBatch = 8;                        // row loads in flight

// Calls f(std::integral_constant<int, HD>()) for a supported head dim and
// returns its result; cudaErrorInvalidValue for any other.
template <typename F>
int with_head_dim(int hd, F&& f) {
  switch (hd) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The thread's accumulator slots: slot i is element e = tid + i * kThreads
// of the kTq x HD output tile, row e / HD and column e % HD.
template <int HD>
struct Acc {
  static_assert(HD >= 8 && HD <= 256 && (HD & (HD - 1)) == 0, "head dim");
  static constexpr int kSlots = kTq * HD / kThreads;
  __device__ static int row(int i) {
    if constexpr (HD <= kThreads)
      return threadIdx.x / HD + i * (kThreads / HD);
    else
      return i / (HD / kThreads);
  }
  __device__ static int col(int i) {
    if constexpr (HD <= kThreads)
      return threadIdx.x % HD;
    else
      return threadIdx.x + (i % (HD / kThreads)) * kThreads;
  }
};

// The block's shared memory. K rows are padded to HD + 4 floats: rows stay
// 16-byte aligned, and the threads of a warp, which score consecutive keys
// against one query row with 16-byte reads, hit different banks.
template <int HD>
struct Tile {
  static constexpr int kKStride = HD + 4;
  float* q;      // kTq x HD
  float* k;      // kTs x kKStride
  float* v;      // kTs x HD
  float* s;      // kTq x kTs scores, then probabilities
  float* m;      // kTq running max
  float* l;      // kTq running sum
  float* alpha;  // kTq rescale of the current tile

  __host__ __device__ static constexpr size_t bytes() {
    return (static_cast<size_t>(kTq) * HD +
            static_cast<size_t>(kTs) * kKStride +
            static_cast<size_t>(kTs) * HD + kTq * kTs + 3 * kTq) *
           sizeof(float);
  }
  __device__ explicit Tile(float* smem)
      : q(smem),
        k(q + kTq * HD),
        v(k + kTs * kKStride),
        s(v + kTs * HD),
        m(s + kTq * kTs),
        l(m + kTq),
        alpha(l + kTq) {}
};

// 16 bytes of T (4 floats or 8 bf16) as fp32 to dst (16-byte aligned).
__device__ __forceinline__ void unpack16(const uint4& raw, const float*,
                                         float* dst) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                  __uint_as_float(raw.z), __uint_as_float(raw.w));
}
__device__ __forceinline__ void unpack16(const uint4& raw,
                                         const __nv_bfloat16*, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage n_rows rows of HD elements as fp32 into dst (row stride ``stride``
// floats, a multiple of 4): row r from src(r) for r < n_valid, zeros past
// it. 16-byte loads, kBatch per thread in flight before the first is stored.
template <typename T, int HD, typename Src>
__device__ void stage_rows(float* dst, int stride, int n_rows, int n_valid,
                           const Src& src) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  const int n_vec = n_rows * kPerRow;
  for (int base = threadIdx.x; base < n_vec; base += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads, r = e / kPerRow;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n_vec && r < n_valid)
        raw[u] = *reinterpret_cast<const uint4*>(src(r) +
                                                 (e % kPerRow) * kVec);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * kThreads;
      if (e < n_vec)
        unpack16(raw[u], static_cast<const T*>(nullptr),
                 dst + (e / kPerRow) * stride + (e % kPerRow) * kVec);
    }
  }
}

// Query rows q0 .. q0 + kTq - 1 of (b, h) from q (B, n_q, H, HD), zero past
// n_q; m = -2e38, l = 0.
template <typename T, int HD>
__device__ void load_queries(const Tile<HD>& sm, const T* q, int b, int h,
                             int q0, int n_q, int H) {
  stage_rows<T, HD>(sm.q, HD, kTq, n_q - q0, [&](int r) {
    return q + ((static_cast<size_t>(b) * n_q + q0 + r) * H + h) * HD;
  });
  for (int r = threadIdx.x; r < kTq; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// Stage keys k0 .. k0 + n_keys - 1 into the tile as fp32; rows past n_keys
// are zero. ``rows.krow(j)`` / ``rows.vrow(j)`` locate key j's K and V rows.
template <typename T, int HD, typename Rows>
__device__ void load_keys(const Tile<HD>& sm, const Rows& rows, int k0,
                          int n_keys) {
  stage_rows<T, HD>(sm.k, Tile<HD>::kKStride, kTs, n_keys,
                    [&](int j) { return rows.krow(k0 + j); });
  stage_rows<T, HD>(sm.v, HD, kTs, n_keys,
                    [&](int j) { return rows.vrow(k0 + j); });
}

// One online-softmax update of the block's rows with the staged tile of
// n_keys keys; ``valid(r, j)`` masks (query row r, tile key j). Starts after
// a barrier that published the tile; ends with one, so the next tile may be
// staged at once.
template <int HD, typename Mask>
__device__ void attend_tile(const Tile<HD>& sm, int n_keys,
                            const Mask& valid, float scale,
                            float (&acc)[Acc<HD>::kSlots]) {
  using A = Acc<HD>;
  // scores: four partial sums over 16-byte reads of the q and k rows
  for (int e = threadIdx.x; e < kTq * kTs; e += kThreads) {
    const int r = e / kTs, j = e % kTs;
    float sc = kNegInf;
    if (j < n_keys && valid(r, j)) {
      const float4* qr = reinterpret_cast<const float4*>(sm.q + r * HD);
      const float4* kr = reinterpret_cast<const float4*>(
          sm.k + j * Tile<HD>::kKStride);
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int d = 0; d < HD / 4; ++d) {
        const float4 a = qr[d], c = kr[d];
        d0 = fmaf(a.x, c.x, d0);
        d1 = fmaf(a.y, c.y, d1);
        d2 = fmaf(a.z, c.z, d2);
        d3 = fmaf(a.w, c.w, d3);
      }
      sc = ((d0 + d1) + (d2 + d3)) * scale;
    }
    sm.s[e] = sc;
  }
  __syncthreads();
  // running max, rescale, probabilities and sum: one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTq; r += kWarps) {
    float* sr = sm.s + r * kTs;
    float mx = kNegInf;
    for (int j = lane; j < kTs; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    const float m_prev = sm.m[r];
    const float m_new = fmaxf(fmaxf(m_prev, mx), kMinM);
    float sum = 0.f;
    for (int j = lane; j < kTs; j += 32) {
      const float p = expf(sr[j] - m_new);
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_new);
      sm.alpha[r] = a;
      sm.l[r] = sm.l[r] * a + sum;
      sm.m[r] = m_new;
    }
  }
  __syncthreads();
  // acc = acc * alpha + p . V over the tile's keys
  float pv[A::kSlots];
#pragma unroll
  for (int i = 0; i < A::kSlots; ++i) pv[i] = 0.f;
  for (int j = 0; j < n_keys; ++j) {
    const float* vj = sm.v + j * HD;
    const float* pj = sm.s + j;
#pragma unroll
    for (int i = 0; i < A::kSlots; ++i)
      pv[i] = fmaf(pj[A::row(i) * kTs], vj[A::col(i)], pv[i]);
  }
#pragma unroll
  for (int i = 0; i < A::kSlots; ++i)
    acc[i] = acc[i] * sm.alpha[A::row(i)] + pv[i];
  __syncthreads();
}

// Write the block's rows (t = q0 + r < n_q) of (b, h). With ``out``: the
// finalized acc / max(l, 1e-37) into out (B, n_q, H, HD); else the
// head-major state m, l (B, H, n_q) and acc (B, H, n_q, HD). Starts after a
// barrier that published m and l.
template <typename T, int HD>
__device__ void store_rows(const Tile<HD>& sm,
                           const float (&acc)[Acc<HD>::kSlots], int b, int h,
                           int q0, int n_q, int H, T* out, float* m_out,
                           float* l_out, float* acc_out) {
  using A = Acc<HD>;
  const size_t bh = static_cast<size_t>(b) * H + h;
  if (out == nullptr) {
    for (int r = threadIdx.x; r < kTq; r += kThreads) {
      if (q0 + r < n_q) {
        m_out[bh * n_q + q0 + r] = sm.m[r];
        l_out[bh * n_q + q0 + r] = sm.l[r];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < A::kSlots; ++i) {
    const int t = q0 + A::row(i);
    if (t >= n_q) continue;
    if (out == nullptr) {
      acc_out[(bh * n_q + t) * HD + A::col(i)] = acc[i];
    } else {
      const float x = acc[i] / fmaxf(sm.l[A::row(i)], 1e-37f);
      store_as(out + ((static_cast<size_t>(b) * n_q + t) * H + h) * HD +
                   A::col(i),
               x);
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
