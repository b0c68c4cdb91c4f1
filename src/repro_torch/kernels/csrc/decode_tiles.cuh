// Block body of the plain (MHA/GQA) flash decode, shared by the dense
// kernel (flash_decode.cu) and the paged kernel (paged_decode.cu).
//
// Both kernels run ``decode_block`` over a "where is the row of position
// idx" object: ``DenseRows`` for one (b, kv group) row of a (B, KV, S, hd)
// cache, ``PagedRows`` for (nP, KV, page, hd) pools read through the
// batch row's block tables (K and V have tables of their own). The
// arithmetic, the split plan and the merge order are the same code in
// both, so at equal tile size (dense ts == page) the two kernels are
// bitwise equal.
//
// The work unit is (batch row b, KV group g, head slice): the query heads
// [h0, h0 + nh) of group g (head h reads KV row h / (H / KV); at most 2 a
// slice), so each K/V row a block streams is read once for all of them. A
// block is (unit, S split s): the S axis is cut into n_split ranges of
// whole tiles (``tps`` tiles each, the last one shorter; the host's
// kernels/chai_attention.py split_plan, from the shapes alone, so the
// dense and the paged call cut alike). A block streams the live positions
// of its range, idx <= pos (and pos - idx < window when window > 0), in
// chunks of at most kChunk. Per chunk:
//   1. scores: two threads per position, each dotting every other 16
//      bytes of the K row with every query of the block, their halves
//      added by one shuffle; scale 1/sqrt(hd);
//   2. online softmax, one warp per head, over the whole chunk: m_new =
//      max(m, max(chunk), -1e30), alpha = exp(m - m_new), p = exp(sc -
//      m_new) in place, l = l * alpha + sum(p);
//   3. AV: a thread is (16 bytes of the row, position slice): it sums
//      p . V over its slice's positions for every head with 16-byte V
//      loads; the slices' partial sums meet in shared memory and are
//      added in slice order, acc = acc * alpha + sum.
// Those are the TPU tile body's steps (repro/kernels/flash_attention.py:
// _decode_kernel) with the chunk as its tile. A split with no live
// position reads nothing.
//
// Splits are merged inside the launch, as the fused CHAI decode does
// (chai_decode_tiles.cuh). With n_split > 1 every block writes its
// partial m, l and raw acc per head to fp32 scratch (an empty split
// writes m = -2e38, l = 0 and no acc), fences, and takes a ticket on its
// unit's counter. The unit's last block resets the counter, reads the
// partials in split order 0..n-1 past L1 (__ldcg) and combines them: m =
// max_s m_s (clamped >= -1e30), c_s = exp(m_s - m), l = sum_s l_s c_s,
// acc = sum_s acc_s c_s (a split with c_s == 0 is skipped, so an empty
// split's unwritten acc is never read), and writes acc / max(l, 1e-37).
// The order is fixed and there are no floating-point atomics, so two
// launches give the same bits. With n_split == 1 the block writes acc /
// max(l, 1e-37) itself.
//
// Shared memory is fixed (the block's queries, one chunk of scores, the
// AV partials and the merge factors: 11 KB at 2 heads), so no sequence
// length is too long.
//
// The widest head a block takes is a template constant, kHdMax: it sizes
// the block's query rows in shared memory and each thread's accumulator
// slots (kItems = ceil(kH * kHdMax / kThreads)). The kernels instantiate
// two: kMaxHd (256) for every head_dim up to 256, the code and resources
// every llama, nemotron and gemma2 launch keeps, and kWideHd (320), the
// wide-head instance gemma3-4b's global layers take (head_dim 2560 / 8);
// the launchers pick it for head_dim > 256. At 320 a bf16 row is 40 loads
// of 16 bytes, so the AV step runs 3 position slices of 40 threads (the
// last 8 threads idle) where 256 runs 4 of 32.

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
constexpr int kChunk = 64;      // positions per chunk (two threads each)
constexpr int kMaxHd = 256;     // head_dim: a multiple of 8, at most 256
constexpr int kWideHd = 320;    // the wide-head instance's widest head
constexpr int kRedVec = 8;      // floats of one AV partial (16 B of bf16)
constexpr int kMaxSplit = 64;   // S splits of one unit (split_plan's cap)

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

// The block's shared memory (static; mirrored by
// ``decode_block_smem_bytes`` in kernels/flash_attention.py).
template <int kH, int kHdMax>
struct BlockSmem {
  float q[kH * kHdMax];
  float sc[kH * kChunk];
  float red[kH * kThreads * kRedVec];
  float cmb[kH * kMaxSplit];
  float m[kH];
  float l[kH];
  float alpha[kH];
  int flag;
};

// How the S axis is cut: n_tiles tiles of ts positions, n_split ranges of
// tps tiles (the last may be shorter).
struct Plan {
  int n_split, tps, n_tiles, ts;
};

// The split scratch of a unit: split s's m, l of the block's head j at
// m[s * stride + j], its acc row at acc + (s * stride + j) * hd;
// ``counter`` is the unit's ticket counter (0 between launches). All null
// when n_split == 1.
struct Partials {
  float* m;
  float* l;
  float* acc;
  int stride;
  int* counter;
};

// The block: queries q (nh rows of hd <= kHdMax, fp32 or bf16 by
// ``q_bf16``), positions of split s of ``plan`` up to pos, output rows out
// (nh, hd) fp32.
template <typename T, int kH, int kHdMax, typename Rows>
__device__ void decode_block(const Rows& rows, const void* q, int q_bf16,
                             int pos, const Plan& plan, int s, int window,
                             int nh, int hd, float scale,
                             const Partials& part, float* out) {
  constexpr int kHW = (kH + kWarps - 1) / kWarps;   // heads per warp
  constexpr int kVec = Vec16<T>::n;
  // acc slots a thread
  constexpr int kItems = (kH * kHdMax + kThreads - 1) / kThreads;
  __shared__ BlockSmem<kH, kHdMax> sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kH * hd; e += kThreads) {
    float x = 0.f;
    if (e < nh * hd)
      x = q_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(q)[e])
                 : static_cast<const float*>(q)[e];
    sm.q[e] = x;
  }
  float m_w[kHW], l_w[kHW];
#pragma unroll
  for (int r = 0; r < kHW; ++r) {
    m_w[r] = kNegInf;
    l_w[r] = 0.f;
  }
  // acc slot i: head (tid + i * kThreads) / hd, column (...) % hd
  float acc[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) acc[i] = 0.f;
  __syncthreads();

  const int lo_all = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi_all = min(pos, plan.n_tiles * plan.ts - 1);
  const int lo = max(s * plan.tps * plan.ts, lo_all);
  const int hi = min(min(plan.n_tiles, (s + 1) * plan.tps) * plan.ts - 1,
                     hi_all);
  const int n_cg = hd / kVec;                 // 16-byte groups of a row
  const int nsl = kThreads / n_cg;            // AV position slices
  for (int c0 = lo; c0 <= hi; c0 += kChunk) {
    const int n = min(kChunk, hi - c0 + 1);

    // 1. scores of the chunk, two threads per position
    {
      const int i = tid / 2, half = tid % 2;
      float dot[kH];
#pragma unroll
      for (int j = 0; j < kH; ++j) dot[j] = 0.f;
      if (i < n) {
        const T* kr = rows.k_row(c0 + i);
#pragma unroll 4
        for (int d = half * kVec; d < hd; d += 2 * kVec) {
          float kv[kVec];
          Vec16<T>::load(kr + d, kv);
#pragma unroll
          for (int j = 0; j < kH; ++j)
#pragma unroll
            for (int u = 0; u < kVec; ++u)
              dot[j] += sm.q[j * hd + d + u] * kv[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kH; ++j)
        dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], 1);
      if (half == 0 && i < kChunk) {
#pragma unroll
        for (int j = 0; j < kH; ++j)
          sm.sc[j * kChunk + i] = i < n ? dot[j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // 2. the online-softmax update, one warp per head
#pragma unroll
    for (int r = 0; r < kHW; ++r) {
      const int j = warp + r * kWarps;
      if (j < nh) {
        float* sc = sm.sc + j * kChunk;
        float mx = kNegInf;
        for (int i = lane; i < kChunk; i += 32) mx = fmaxf(mx, sc[i]);
        mx = warp_max(mx);
        const float m_new = fmaxf(fmaxf(m_w[r], mx), -1e30f);
        const float alpha = expf(m_w[r] - m_new);
        float sum = 0.f;
        for (int i = lane; i < kChunk; i += 32) {
          const float p = i < n ? expf(sc[i] - m_new) : 0.f;
          sc[i] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        l_w[r] = l_w[r] * alpha + sum;
        m_w[r] = m_new;
        if (lane == 0) sm.alpha[j] = alpha;
      }
    }
    __syncthreads();

    // 3. AV: thread (group cg of 16 bytes, slice sl) over positions sl,
    //    sl + nsl, ... of the chunk; the slices' sums in slice order
    {
      const int cg = tid % n_cg, sl = tid / n_cg;
      float part[kH][kVec];
#pragma unroll
      for (int j = 0; j < kH; ++j)
#pragma unroll
        for (int x = 0; x < kVec; ++x) part[j][x] = 0.f;
      if (sl < nsl) {
        // bounded by the constant kChunk: nvcc's front end did not finish
        // on ``#pragma unroll 4`` over ``i < n`` here
        for (int i = sl; i < kChunk; i += nsl) {
          if (i >= n) break;
          float vv[kVec];
          Vec16<T>::load(rows.v_row(c0 + i) + cg * kVec, vv);
#pragma unroll
          for (int j = 0; j < kH; ++j) {
            const float w = sm.sc[j * kChunk + i];
#pragma unroll
            for (int x = 0; x < kVec; ++x) part[j][x] += w * vv[x];
          }
        }
#pragma unroll
        for (int j = 0; j < kH; ++j)
          if (j < nh)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              sm.red[(j * kThreads + tid) * kRedVec + x] = part[j][x];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      if (e < nh * hd) {
        const int j = e / hd, col = e - j * hd;
        const int cg = col / kVec, x = col - cg * kVec;
        float sum = 0.f;
        for (int sl = 0; sl < nsl; ++sl)
          sum += sm.red[(j * kThreads + sl * n_cg + cg) * kRedVec + x];
        acc[i] = acc[i] * sm.alpha[j] + sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kHW; ++r) {
    const int j = warp + r * kWarps;
    if (j < nh && lane == 0) {
      sm.m[j] = m_w[r];
      sm.l[j] = l_w[r];
    }
  }
  __syncthreads();
  if (plan.n_split == 1) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      if (e < nh * hd) out[e] = acc[i] / fmaxf(sm.l[e / hd], 1e-37f);
    }
    return;
  }

  // the partial state, then the ticket: every thread's writes are fenced
  // before thread 0 takes it; the unit's last block merges
  for (int j = tid; j < nh; j += kThreads) {
    part.m[s * part.stride + j] = sm.m[j];
    part.l[s * part.stride + j] = sm.l[j];
  }
  if (lo <= hi) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = tid + i * kThreads;
      if (e < nh * hd) {
        const int j = e / hd;
        part.acc[(static_cast<size_t>(s) * part.stride + j) * hd + e -
                 j * hd] = acc[i];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(part.counter, 1);
    const int last_block = ticket == plan.n_split - 1;
    if (last_block) {
      *part.counter = 0;
      __threadfence();
    }
    sm.flag = last_block;
  }
  __syncthreads();
  if (!sm.flag) return;

  const int ns = plan.n_split;
  for (int j = tid; j < nh; j += kThreads) {
    float m = -1e30f;
    for (int t = 0; t < ns; ++t)
      m = fmaxf(m, __ldcg(part.m + t * part.stride + j));
    sm.m[j] = m;
  }
  __syncthreads();
  for (int e = tid; e < nh * ns; e += kThreads) {
    const int j = e / ns, t = e - j * ns;
    sm.cmb[j * kMaxSplit + t] =
        expf(__ldcg(part.m + t * part.stride + j) - sm.m[j]);
  }
  __syncthreads();
  for (int j = tid; j < nh; j += kThreads) {
    float l = 0.f;
    for (int t = 0; t < ns; ++t)
      l += __ldcg(part.l + t * part.stride + j) * sm.cmb[j * kMaxSplit + t];
    sm.l[j] = l;
  }
  __syncthreads();
  for (int e = tid; e < nh * hd; e += kThreads) {
    const int j = e / hd, d = e - j * hd;
    const float* c = sm.cmb + j * kMaxSplit;
    float a = 0.f;
    for (int t = 0; t < ns; ++t)
      if (c[t] != 0.f)
        a += __ldcg(part.acc +
                    (static_cast<size_t>(t) * part.stride + j) * hd + d) *
             c[t];
    out[e] = a / fmaxf(sm.l[j], 1e-37f);
  }
}

inline float inv_sqrt_hd(int hd) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
}

// Launch ``Launch::run<kH, kHdMax>()`` with kH = hb heads a block, 1 or 2,
// and the instance of head dim hd: kMaxHd up to 256, kWideHd up to 320
// (else cudaErrorInvalidValue). Returns the launch's cudaError_t.
template <typename Launch>
int with_heads(int hb, int hd, const Launch& launch) {
  if (hd > kWideHd) return static_cast<int>(cudaErrorInvalidValue);
  if (hd > kMaxHd) {
    if (hb == 1) return launch.template run<1, kWideHd>();
    if (hb == 2) return launch.template run<2, kWideHd>();
  } else {
    if (hb == 1) return launch.template run<1, kMaxHd>();
    if (hb == 2) return launch.template run<2, kMaxHd>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flashdec
