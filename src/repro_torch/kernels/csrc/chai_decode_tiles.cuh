// Block body of the one-pass fused clustered decode (CHAI STEADY
// attention), shared by the dense kernel (chai_fused_decode.cu), the paged
// kernel (paged_chai_fused_decode.cu) and the relay prefix kernel
// (relay_prefix_decode.cu).
//
// Every kernel runs ``unit_block`` over a "where is position idx of K/V
// row r" object: ``DenseTiles`` for a (rows, S, hd) cache, ``PagedTiles``
// for (nP, rows, page, hd) pools read through one batch row's block
// tables (K and V take tables of their own). The arithmetic and its order
// are the same code for both, so at equal tile size (dense ts == page) and
// one split plan the dense and paged kernels are bitwise equal.
//
// The work unit is (batch row b, K row g); a block is (unit, S split s,
// member slice z). A unit serves every rep j with j / reps_per_group == g
// (its nq <= kQ queries), so each K row is read once for all the reps that
// share it, and every member head h of those reps (h2c[b, h] == j),
// reading V row h / v_rep; slice z holds members [z * n_cap, (z + 1) *
// n_cap) of the unit's list, so a rep with many members (a WARMUP row of
// a mixed step puts all H heads in rep 0) spreads its V rows over several
// blocks, each computing the same scores. Slices past the unit's members
// return at once; slice 0 owns the queries' m and l. The S axis is cut
// into n_split ranges of whole tiles (``tps`` tiles each, the last one
// shorter); a block streams the positions of its range in chunks of at
// most kChunk, each chunk a whole number of online-softmax steps of
// ``step`` positions (a divisor of the tile, so a step never straddles a
// tile or a page). Per chunk:
//   1. scores: thread i reads the K row of chunk position i with 16-byte
//      loads and dots it with every query of the block; scale 1/sqrt(hd),
//      masked to -2e38 outside idx <= pos (and pos - idx < window when
//      window > 0);
//   2. online softmax, one warp per query, the chunk's steps in order:
//      m_new = max(m, max(step), -1e30), alpha = exp(m - m_new), p =
//      exp(sc - m_new), l = l * alpha + sum(p) (the recurrence of the
//      TPU tile body, repro/kernels/chai_attention.py: _fused_tile, the
//      step as its tile); then the step alphas fold into
//      weights w = p * prod(alphas of the later steps) and the chunk's
//      alpha product A, so that acc * A + sum(w . V) is the chunk's
//      per-step update acc = acc * alpha + p . V;
//   3. AV: a work item is (member, 16 bytes of its output row); with few
//      items the chunk's positions are cut into slices too, each item of
//      each slice one thread, V rows loaded kBatch ahead, the slices'
//      partial sums added in slice order through shared memory. The heads
//      of a GQA group that share a block read their group's V row each,
//      the repeats from L1 (DRAM once): one thread per row and element
//      accumulating all of them measured slower on the card (register
//      pressure and a reduction per member).
// Shared memory is fixed: the block's queries, one chunk of scores and
// step factors, n_cap accumulator rows, the member list and the chunk's
// block-table entries. Nothing grows with S.
//
// Splits are merged inside the launch. With n_split > 1 every block writes
// its partial m, l (per rep) and raw acc (per member head) to fp32
// scratch, fences, and takes a ticket on its unit's counter. The last
// block of a unit (of n_split x its live slices) to arrive resets the
// counter, reads the n_split partials in split order 0..n-1 past L1
// (__ldcg) and combines them: m = max_s m_s
// (clamped >= -1e30), c_s = exp(m_s - m), l = sum_s l_s c_s, acc_h =
// sum_s acc_h,s c_s. It writes acc / max(l, 1e-37) (an IEEE division) or,
// in the state mode (kEmit), m, l and the raw acc. The order is fixed and
// there are no floating-point atomics, so the result is the same bits from
// run to run. With n_split == 1 a block writes its state directly (the
// same values the merge of one split gives).
//
// Before the first chunk three jobs share one memory round trip: warp 0
// builds the member list, warp 1 stages the chunk's block-table entries
// (paged), warps 2-3 load the queries.
//
// A split, or a step, with no live position reads no byte and leaves the
// state unchanged; an empty split's partial is the merge identity
// (m = -2e38, l = 0; its acc is never read: its factor is 0). A unit
// whose reps have no member writes nothing in the finalized mode. A row
// with nothing live gives zeros (and m = -1e30, l = 0 in the state mode).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace chai {

constexpr float kNegInf = -2.0e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;       // positions per chunk; a step is <= kChunk
constexpr int kMaxQ = 8;          // rep queries of one K row (reps_per_group)
constexpr int kMaxHd = 256;       // head_dim: a multiple of 8, at most 256
constexpr int kMaxSplit = 64;     // S splits of one unit
constexpr int kSlice = 8;         // members (accumulator rows) of a block
constexpr int kBatch = 8;         // V rows loaded ahead by one AV thread
constexpr int kRedVec = 8;        // floats of one AV partial (16 B of bf16)
constexpr int kTab = kChunk + 2;  // block-table entries one chunk can touch
constexpr int kKUnroll = 8;       // K loads of one row issued together

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of a row: 4 fp32 or 8 bf16 values, loaded raw and unpacked to
// floats where they are used.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(const Raw& r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const Raw& r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// A dense cache (rows, S, hd) of one batch row (the relay: of one group):
// position idx of row r at (r * S + idx) * hd.
template <typename T>
struct DenseTiles {
  const T* k;
  const T* v;
  int s, hd;
  __device__ void locate(int, const int*) {}
  __device__ void fill(int, int, int*, int, int) const {}
  __device__ const T* k_pos(int row, int idx) const {
    return k + (static_cast<size_t>(row) * s + idx) * hd;
  }
  __device__ const T* v_pos(int row, int idx) const {
    return v + (static_cast<size_t>(row) * s + idx) * hd;
  }
};

// Page pools (nP, rows, page, hd): position idx of the batch row lives in
// page bt[idx / page] at row idx % page; ``bt_k``/``bt_v`` point at the
// row's P entries. ``fill`` copies the entries of the tiles a chunk
// touches into shared memory (``tab``: K entries, then V entries at
// + kTab; threads t0, t0 + stride, ... each load some) and ``locate``
// points every thread at them, so a position's address is one
// shared-memory read away.
template <typename T>
struct PagedTiles {
  const T* k;
  const T* v;
  const int* bt_k;
  const int* bt_v;
  int kv_k, kv_v, page, hd;
  int shift;   // log2(page) for a power of two (the engine's 16), else -1
  const int* tab;
  int t_base;
  __device__ int tile_of(int idx) const {
    return shift >= 0 ? idx >> shift : idx / page;
  }
  __device__ void locate(int c0, const int* tab_s) {
    t_base = tile_of(c0);
    tab = tab_s;
  }
  __device__ void fill(int c0, int n, int* tab_s, int t0, int stride) const {
    const int first_t = tile_of(c0);
    const int nt = tile_of(c0 + n - 1) - first_t + 1;
    for (int t = t0; t < nt; t += stride) {
      tab_s[t] = bt_k[first_t + t];
      tab_s[kTab + t] = bt_v[first_t + t];
    }
  }
  __device__ const T* at(const T* pool, int rows, int pid, int row,
                         int idx, int t) const {
    return pool + ((static_cast<size_t>(pid) * rows + row) * page +
                   (idx - t * page)) * static_cast<size_t>(hd);
  }
  __device__ const T* k_pos(int row, int idx) const {
    const int t = tile_of(idx);
    return at(k, kv_k, tab[t - t_base], row, idx, t);
  }
  __device__ const T* v_pos(int row, int idx) const {
    const int t = tile_of(idx);
    return at(v, kv_v, tab[kTab + t - t_base], row, idx, t);
  }
};

// Dynamic shared memory of a block, in bytes: floats (queries, a chunk of
// scores and of step factors per query, the AV partials, n_cap
// accumulator rows, the merge factors, m/l/A per query), then ints (the
// member list: acc row, query, V row per entry of the n_map-entry map;
// the chunk's block-table entries; n_mem and the merge flag). Mirrored by
// ``decode_launch_config`` in kernels/chai_attention.py.
__host__ __device__ inline size_t block_smem_bytes(int kq, int hd, int n_map,
                                                   int n_cap) {
  const size_t floats = static_cast<size_t>(kq) * hd + 2 * kq * kChunk +
                        kThreads * kRedVec + static_cast<size_t>(n_cap) * hd +
                        kq * kMaxSplit + 3 * kq;
  const size_t ints = 3 * static_cast<size_t>(n_map) + 2 * kTab + 2;
  return (floats + ints) * 4;
}

struct Smem {
  float *q, *sc, *fac, *red, *acc, *cmb, *m, *l, *ca;
  int *mem_a, *mem_q, *mem_v, *tab, *n_mem, *flag;
};

__device__ inline Smem carve(float* base, int kq, int hd, int n_map,
                             int n_cap) {
  Smem s;
  s.q = base;
  s.sc = s.q + kq * hd;
  s.fac = s.sc + kq * kChunk;
  s.red = s.fac + kq * kChunk;
  s.acc = s.red + kThreads * kRedVec;
  s.cmb = s.acc + static_cast<size_t>(n_cap) * hd;
  s.m = s.cmb + kq * kMaxSplit;
  s.l = s.m + kq;
  s.ca = s.l + kq;
  s.mem_a = reinterpret_cast<int*>(s.ca + kq);
  s.mem_q = s.mem_a + n_map;
  s.mem_v = s.mem_q + n_map;
  s.tab = s.mem_v + n_map;
  s.n_mem = s.tab + 2 * kTab;
  s.flag = s.n_mem + 1;
  return s;
}

// The accumulator rows of a unit: entry e of ``map`` (n entries) is a
// member iff map[e] / rpg == unit; it serves query map[e] - unit * rpg,
// its acc row is e and it reads V row ``v_rows[e]``, or e / v_rep when
// v_rows is null.
struct Members {
  const int* map;
  const int* v_rows;
  int n, rpg, unit, v_rep;
};

// Where a unit writes: acc row a at out + a * hd; the state mode's m and
// l of the block's query j at m[j], l[j].
struct Outputs {
  float* out;
  float* m;
  float* l;
};

// The split scratch of a unit: split s's m/l of query j at
// m[s * ml_stride + j], its acc row a at acc + s * acc_stride + a * hd;
// ``counter`` is the unit's ticket counter (0 between launches).
struct Partials {
  float* m;
  float* l;
  float* acc;
  int ml_stride;
  size_t acc_stride;
  int* counter;
};

// How the S axis is cut: n_tiles tiles of ts positions, n_split ranges of
// tps tiles (the last may be shorter), online-softmax steps of ``step``.
struct Plan {
  int n_split, tps, n_tiles, ts, step;
};

// Positions of the chunk that starts at c0 (a step boundary) in a range
// that ends at ``last``: whole steps, at most kChunk.
__device__ __forceinline__ int chunk_positions(int c0, int last, int step) {
  return min(kChunk / step, (last - c0) / step + 1) * step;
}

// The online-softmax state of positions [first, last] of K row ``k_row``
// for the block's nq queries (in sm.m / sm.l) and for members
// [mb0, mb0 + nmb) of the list (in sm.acc, row i for member mb0 + i),
// from the empty state. The first chunk's block-table entries are in
// sm.tab already (unit_block stages them). Ends with a barrier.
template <typename T, int kQ, typename Tiles>
__device__ void decode_range(Tiles& tiles, const Smem& sm, int nq, int k_row,
                             int mb0, int nmb, int first, int last, int step,
                             int hd, float scale) {
  constexpr int kQW = (kQ + kWarps - 1) / kWarps;  // queries per warp
  constexpr int kVec = Vec16<T>::n;
  using Raw = typename Vec16<T>::Raw;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float m_w[kQW], l_w[kQW];
#pragma unroll
  for (int r = 0; r < kQW; ++r) {
    m_w[r] = kNegInf;
    l_w[r] = 0.f;
  }
  for (int e = tid; e < nmb * hd; e += kThreads) sm.acc[e] = 0.f;
  const int n_groups = hd / kVec;
  const int n_items = nmb * n_groups;
  const int chunk = kChunk / step * step;

  const int c_first = first <= last ? (first / step) * step : last + 1;
  for (int c0 = c_first; c0 <= last; c0 += chunk) {
    const int n = chunk_positions(c0, last, step);
    const int n_steps = n / step;
    tiles.locate(c0, sm.tab);
    if (c0 != c_first) tiles.fill(c0, n, sm.tab, tid, kThreads);
    __syncthreads();

    // 1. scores of the chunk, one position per thread
    for (int i = tid; i < n; i += kThreads) {
      const int idx = c0 + i;
      const bool valid = idx >= first && idx <= last;
      float dot[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) dot[j] = 0.f;
      if (valid) {
        const T* kr = tiles.k_pos(k_row, idx);
#pragma unroll kKUnroll
        for (int d = 0; d < hd; d += kVec) {
          float kv[kVec];
          Vec16<T>::unpack(Vec16<T>::load(kr + d), kv);
#pragma unroll
          for (int j = 0; j < kQ; ++j)
#pragma unroll
            for (int u = 0; u < kVec; ++u)
              dot[j] += sm.q[j * hd + d + u] * kv[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (j < nq) sm.sc[j * kChunk + i] = valid ? dot[j] * scale : kNegInf;
    }
    __syncthreads();

    // 2. the online-softmax recurrence, one warp per query, steps in order
#pragma unroll
    for (int r = 0; r < kQW; ++r) {
      const int j = warp + r * kWarps;
      if (j < nq) {
        float* sc = sm.sc + j * kChunk;
        float* fac = sm.fac + j * kChunk;
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
          if (lane == 0) fac[k] = alpha;
        }
        __syncwarp();
        // step alphas -> products of the later steps' alphas; A = all
        if (lane == 0) {
          float w = 1.f;
          for (int k = n_steps - 1; k >= 0; --k) {
            const float a = fac[k];
            fac[k] = w;
            w *= a;
          }
          sm.ca[j] = w;
        }
        __syncwarp();
        for (int i = lane; i < n; i += 32) sc[i] *= fac[i / step];
      }
    }
    __syncthreads();

    // 3. AV: items (member, 16 bytes of its row) x position slices
    if (n_items > 0) {
      const int nsl = max(1, min(kThreads / n_items, n));
      const int per = (n + nsl - 1) / nsl;
      for (int e = tid; e < n_items * nsl; e += kThreads) {
        const int it = e % n_items, sl = e / n_items;
        const int mi = it / n_groups, d = (it - mi * n_groups) * kVec;
        const int j = sm.mem_q[mb0 + mi], vr = sm.mem_v[mb0 + mi];
        const float* w = sm.sc + j * kChunk;
        float part[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) part[u] = 0.f;
        const int i1 = min(n, (sl + 1) * per);
        for (int i0 = sl * per; i0 < i1; i0 += kBatch) {
          Raw raw[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int idx = c0 + i0 + u;
            raw[u] = (i0 + u < i1 && idx >= first && idx <= last)
                         ? Vec16<T>::load(tiles.v_pos(vr, idx) + d)
                         : Vec16<T>::zero();
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (i0 + u < i1) {
              float vv[kVec];
              Vec16<T>::unpack(raw[u], vv);
              const float wi = w[i0 + u];
#pragma unroll
              for (int x = 0; x < kVec; ++x) part[x] += wi * vv[x];
            }
          }
        }
        if (nsl == 1) {
          float* acc = sm.acc + mi * hd + d;
          const float a = sm.ca[j];
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = acc[x] * a + part[x];
        } else {
#pragma unroll
          for (int x = 0; x < kVec; ++x) sm.red[e * kVec + x] = part[x];
        }
      }
      if (nsl > 1) {
        __syncthreads();
        for (int it = tid; it < n_items; it += kThreads) {
          const int mi = it / n_groups, d = (it - mi * n_groups) * kVec;
          float* acc = sm.acc + mi * hd + d;
          const float a = sm.ca[sm.mem_q[mb0 + mi]];
          float sum[kVec];
#pragma unroll
          for (int x = 0; x < kVec; ++x) sum[x] = sm.red[it * kVec + x];
          for (int sl = 1; sl < nsl; ++sl)
#pragma unroll
            for (int x = 0; x < kVec; ++x)
              sum[x] += sm.red[(sl * n_items + it) * kVec + x];
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = acc[x] * a + sum[x];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kQW; ++r) {
    const int j = warp + r * kWarps;
    if (j < nq && lane == 0) {
      sm.m[j] = m_w[r];
      sm.l[j] = l_w[r];
    }
  }
  __syncthreads();
}

// The last block of a unit: combine the n_split partials in split order
// and write the unit's result (see the header comment).
template <bool kEmit>
__device__ void merge_splits(const Smem& sm, int nq, int n_mem, int n_split,
                             int hd, const Partials& part,
                             const Outputs& o) {
  const int tid = threadIdx.x;
  for (int j = tid; j < nq; j += kThreads) {
    float m = -1e30f;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, __ldcg(part.m + s * part.ml_stride + j));
    sm.m[j] = m;
  }
  __syncthreads();
  for (int e = tid; e < nq * n_split; e += kThreads) {
    const int j = e / n_split, s = e - j * n_split;
    sm.cmb[j * kMaxSplit + s] =
        expf(__ldcg(part.m + s * part.ml_stride + j) - sm.m[j]);
  }
  __syncthreads();
  for (int j = tid; j < nq; j += kThreads) {
    float l = 0.f;
    for (int s = 0; s < n_split; ++s)
      l += __ldcg(part.l + s * part.ml_stride + j) *
           sm.cmb[j * kMaxSplit + s];
    sm.l[j] = l;
    if (kEmit) {
      o.m[j] = sm.m[j];
      o.l[j] = l;
    }
  }
  __syncthreads();
  const int g4 = hd / 4;
  for (int e = tid; e < n_mem * g4; e += kThreads) {
    const int mi = e / g4, d = (e - mi * g4) * 4;
    const int a = sm.mem_a[mi];
    const float* c = sm.cmb + sm.mem_q[mi] * kMaxSplit;
    const float* src = part.acc + static_cast<size_t>(a) * hd + d;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += 8) {
      float4 x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + u;
        // an empty split's acc is never written: its factor is 0
        x[u] = (s < n_split && c[s] != 0.f)
                   ? __ldcg(reinterpret_cast<const float4*>(
                         src + s * part.acc_stride))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (s0 + u < n_split) {
          const float cs = c[s0 + u];
          acc.x += x[u].x * cs;
          acc.y += x[u].y * cs;
          acc.z += x[u].z * cs;
          acc.w += x[u].w * cs;
        }
      }
    }
    if (!kEmit) {
      const float den = fmaxf(sm.l[sm.mem_q[mi]], 1e-37f);
      acc.x = acc.x / den;
      acc.y = acc.y / den;
      acc.z = acc.z / den;
      acc.w = acc.w / den;
    }
    *reinterpret_cast<float4*>(o.out + static_cast<size_t>(a) * hd + d) =
        acc;
  }
}

// One block of a unit: member slice ``slice`` of split ``s`` of K row
// ``k_row``, for the nq queries at ``q`` (nq rows of hd fp32) and the
// members ``mem`` names, positions 0..pos (pos - window + 1..pos with a
// window). A slice is n_cap members of the unit's list (slice 0 also owns
// the queries' m and l); a slice past the unit's members returns at once.
// ``smem`` is the dynamic shared memory (block_smem_bytes(kQ, hd, mem.n,
// n_cap) bytes).
template <typename T, int kQ, bool kEmit, typename Tiles>
__device__ void unit_block(Tiles& tiles, float* smem, const float* q, int nq,
                           int k_row, const Members& mem, const Plan& plan,
                           int s, int slice, int pos, int window, int hd,
                           int n_cap, float scale, const Outputs& o,
                           const Partials& part) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Smem sm = carve(smem, kQ, hd, mem.n, n_cap);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, plan.n_tiles * plan.ts - 1);
  const int p0 = s * plan.tps * plan.ts;
  const int p1 = min(plan.n_tiles, (s + 1) * plan.tps) * plan.ts;
  const int first = max(p0, lo), last = min(p1 - 1, hi);
  // Three jobs at once, one memory round trip: warp 0 builds the member
  // list, warp 1 stages the first chunk's block-table entries, warps 2-3
  // load the queries.
  if (warp == 0) {   // the member list, in map order
    int n = 0;
    for (int e0 = 0; e0 < mem.n; e0 += 32) {
      const int e = e0 + lane;
      int qi = -1;
      if (e < mem.n) {
        const int r = mem.map[e];
        if (r / mem.rpg == mem.unit) qi = r - mem.unit * mem.rpg;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, qi >= 0);
      if (qi >= 0) {
        const int at = n + __popc(hit & ((1u << lane) - 1u));
        sm.mem_a[at] = e;
        sm.mem_q[at] = qi;
        sm.mem_v[at] = mem.v_rows ? mem.v_rows[e] : e / mem.v_rep;
      }
      n += __popc(hit);
    }
    if (lane == 0) *sm.n_mem = n;
  } else if (warp == 1) {
    if (first <= last) {
      const int c0 = (first / plan.step) * plan.step;
      tiles.fill(c0, chunk_positions(c0, last, plan.step), sm.tab, lane,
                 32);
    }
  } else {
#pragma unroll 4
    for (int e = tid - 64; e < kQ * hd; e += kThreads - 64)
      sm.q[e] = e < nq * hd ? q[e] : 0.f;
  }
  __syncthreads();
  const int n_mem = *sm.n_mem;
  if (!kEmit && n_mem == 0) return;   // no member: nothing to compute
  const int n_slices = max(1, (n_mem + n_cap - 1) / n_cap);
  if (slice >= n_slices) return;

  const int mb0 = slice * n_cap, nmb = min(n_cap, n_mem - mb0);
  decode_range<T, kQ>(tiles, sm, nq, k_row, mb0, nmb, first, last,
                      plan.step, hd, scale);
  if (plan.n_split == 1) {
    if (kEmit && slice == 0) {
      for (int j = tid; j < nq; j += kThreads) {
        o.m[j] = fmaxf(sm.m[j], -1e30f);
        o.l[j] = sm.l[j];
      }
    }
    for (int e = tid; e < nmb * hd; e += kThreads) {
      const int mi = e / hd, d = e - mi * hd;
      const float x = sm.acc[e];
      o.out[static_cast<size_t>(sm.mem_a[mb0 + mi]) * hd + d] =
          kEmit ? x : x / fmaxf(sm.l[sm.mem_q[mb0 + mi]], 1e-37f);
    }
    return;
  }

  if (slice == 0) {
    for (int j = tid; j < nq; j += kThreads) {
      part.m[s * part.ml_stride + j] = sm.m[j];
      part.l[s * part.ml_stride + j] = sm.l[j];
    }
  }
  if (first <= last) {
    for (int e = tid; e < nmb * hd; e += kThreads) {
      const int mi = e / hd, d = e - mi * hd;
      part.acc[s * part.acc_stride +
               static_cast<size_t>(sm.mem_a[mb0 + mi]) * hd + d] = sm.acc[e];
    }
  }
  // the ticket: every thread's partial writes are fenced before thread 0
  // takes it; the unit's last block (of n_split x n_slices) merges
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(part.counter, 1);
    const int last_block = ticket == plan.n_split * n_slices - 1;
    if (last_block) {
      *part.counter = 0;
      __threadfence();
    }
    *sm.flag = last_block;
  }
  __syncthreads();
  if (!*sm.flag) return;
  merge_splits<kEmit>(sm, nq, n_mem, plan.n_split, hd, part, o);
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

// Launch ``Launch::run<kQ>()`` for the smallest kQ in {1, 2, 4, 8} that
// holds nq queries. Returns the launch's cudaError_t.
template <typename Launch>
int with_queries(int nq, const Launch& launch) {
  if (nq <= 1) return launch.template run<1>();
  if (nq <= 2) return launch.template run<2>();
  if (nq <= 4) return launch.template run<4>();
  return launch.template run<8>();
}

inline int query_bucket(int nq) {
  return nq <= 1 ? 1 : nq <= 2 ? 2 : nq <= 4 ? 4 : 8;
}

}  // namespace chai
