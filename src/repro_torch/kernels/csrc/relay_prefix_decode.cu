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
// acc (G, A, hd), fp32, m clamped at >= -1e30, which the caller merges
// with each slot's suffix pass (the fused decode's state mode) before
// normalizing.
//
// What bounds it: device memory. Per group it must read the K rows the
// query rows name and the V rows the acc rows name, positions < plen,
// once; the multiply-adds are a few per byte.
//
// Design. The TPU kernel routes each (group, S-tile) step through one-hot
// matmuls over every row; here every one-hot row has one nonzero, so the
// routing is index reads. A K row is named by several query rows (a few
// reps of different slots on MHA, 20 on nemotron's KV group) and a V row
// by several acc rows (one head per slot on MHA; a KV group's heads of
// every slot on GQA), and on MHA the two sharings cross: the acc rows of
// one V row read queries on different K rows. So a launch runs two kinds
// of block, and each streams its row once:
//   score units (group g, K row kv): the query rows on kv, cut into
//     slices of at most kMaxQ = 8. A block streams its split's positions
//     of K row kv once for all its queries, writes the scaled scores to
//     fp32 scratch (G, NR, Sp) and keeps each query's online max m_s and
//     sum l_s over the split;
//   sum units (group g, V row vr): the acc rows on vr, cut into slices of
//     at most kSlice = 8. Once every score block of its (group, split)
//     has finished, a block streams its split's positions of V row vr
//     once, weighting position p for acc row a by exp(score - m_s) of its
//     query: the split's max is known, so nothing is rescaled on the way
//     and each thread keeps its sums in registers over the whole range.
// A slice of a row is found inside the kernel from the map alone: a count
// per row (at most kMaxRows rows) and a block scan enumerate the slices
// row by row, and a stable block-wide selection in map order gathers the
// slice's entries. The grid holds q_slots score and v_slots sum blocks per
// (group, split), upper bounds on the slices; a block past them only
// signals. The scores cost 4 bytes a position for each query row, written
// once and read once for each of its acc rows, against 2 * hd bytes of a
// bf16 K or V row.
//
// Each row's positions are cut into the splits of split_plan(G, KV,
// n_tiles) (kernels/chai_attention.py), the fused decode pair's plan, and
// streamed in chunks of kChunk with fixed shared memory: nothing grows
// with Sp, NR or A. The splits merge in split order inside the launch: the
// last score block of a unit (a ticket counter per unit) writes each
// query's m = max(-1e30, max_s m_s) and l = sum_s l_s exp(m_s - m); the
// last sum block of a unit writes each acc row's sum_s acc_s exp(m_s - m)
// with the same m. The order is fixed and there are no floating-point
// atomics, so two launches give the same bits. A split wholly past plen
// reads no byte and is the merge identity (m_s = -2e38, l_s = 0, its acc
// never read).
//
// A sum block waits, spinning, for its (group, split)'s score blocks. Each
// block takes its place in the launch from a dispatch counter when it
// starts, the score places first, so a waiting block only waits for
// blocks that are already running and never wait themselves. Every
// counter is left at zero by its last user. Padded members carry index 0
// in every map: their rows read in-bounds rows and compute values the
// caller's scatter discards.
//
// K and V each on its own, as the Pallas kernel casts each and applies
// each scale only when passed: the score blocks read K and the sum blocks
// V, each of its own element type (fp32, bf16, int8) and with its scale
// plane (ks (G, KV, Sp), vs (G, VR, Sp)) or none. The pairings the
// serving paths run (one type; K scaled iff int8; V scaled, or not, under
// int8) keep the blocks whose scale steps the type fixes, as they were
// before K and V were split; every other pair of types takes the general
// blocks (kGeneral), where each scale is a run-time null test
// (the launcher's ``body``). With ks the score blocks multiply
// each position's dot by its K row's scale before 1/sqrt(hd); with vs the
// sum blocks dequantize each V row (the row times its scale) before
// weighting it, as the Pallas kernel does. A null scale reads the rows
// (int8 codes too) as values. The int8 mode is int8 K and V with both
// scales (a load carries 8 codes); the share_values relay's V is int8
// codes without scales.
//
// The softcap mode (gemma2's attention-logit cap, ``cap`` != 0): the score
// blocks cap each scaled score (int8: after the K scale, then
// 1/sqrt(hd)), cap * tanhf(score / cap) (the exact forms), before it is
// written to the scores scratch, as the Pallas kernel caps before its
// plen mask; positions >= plen are never scored. The split maxima, the
// sums and the ordered merge only ever see capped scores. cap == 0 leaves
// the score as it is: one uniform branch.
//
// The head dim is the call's, up to 256 or gemma3-4b's 320: nothing in the
// blocks is sized by it. A score block stages kMaxQ x hd query floats in
// ``big`` (2,560 at 320, of kRed = 8,192); a sum block lays its threads
// out as hd / kVec load groups of nsl = kThreads / (hd / kVec) position
// slices, whose partial sums ``big`` holds: nsl * kSlice * hd <= kThreads
// * kVec * kSlice = kRed floats whatever hd (kVec <= 8). At 320 that is
// 40 groups of 3 slices (bf16, int8: 8 threads idle) or 80 groups of 1
// (fp32: 48 idle); a thread past the slices (sl >= nsl) reads and writes
// nothing. Each thread's sums are acc[kSlice][kVec] in registers at every
// hd, so the instances and kSmemBytes are those of every head dim.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

constexpr int kMaxRows = 2 * kThreads;        // K or V rows of a group
constexpr int kRed = kThreads * 8 * kSlice;   // floats of the sums' reduce
constexpr int kChunkRows = kMaxQ > kSlice ? kMaxQ : kSlice;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* ks;  // (G, KV, Sp) K row scales, or null
  const float* vs;  // (G, VR, Sp) V row scales, or null
  const int* k_row;
  const int* a_row;
  const int* v_row;
  const int* plen;
  float* m;
  float* l;
  float* acc;
  float* mp;        // (G, n_split, NR) partial m of each query row
  float* lp;        // (G, n_split, NR) partial l
  float* accp;      // (G, n_split, A, hd) partial acc
  float* sc;        // (G, NR, Sp) scaled scores
  int* counter;     // dispatch, done (G, ns) x 2, tickets (G, slots) x 2
  int G, NR, A, KV, VR, Sp, hd, ts, tps, n_split, q_slots, v_slots;
  float scale;
  float cap;        // the softcap mode: cap * tanh(score / cap); 0 = off
};

// Shared memory: floats (the score block's queries, or the sum block's
// reduce; a chunk of scores or weights per row; per-row m and the split
// factors), then ints (a count per row, the scan's warp totals, the
// slice, its entries, the entries' query rows, a flag). About 39 KB,
// whatever the shapes.
struct Smem {
  float *big, *chunk, *ms, *cmb;
  int *cnt, *scan, *slice, *rows, *rq, *flag;
};

constexpr size_t kSmemBytes =
    (static_cast<size_t>(kRed) + kChunkRows * kChunk + kChunkRows +
     kChunkRows * kMaxSplit) * 4 +
    (static_cast<size_t>(kMaxRows) + kWarps + 4 + 2 * kChunkRows + 1) * 4;

__device__ inline Smem carve(float* base) {
  Smem s;
  s.big = base;
  s.chunk = s.big + kRed;
  s.ms = s.chunk + kChunkRows * kChunk;
  s.cmb = s.ms + kChunkRows;
  s.cnt = reinterpret_cast<int*>(s.cmb + kChunkRows * kMaxSplit);
  s.scan = s.cnt + kMaxRows;
  s.slice = s.scan + kWarps;
  s.rows = s.slice + 4;
  s.rq = s.rows + kChunkRows;
  s.flag = s.rq + kChunkRows;
  return s;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Ask L2 for positions [first, min(last, first + kChunk - 1)] of a row
// (hd elements of ``bytes`` each a position), 128 bytes a thread.
__device__ void prefetch_chunk(const void* row, int first, int last, int hd,
                               int bytes) {
  const size_t b0 = static_cast<size_t>(first) * hd * bytes;
  const int nb = (min(last, first + kChunk - 1) - first + 1) * hd * bytes;
  for (int b = threadIdx.x * 128; b < nb; b += kThreads * 128)
    prefetch_l2(static_cast<const char*>(row) + b0 + b);
}

// Exclusive prefix of x over the block's threads in thread order (all
// threads call it; writes the sum of all to *total). Ends with a barrier.
__device__ int block_exclusive_scan(int x, int* scan, int* total) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? scan[w] : 0;
    all += scan[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - x;
}

// Slot t's slice of one group's map (n entries with values in [0,
// n_rows)): the slices enumerated row by row, each row's c entries cut
// into ns = ceil(c / cap) slices, slice z holding ranks [z * c / ns,
// (z + 1) * c / ns) of the row's entries in map order. Fills sm.slice[0..2]
// (row, first rank, count); false when t is past the group's slices.
__device__ bool find_slice(const int* map, int n, int n_rows, int cap,
                           int t, const Smem& sm) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n_rows; i += kThreads) sm.cnt[i] = 0;
  if (tid == 0) sm.slice[0] = -1;
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) atomicAdd(&sm.cnt[map[i]], 1);
  __syncthreads();
  const int r0 = 2 * tid;
  const int c0 = r0 < n_rows ? sm.cnt[r0] : 0;
  const int c1 = r0 + 1 < n_rows ? sm.cnt[r0 + 1] : 0;
  const int n0 = (c0 + cap - 1) / cap, n1 = (c1 + cap - 1) / cap;
  int total;
  const int before = block_exclusive_scan(n0 + n1, sm.scan, &total);
  int row = -1, z = 0, ns = 1, c = 0;
  if (t >= before && t < before + n0) {
    row = r0, z = t - before, ns = n0, c = c0;
  } else if (t >= before + n0 && t < before + n0 + n1) {
    row = r0 + 1, z = t - before - n0, ns = n1, c = c1;
  }
  if (row >= 0) {
    sm.slice[0] = row;
    sm.slice[1] = z * c / ns;
    sm.slice[2] = (z + 1) * c / ns - z * c / ns;
  }
  __syncthreads();
  return sm.slice[0] >= 0;
}

// The entries e in [0, n) with map[e] == row, ranked in map order: rows[r
// - lo] = e, and rq[r - lo] = of[e] when ``of`` is set, for the ranks r in
// [lo, hi). Each thread tests a run of at most 32 consecutive entries and
// a block scan gives the runs' first ranks. Ends with a barrier.
__device__ void select_slice(const int* map, int n, int row, int lo, int hi,
                             const int* of, const Smem& sm) {
  const int tid = threadIdx.x;
  int base = 0;
  for (int r0 = 0; r0 < n; r0 += kThreads * 32) {
    const int per = (min(n - r0, kThreads * 32) + kThreads - 1) / kThreads;
    const int e0 = r0 + tid * per;
    unsigned bits = 0u;
    for (int u = 0; u < per; ++u)
      if (e0 + u < n && map[e0 + u] == row) bits |= 1u << u;
    int total;
    int r = base + block_exclusive_scan(__popc(bits), sm.scan, &total);
    for (int u = 0; u < per; ++u) {
      if ((bits >> u) & 1u) {
        if (r >= lo && r < hi) {
          sm.rows[r - lo] = e0 + u;
          if (of) sm.rq[r - lo] = of[e0 + u];
        }
        ++r;
      }
    }
    base += total;
  }
  __syncthreads();
}

// Positions [first, last] of split s of group g (none when last < first).
struct Range {
  int first, last;
};

__device__ inline Range split_range(const Args& a, int g, int s) {
  const int n_tiles = a.Sp / a.ts;
  const int p0 = s * a.tps * a.ts;
  const int p1 = min(n_tiles, (s + 1) * a.tps) * a.ts;
  return Range{p0, min(p1 - 1, min(a.plen[g], a.Sp) - 1)};
}

// One chunk's scores of a K row for the block's nq queries (sm.big, kQ
// rows of hd, zero past nq): thread i takes position c0 + i, row loads of
// the K row dotted with every query, scaled (by the row's scale
// ``kscale[c0 + i]`` first when kscale is set), capped when cap != 0;
// into sm.chunk (query j
// at j * kChunk) and into the scores scratch ``out`` (query j's row at
// sm.rows[j] * Sp).
template <typename T, int kQ, bool kGeneral>
__device__ void score_chunk(const T* krow, const float* kscale,
                            const Smem& sm, int nq, int c0, int n, int hd,
                            int sp, float scale, float cap, float* out) {
  constexpr int kVec = Vec16<T>::n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float dot[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) dot[j] = 0.f;
    const T* kp = krow + static_cast<size_t>(c0 + i) * hd;
#pragma unroll kKUnroll
    for (int d = 0; d < hd; d += kVec) {
      float kv[kVec];
      Vec16<T>::unpack(Vec16<T>::load(kp + d), kv);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
#pragma unroll
        for (int u = 0; u < kVec; ++u) dot[j] += sm.big[j * hd + d + u] * kv[u];
    }
    // a K scale: a run-time test in the general blocks, else int8's
    const bool k_scaled = kGeneral ? kscale != nullptr : kIsInt8<T>;
    float ks = 1.f;
    if (k_scaled) ks = kscale[c0 + i];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (j < nq) {
        float x = k_scaled ? dot[j] * ks * scale : dot[j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);   // the softcap mode
        sm.chunk[j * kChunk + i] = x;
        out[static_cast<size_t>(sm.rows[j]) * sp + c0 + i] = x;
      }
    }
  }
}

// A score block: slice t of group g's K rows over split s.
template <typename T, bool kGeneral>
__device__ void score_block(const Args& a, const Smem& sm, int g, int s,
                            int t) {
  constexpr int kQW = kMaxQ / kWarps;   // queries per warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* k_row = a.k_row + static_cast<size_t>(g) * a.NR;
  const int ns = a.n_split;
  int* done = a.counter + 1 + g * ns + s;
  if (!find_slice(k_row, a.NR, a.KV, kMaxQ, t, sm)) {
    if (tid == 0) atomicAdd(done, 1);
    return;
  }
  const int kv = sm.slice[0], nq = sm.slice[2];
  const Range r = split_range(a, g, s);
  const size_t k0 = static_cast<size_t>(g * a.KV + kv) * a.Sp;
  const T* krow = static_cast<const T*>(a.k) + k0 * a.hd;
  const float* kscale = a.ks ? a.ks + k0 : nullptr;
  if (r.first <= r.last)
    prefetch_chunk(krow, r.first, r.last, a.hd, sizeof(T));
  select_slice(k_row, a.NR, kv, sm.slice[1], sm.slice[1] + nq, nullptr, sm);
  const float* q = a.q + static_cast<size_t>(g) * a.NR * a.hd;
  for (int e = tid; e < kMaxQ * a.hd; e += kThreads) {
    const int j = e / a.hd;
    sm.big[e] = j < nq ? q[static_cast<size_t>(sm.rows[j]) * a.hd + e -
                           j * a.hd]
                       : 0.f;
  }
  float* out = a.sc + static_cast<size_t>(g) * a.NR * a.Sp;
  // each query's online max and sum over the split, one warp a query
  float m_w[kQW], l_w[kQW];
#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    m_w[u] = kNegInf;
    l_w[u] = 0.f;
  }
  for (int c0 = r.first; c0 <= r.last; c0 += kChunk) {
    const int n = min(kChunk, r.last - c0 + 1);
    __syncthreads();
    if (nq <= 1)
      score_chunk<T, 1, kGeneral>(krow, kscale, sm, nq, c0, n, a.hd, a.Sp,
                                  a.scale, a.cap, out);
    else if (nq <= 2)
      score_chunk<T, 2, kGeneral>(krow, kscale, sm, nq, c0, n, a.hd, a.Sp,
                                  a.scale, a.cap, out);
    else if (nq <= 4)
      score_chunk<T, 4, kGeneral>(krow, kscale, sm, nq, c0, n, a.hd, a.Sp,
                                  a.scale, a.cap, out);
    else
      score_chunk<T, kMaxQ, kGeneral>(krow, kscale, sm, nq, c0, n, a.hd,
                                      a.Sp, a.scale, a.cap, out);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kQW; ++u) {
      const int j = warp + u * kWarps;
      if (j < nq) {
        const float* x = sm.chunk + j * kChunk;
        float mx = kNegInf;
        for (int i = lane; i < n; i += 32) mx = fmaxf(mx, x[i]);
        const float m_new = fmaxf(fmaxf(m_w[u], warp_max(mx)), -1e30f);
        float sum = 0.f;
        for (int i = lane; i < n; i += 32) sum += expf(x[i] - m_new);
        l_w[u] = l_w[u] * expf(m_w[u] - m_new) + warp_sum(sum);
        m_w[u] = m_new;
      }
    }
  }
  const size_t part = (static_cast<size_t>(g) * ns + s) * a.NR;
#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    const int j = warp + u * kWarps;
    if (j < nq && lane == 0) {
      a.mp[part + sm.rows[j]] = m_w[u];
      a.lp[part + sm.rows[j]] = l_w[u];
    }
  }
  // scores, m and l fenced before the block signals and takes its ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    atomicAdd(done, 1);
    int* ticket = a.counter + 1 + 2 * a.G * ns + g * a.q_slots + t;
    const int last = atomicAdd(ticket, 1) == ns - 1;
    if (last) {
      *ticket = 0;
      __threadfence();
    }
    *sm.flag = last;
  }
  __syncthreads();
  if (!*sm.flag) return;
  // the unit's last block: m and l of its queries, splits in order
  for (int j = tid; j < nq; j += kThreads) {
    const int i = sm.rows[j];
    const float* mp = a.mp + static_cast<size_t>(g) * ns * a.NR + i;
    const float* lp = a.lp + static_cast<size_t>(g) * ns * a.NR + i;
    float m = -1e30f;
    for (int x = 0; x < ns; ++x) m = fmaxf(m, __ldcg(mp + x * a.NR));
    float l = 0.f;
    for (int x = 0; x < ns; ++x)
      l += __ldcg(lp + x * a.NR) * expf(__ldcg(mp + x * a.NR) - m);
    a.m[static_cast<size_t>(g) * a.NR + i] = m;
    a.l[static_cast<size_t>(g) * a.NR + i] = l;
  }
}

// A sum block: slice u of group g's V rows over split s.
template <typename T, bool kGeneral>
__device__ void sum_block(const Args& a, const Smem& sm, int g, int s,
                          int u) {
  constexpr int kVec = Vec16<T>::n;
  using Raw = typename Vec16<T>::Raw;
  const int tid = threadIdx.x;
  const int ns = a.n_split;
  const int* v_row = a.v_row + static_cast<size_t>(g) * a.A;
  const int* a_row = a.a_row + static_cast<size_t>(g) * a.A;
  const bool found = find_slice(v_row, a.A, a.VR, kSlice, u, sm);
  const int vr = max(sm.slice[0], 0), nm = found ? sm.slice[2] : 0;
  const Range r = split_range(a, g, s);
  const size_t v0 = static_cast<size_t>(g * a.VR + vr) * a.Sp;
  const T* vrow = static_cast<const T*>(a.v) + v0 * a.hd;
  const float* vscale = a.vs ? a.vs + v0 : nullptr;
  if (found && r.first <= r.last)
    prefetch_chunk(vrow, r.first, r.last, a.hd, sizeof(T));
  if (found)
    select_slice(v_row, a.A, vr, sm.slice[1], sm.slice[1] + nm, a_row, sm);
  // wait for every score block of (g, s)
  int* done = a.counter + 1 + g * ns + s;
  if (tid == 0) {
    while (load_acquire(done) < a.q_slots) __nanosleep(100);
  }
  __syncthreads();
  const float* mp = a.mp + static_cast<size_t>(g) * ns * a.NR;
  for (int mi = tid; mi < nm; mi += kThreads)
    sm.ms[mi] = __ldcg(mp + static_cast<size_t>(s) * a.NR + sm.rq[mi]);
  // thread (d, sl): 16 bytes d of the row at positions sl, sl + nsl, ...
  const int groups = a.hd / kVec, nsl = kThreads / groups;
  const int d = (tid % groups) * kVec, sl = tid / groups;
  float acc[kSlice][kVec];
#pragma unroll
  for (int mi = 0; mi < kSlice; ++mi)
#pragma unroll
    for (int x = 0; x < kVec; ++x) acc[mi][x] = 0.f;
  const bool live = found && r.first <= r.last;
  for (int c0 = r.first; live && c0 <= r.last; c0 += kChunk) {
    const int n = min(kChunk, r.last - c0 + 1);
    __syncthreads();
    for (int e = tid; e < nm * n; e += kThreads) {
      const int mi = e / n, p = e - mi * n;
      const float* row =
          a.sc + (static_cast<size_t>(g) * a.NR + sm.rq[mi]) * a.Sp;
      sm.chunk[mi * kChunk + p] = expf(__ldcg(row + c0 + p) - sm.ms[mi]);
    }
    __syncthreads();
    if (sl < nsl) {
      for (int p0 = sl; p0 < n; p0 += kBatch * nsl) {
        Raw raw[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int p = p0 + b * nsl;
          raw[b] = p < n ? Vec16<T>::load(
                               vrow + static_cast<size_t>(c0 + p) * a.hd + d)
                         : Vec16<T>::zero();
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int p = p0 + b * nsl;
          if (p < n) {
            float vv[kVec];
            Vec16<T>::unpack(raw[b], vv);
            // dequantize before the sum: V scales are read by the int8
            // type's blocks and the general ones, where vs is set
            if constexpr (kGeneral || kIsInt8<T>) {
              if (vscale) {
                const float vsc = vscale[c0 + p];
#pragma unroll
                for (int x = 0; x < kVec; ++x) vv[x] *= vsc;
              }
            }
#pragma unroll
            for (int mi = 0; mi < kSlice; ++mi) {
              if (mi < nm) {
                const float w = sm.chunk[mi * kChunk + p];
#pragma unroll
                for (int x = 0; x < kVec; ++x) acc[mi][x] += w * vv[x];
              }
            }
          }
        }
      }
    }
  }
  // the position slices' sums in slice order: the split's partial acc
  if (live) {
    __syncthreads();
    if (sl < nsl) {
#pragma unroll
      for (int mi = 0; mi < kSlice; ++mi)
        if (mi < nm)
#pragma unroll
          for (int x = 0; x < kVec; ++x)
            sm.big[(sl * kSlice + mi) * a.hd + d + x] = acc[mi][x];
    }
    __syncthreads();
    for (int e = tid; e < nm * a.hd; e += kThreads) {
      const int mi = e / a.hd, x = e - mi * a.hd;
      float sum = 0.f;
      for (int z = 0; z < nsl; ++z)
        sum += sm.big[(z * kSlice + mi) * a.hd + x];
      a.accp[((static_cast<size_t>(g) * ns + s) * a.A + sm.rows[mi]) * a.hd +
             x] = sum;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    // (g, s)'s two counters are done with once every sum block has waited
    int* sums = a.counter + 1 + a.G * ns + g * ns + s;
    if (atomicAdd(sums, 1) == a.v_slots - 1) {
      *sums = 0;
      *done = 0;
    }
    int last = 0;
    if (found) {
      int* ticket =
          a.counter + 1 + 2 * a.G * ns + a.G * a.q_slots + g * a.v_slots + u;
      last = atomicAdd(ticket, 1) == ns - 1;
      if (last) {
        *ticket = 0;
        __threadfence();
      }
    }
    *sm.flag = last;
  }
  __syncthreads();
  if (!*sm.flag) return;
  // the unit's last block: each acc row's splits in order, at its query's
  // merged m
  for (int mi = tid; mi < nm; mi += kThreads) {
    float m = -1e30f;
    for (int x = 0; x < ns; ++x)
      m = fmaxf(m, __ldcg(mp + static_cast<size_t>(x) * a.NR + sm.rq[mi]));
    sm.ms[mi] = m;
  }
  __syncthreads();
  for (int e = tid; e < nm * ns; e += kThreads) {
    const int mi = e / ns, x = e - mi * ns;
    sm.cmb[mi * kMaxSplit + x] = expf(
        __ldcg(mp + static_cast<size_t>(x) * a.NR + sm.rq[mi]) - sm.ms[mi]);
  }
  __syncthreads();
  const int g4 = a.hd / 4;
  const size_t acc_split = static_cast<size_t>(a.A) * a.hd;
  for (int e = tid; e < nm * g4; e += kThreads) {
    const int mi = e / g4, d4 = (e - mi * g4) * 4;
    const float* c = sm.cmb + mi * kMaxSplit;
    const float* src = a.accp + static_cast<size_t>(g) * ns * acc_split +
                       static_cast<size_t>(sm.rows[mi]) * a.hd + d4;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x0 = 0; x0 < ns; x0 += 8) {
      float4 p[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int x = x0 + b;
        // an empty split's acc is never written: its factor is 0
        p[b] = (x < ns && c[x] != 0.f)
                   ? __ldcg(reinterpret_cast<const float4*>(
                         src + x * acc_split))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (x0 + b < ns) {
          const float cs = c[x0 + b];
          out.x += p[b].x * cs;
          out.y += p[b].y * cs;
          out.z += p[b].z * cs;
          out.w += p[b].w * cs;
        }
      }
    }
    *reinterpret_cast<float4*>(a.acc + static_cast<size_t>(g) * acc_split +
                               static_cast<size_t>(sm.rows[mi]) * a.hd +
                               d4) = out;
  }
}

template <typename TK, typename TV, bool kGeneral>
__global__ void __launch_bounds__(kThreads)
relay_prefix_decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve(reinterpret_cast<float*>(smem_raw));
  // the block's place in the launch: score places (g, s, t) first
  if (threadIdx.x == 0) {
    const int id = atomicAdd(a.counter, 1);
    if (id == static_cast<int>(gridDim.x) - 1) *a.counter = 0;
    *sm.flag = id;
  }
  __syncthreads();
  const int id = *sm.flag;
  __syncthreads();
  const int per_q = a.n_split * a.q_slots;
  if (id < a.G * per_q) {
    const int g = id / per_q, rest = id - g * per_q;
    score_block<TK, kGeneral>(a, sm, g, rest / a.q_slots, rest % a.q_slots);
  } else {
    const int per_v = a.n_split * a.v_slots, j = id - a.G * per_q;
    const int g = j / per_v, rest = j - g * per_v;
    sum_block<TV, kGeneral>(a, sm, g, rest / a.v_slots, rest % a.v_slots);
  }
}

}  // namespace

// q: (G, NR, hd) fp32; k: (G, KV, Sp, hd) and v: (G, VR, Sp, hd), each
// fp32 (type 0), bf16 (1) or int8 codes (2) by k_type / v_type; ks:
// (G, KV, Sp) and vs: (G, VR, Sp) fp32 row scales, each null or not
// whatever the types (null: the rows read as values); ``body`` as in
// chai_fused_decode_launch;
// k_row: (G, NR) int32 in [0, KV);
// a_row: (G, A) int32 in [0, NR); v_row: (G, A) int32 in [0, VR); plen:
// (G,) int32 in [0, Sp]; m, l: (G, NR) fp32; acc: (G, A, hd) fp32. All
// contiguous and 16-byte aligned; hd % 8 == 0, hd <= 256 or hd == 320
// (gemma3-4b's; nothing in the blocks is sized by hd); KV, VR <= 256;
// Sp % ts == 0. The split plan: n_split (<= 64) ranges of ``tps`` tiles;
// q_slots score and v_slots (>= 1) sum blocks per (group, split), at
// least the group's query slices of 8 per K row and acc slices of 8 per V
// row. The scratch: mp, lp (G, n_split, NR), accp (G, n_split, A, hd) and
// sc (G, NR, Sp) fp32, and counter (1 + 2 G n_split + G (q_slots +
// v_slots)) int32, all zero (the launch leaves them at zero again). cap
// != 0: the softcap mode. Returns the launch's cudaError_t (0 on success);
// does not synchronise.
extern "C" int relay_prefix_decode_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* k_row, const void* a_row, const void* v_row,
    const void* plen, void* m, void* l, void* acc, void* mp, void* lp,
    void* accp, void* sc, void* counter, int G, int NR, int A, int KV,
    int VR, int Sp, int hd, int ts, int n_split, int tps, int q_slots,
    int v_slots, int k_type, int v_type, int body, float cap,
    void* stream) {
  const Args a{static_cast<const float*>(q), k, v,
               static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const int*>(k_row), static_cast<const int*>(a_row),
               static_cast<const int*>(v_row), static_cast<const int*>(plen),
               static_cast<float*>(m), static_cast<float*>(l),
               static_cast<float*>(acc), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<float*>(sc), static_cast<int*>(counter), G, NR, A,
               KV, VR, Sp, hd, ts, tps, n_split, q_slots, v_slots,
               inv_sqrt_hd(hd), cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(G * n_split * (q_slots + v_slots));
  auto run = [&](auto kern) {
    const cudaError_t err = allow_smem(kern, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, kSmemBytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  };
  if (body != kBodyGeneral)   // one type for K and V
    return with_elem(k_type, [&](auto t) {
      using T = decltype(t);
      return run(relay_prefix_decode_kernel<T, T, false>);
    });
  return with_kv_types(k_type, v_type, [&](auto tk, auto tv) {
    return run(relay_prefix_decode_kernel<decltype(tk), decltype(tv), true>);
  });
}

// The dynamic shared memory of one block in bytes, for a check that the
// host's mirror (kernels/chai_attention.py) agrees.
extern "C" int relay_smem_bytes(void) { return static_cast<int>(kSmemBytes); }
