// Broadcast-and-accumulate of the normalized clustered scores, the last
// stage of the three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_av and paged_chai_av (two
// Pallas TPU kernels with one body, _av_kernel: a (B, H, S/ts) grid whose
// last axis carries an fp32 accumulator in VMEM scratch; the A BlockSpec
// reads row h2c[b, h], the V BlockSpec the dense tile or the block table's
// page). Output: (B, H, hd) fp32, out[b, h] = sum over ALL s of
// A[b, h2c[b, h], s] * V[b, h, s]. Neither kernel takes pos: A is zero
// past pos only because the softmax made it so, and no position is
// skipped here (0 * inf or 0 * NaN in V past pos must stay what it is).
// V is fp32, bf16 or int8; int8 codes are read as their values with no
// scale, as the Pallas body casts whatever V it is given (the
// share_values pipeline's clustered V).
//
// What bounds it: device memory. Each head's V row over all S (B * H * S
// * hd elements) and its A row are read once and the (B, H, hd) output
// written: about one flop per byte of V, a 1 x S by S x hd product per
// head, so tensor cores have nothing to speed up. The time is the time
// to move V, and that needs bytes in flight: at 3.35 TB/s and ~0.7 us of
// latency, ~2.3 MB across the card, ~17 KB on each SM.
//
// Design. The work unit is (b, h); its S axis is cut into n_split ranges
// of whole tiles (``tps`` tiles each, the last one shorter) by the host's
// kernels/chai_attention.py: av_launch_config (split_plan over the B * H
// units, from the shapes alone). The dense tile is ts, the paged tile the
// page, so at ts == page the two calls cut S alike and run the same
// arithmetic in the same order: bitwise equal outputs. A block is (unit,
// split, column group) with 128 threads: thread t takes the 16 bytes (or
// the widest load that divides the row: ``kVec`` elements) at column t %
// cols of the row and every lanes-th position of the range from t / cols
// (lanes = 128 / cols), issuing kUnroll independent row loads before it
// adds them in position order: 8 x 16 B in flight a thread, 16 KB a
// block, several blocks an SM. Neighbouring threads read neighbouring
// addresses. A row wider than 128 loads (hd > 512 fp32) is cut into
// column groups, one block each. The block stages the range's A values in
// shared memory once per chunk of kChunk positions; the paged block also
// locates each position of the chunk once there (its row's element offset
// in the pool, from the block table), so the threads that read pieces of
// one row share one lookup (with a lookup per thread and row, sixteen for
// a bf16 row of 128, the paged kernel took 1.4x the dense one's time at
// 64-position splits). The lanes' partial sums meet in shared memory and
// are added in lane order.
//
// Splits are merged inside the launch, as the fused decode does
// (chai_decode_tiles.cuh): with n_split > 1 each block writes its fp32
// partial row to scratch, fences, and takes a ticket on its unit's
// counter; the unit's last block (of n_split x groups) resets the
// counter, reads the partials in split order past L1 (__ldcg) and writes
// their sum. No floating-point atomics: two launches give the same bits.
// With n_split == 1 each block writes its columns itself.

#include <stddef.h>

#include "row_loads.cuh"

namespace {

using chai::Raw;
using chai::elem;

constexpr int kThreads = 128;
constexpr int kUnroll = 8;      // row loads a thread issues before it adds
constexpr int kChunk = 1024;    // positions of A (and pages) staged at once

// Dense V cache (B, H, S, hd): the rows of one (b, h).
template <typename T>
struct DenseV {
  using Entry = int;                     // stages nothing
  static constexpr int kStaged = 1;
  const T* v;
  int h, s, hd;
  struct Unit {
    const T* base;
    int hd;
    __device__ void stage(int, int, Entry*, int) const {}
    __device__ const T* row(int i, int, const Entry*) const {
      return base + static_cast<size_t>(i) * hd;
    }
  };
  __device__ Unit unit(int b, int hh) const {
    return Unit{v + (static_cast<size_t>(b) * h + hh) * s * hd, hd};
  }
};

// V page pool (nP, H, page, hd) through the block table bt (B, P): the
// block locates each position of the chunk once, as the element offset
// of its row in the pool, in shared memory (not once per thread that
// reads a piece of the row).
template <typename T>
struct PagedV {
  using Entry = long long;               // a row's element offset
  static constexpr int kStaged = kChunk;
  const T* v;
  const int* bt;
  int h, page, hd, n_pages;
  struct Unit {
    const T* pool;
    const int* bt_row;
    int h, hh, page, hd;
    __device__ void stage(int c0, int n, Entry* rows, int tid) const {
      for (int i = tid; i < n; i += kThreads) {
        const int p = c0 + i;
        rows[i] = ((static_cast<Entry>(bt_row[p / page]) * h + hh) * page
                   + p % page) * hd;
      }
    }
    __device__ const T* row(int i, int c0, const Entry* rows) const {
      return pool + rows[i - c0];
    }
  };
  __device__ Unit unit(int b, int hh) const {
    return Unit{v, bt + static_cast<size_t>(b) * n_pages, h, hh, page, hd};
  }
};

template <typename T, int kVec, typename Rows>
__global__ void __launch_bounds__(kThreads)
av_kernel(const float* __restrict__ a, const Rows rows,
          const int* __restrict__ h2c, float* __restrict__ out,
          float* __restrict__ scratch, int* __restrict__ counter, int R,
          int H, int S, int hd, int ts, int n_split, int tps, int groups) {
  using Load = Raw<kVec * static_cast<int>(sizeof(T))>;
  constexpr int kWords = Load::kWords;
  __shared__ float sa[kChunk];
  __shared__ typename Rows::Entry tab[Rows::kStaged];
  __shared__ float part[kThreads * kVec];
  __shared__ int last_flag;
  const int tid = threadIdx.x;
  const int g = blockIdx.x % groups;
  const int s = blockIdx.x / groups % n_split;
  const int unit = blockIdx.x / groups / n_split;        // b * H + hh
  const int b = unit / H, hh = unit - b * H;
  const int cols = hd / kVec;
  const int lanes = cols >= kThreads ? 1 : kThreads / cols;
  const int gc0 = g * kThreads;                          // first column
  const int gcols = min(cols - gc0, kThreads / lanes);   // group's columns
  const int lane = tid / gcols, col = gc0 + tid % gcols;
  const bool active = tid < lanes * gcols;
  const int first = s * tps * ts;
  const int end = min(S, (s + 1) * tps * ts);
  const float* ar = a + (static_cast<size_t>(b) * R + h2c[unit]) * S;
  const auto rv = rows.unit(b, hh);

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  for (int c0 = first; c0 < end; c0 += kChunk) {
    const int n = min(kChunk, end - c0);
    __syncthreads();                       // the last chunk's reads are done
    for (int i = tid; i < n; i += kThreads) sa[i] = __ldg(ar + c0 + i);
    rv.stage(c0, n, tab, tid);
    __syncthreads();
    if (!active) continue;
    for (int r0 = lane; r0 < n; r0 += kUnroll * lanes) {
      unsigned w[kUnroll][kWords];
      float p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * lanes;
        p[u] = 0.f;
#pragma unroll
        for (int k = 0; k < kWords; ++k) w[u][k] = 0u;
        if (r < n) {
          Load::load(rv.row(c0 + r, c0, tab) + col * kVec, w[u]);
          p[u] = sa[r];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * lanes < n) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[e] = fmaf(p[u], elem<T>(w[u], e), acc[e]);
        }
      }
    }
  }

  // the lanes' partial sums, added in lane order
  const int width = gcols * kVec;          // the group's elements
  if (active) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      part[lane * width + (col - gc0) * kVec + e] = acc[e];
  }
  __syncthreads();
  float* dst = n_split == 1
                   ? out + static_cast<size_t>(unit) * hd
                   : scratch + (static_cast<size_t>(unit) * n_split + s) * hd;
  for (int i = tid; i < width; i += kThreads) {
    float x = part[i];
    for (int l = 1; l < lanes; ++l) x += part[l * width + i];
    dst[gc0 * kVec + i] = x;
  }
  if (n_split == 1) return;

  // the ticket: every thread's partial writes are fenced before thread 0
  // takes it; the unit's last block merges the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(counter + unit, 1);
    const int is_last = ticket == n_split * groups - 1;
    if (is_last) {
      counter[unit] = 0;
      __threadfence();
    }
    last_flag = is_last;
  }
  __syncthreads();
  if (!last_flag) return;
  const float* su = scratch + static_cast<size_t>(unit) * n_split * hd;
  for (int d = tid; d < hd; d += kThreads) {
    float x = __ldcg(su + d);
#pragma unroll 8
    for (int t = 1; t < n_split; ++t)
      x += __ldcg(su + static_cast<size_t>(t) * hd + d);
    out[static_cast<size_t>(unit) * hd + d] = x;
  }
}

// The launch's shape, as kernels/chai_attention.py: av_launch_config
// gives it.
struct Plan {
  int B, R, H, S, hd, ts, n_split, tps, vec;
};

template <typename T, int kVec, typename Rows>
int launch(const void* a, const Rows& rows, const void* h2c, void* out,
           void* scratch, void* counter, const Plan& p,
           cudaStream_t stream) {
  const int cols = p.hd / kVec;
  const int groups = (cols + kThreads - 1) / kThreads;
  const long long blocks =
      static_cast<long long>(p.B) * p.H * p.n_split * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  av_kernel<T, kVec, Rows><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(
      static_cast<const float*>(a), rows, static_cast<const int*>(h2c),
      static_cast<float*>(out), static_cast<float*>(scratch),
      static_cast<int*>(counter), p.R, p.H, p.S, p.hd, p.ts, p.n_split,
      p.tps, groups);
  return static_cast<int>(cudaGetLastError());
}

// The instance for p.vec elements a load: 16 bytes, or 8, 4, 2 when the
// row is not a multiple of the wider load (at least two elements).
template <typename T, template <typename> class Rows>
int by_vec(const void* a, const Rows<T>& rows, const void* h2c, void* out,
           void* scratch, void* counter, const Plan& p, cudaStream_t st) {
  constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  if (p.vec == kMax)
    return launch<T, kMax>(a, rows, h2c, out, scratch, counter, p, st);
  if (p.vec == kMax / 2)
    return launch<T, kMax / 2>(a, rows, h2c, out, scratch, counter, p, st);
  if constexpr (kMax / 4 >= 2) {
    if (p.vec == kMax / 4)
      return launch<T, kMax / 4>(a, rows, h2c, out, scratch, counter, p,
                                 st);
  }
  if constexpr (kMax / 8 >= 2) {
    if (p.vec == kMax / 8)
      return launch<T, kMax / 8>(a, rows, h2c, out, scratch, counter, p,
                                 st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: (B, R, S) fp32; v: (B, H, S, hd) of kv_type 0 fp32, 1 bf16, 2 int8
// (codes read as values); h2c: (B, H) int32 with values in [0, R); out:
// (B, H, hd) fp32. The plan (ts, n_split, tps, vec) is
// av_launch_config's; with n_split > 1, scratch holds B * H * n_split *
// hd fp32 and counter B * H int32 zeros (left at zero). v aligned to vec
// elements; all contiguous. Returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int chai_av_launch(const void* a, const void* v, const void* h2c,
                              void* out, void* scratch, void* counter, int B,
                              int R, int H, int S, int hd, int ts,
                              int n_split, int tps, int vec, int kv_type,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{B, R, H, S, hd, ts, n_split, tps, vec};
  if (kv_type == 1)
    return by_vec<__nv_bfloat16, DenseV>(
        a, DenseV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(v), H, S,
                                 hd},
        h2c, out, scratch, counter, p, st);
  if (kv_type == 2)
    return by_vec<int8_t, DenseV>(
        a, DenseV<int8_t>{static_cast<const int8_t*>(v), H, S, hd}, h2c,
        out, scratch, counter, p, st);
  return by_vec<float, DenseV>(
      a, DenseV<float>{static_cast<const float*>(v), H, S, hd}, h2c, out,
      scratch, counter, p, st);
}

// As chai_av_launch over a V page pool v_pool: (nP, H, page, hd) read
// through the block table bt_v: (B, P) int32; a: (B, R, P * page); the
// tile is the page. Every table entry must name a page of the pool (the
// null page 0 included).
extern "C" int paged_chai_av_launch(const void* a, const void* v_pool,
                                    const void* bt_v, const void* h2c,
                                    void* out, void* scratch, void* counter,
                                    int B, int R, int H, int P, int page,
                                    int hd, int n_split, int tps, int vec,
                                    int kv_type, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(bt_v);
  const Plan p{B, R, H, P * page, hd, page, n_split, tps, vec};
  if (kv_type == 1)
    return by_vec<__nv_bfloat16, PagedV>(
        a, PagedV<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(v_pool),
                                 bt, H, page, hd, P},
        h2c, out, scratch, counter, p, st);
  if (kv_type == 2)
    return by_vec<int8_t, PagedV>(
        a, PagedV<int8_t>{static_cast<const int8_t*>(v_pool), bt, H, page,
                          hd, P},
        h2c, out, scratch, counter, p, st);
  return by_vec<float, PagedV>(
      a, PagedV<float>{static_cast<const float*>(v_pool), bt, H, page, hd,
                       P},
      h2c, out, scratch, counter, p, st);
}
