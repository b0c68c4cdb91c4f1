// Raw masked representative-head scores, the first stage of the
// three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_qk, chai_qk_i8 and
// paged_chai_qk (three Pallas TPU kernels with one body: a (B, R, S/ts)
// grid, one K tile per step, located densely or through the block table).
// Output: (B, R, S) fp32, scores[b, j, s] = dot(q[b, j], K[kv_row, s]) *
// (1 / sqrt(hd)) with rep j reading K row j / reps_per_group, exactly
// -2e38 where s > pos[b] or (window > 0 and pos[b] - s >= window). K is
// fp32, bf16 or int8; int8 codes are read as their values, and with row
// scales (chai_qk_i8) the fp32 scale is applied after the dot, in the
// Pallas kernel's order: dot(k_i8, q) * k_scale[row] * (1 / sqrt(hd)).
// Without scales the codes alone are the values, as the Pallas bodies
// cast whatever K they are given.
//
// What bounds it: device memory. Each K row at a valid position must be
// read once, whatever reps share it (n_valid * hd elements a K row: one
// byte each for int8), and the (B, R, S) fp32 scores written once. At
// the pipeline's decode shapes that is a few MB, so the time is set by
// how many bytes are in flight and by how many memory round trips one
// block waits for, one after another.
//
// Design. kernels/chai_attention.py: qk_launch_config cuts the work from
// the shapes alone: a block serves one K row of one batch row, a chunk of
// ``positions`` consecutive positions and every rep of the K row (up to
// kMaxReps; more reps go to further blocks, ``slices`` of them), so a GQA
// group's K row is read once for all its reps. A row is read by a group
// of ``lanes`` threads (a power of two up to 32) with loads of 16 bytes,
// or the widest of 8, 4, 2 bytes whose element count divides hd. In each
// of the block's ``rounds``, a thread takes ``rows`` (at most kRows)
// positions, neighbouring groups on neighbouring rows, and issues all
// their loads before its first multiply-add; the row stays in registers
// while the block's reps are dotted with it, one rep after another (one
// compact body whatever the reps: unrolled over 8 reps, it took 0.0154
// ms against 0.0123 at the GQA lane's layer-0 shapes, tools/qk_ab.py on
// an H100 80GB HBM3). A row wider than 32 loads takes further passes.
// Each thread sums each load's elements (fmaf from zero, in element
// order), adds its loads' partials in load order, and the group adds its
// lanes' partials in a shuffle tree (offsets lanes/2 .. 1): one fixed
// order for every position, set by hd and the element type alone, so the
// dense and the paged kernel and two launches give the same bits. No
// atomics. The scores are staged in shared memory and written with
// coalesced 16-byte stores (4-byte ones when S % 4 != 0). A chunk (or a
// round) wholly outside the valid range loads nothing and writes -2e38;
// inside a partly valid one only valid rows are loaded, and the masked
// constant is written, never a dot. Before its rounds the block stages
// its queries, the int8 row scales of its valid positions (chai_qk_i8),
// and, paged, the pool offset of each valid position's row (one table
// read a position, not one a round and thread); one barrier. kRows is 4:
// 8 rows in flight a thread took more registers (fewer blocks an SM) and
// ran S = 65,536 at 0.165 ms against 0.149 (the same tool and card).
// What holds it back: at decode shapes a launch is about one wave of
// blocks, each a chain of two memory round trips (queries and tables,
// then K) and its rep loop, so the time is latency, not bytes; the paged
// kernel at long S reads 4 KB page runs scattered over the pool.

#include <stddef.h>
#include <stdint.h>

#include "chai_decode_tiles.cuh"
#include "row_loads.cuh"

namespace {

using chai::allow_smem;
using chai::elem;
using chai::inv_sqrt_hd;
using chai::kNegInf;
using chai::kThreads;
using chai::Raw;

constexpr int kRows = 4;      // positions a thread loads before it adds
constexpr int kMaxReps = 8;   // reps of one K row a block serves

// The launch's cut, as kernels/chai_attention.py: qk_launch_config gives
// it, with the problem's sizes.
struct Plan {
  int B, R, kv, S, hd, rpg, window;
  int vec, lanes, rows, positions, reps, slices, n_chunks;
  float scale;
};

// Dense cache (B, kv, S, hd): K row kr of batch row b at position s.
template <typename T>
struct DenseK {
  const T* k;
  int kv, s, hd;
  struct Unit {
    const T* base;
    int hd;
    __device__ void stage(int, int, int, void*, int) const {}
    __device__ const T* row(int s, int, const void*) const {
      return base + static_cast<size_t>(s) * hd;
    }
  };
  __device__ Unit unit(int b, int kr) const {
    return Unit{k + (static_cast<size_t>(b) * kv + kr) * s * hd, hd};
  }
};

// Page pool (nP, kv, page, hd) through the block table bt (B, P):
// position s of batch row b is row s % page of page bt[b, s / page]. The
// block locates each of its valid positions [lo, hi] once, as the element
// offset of its row in the pool, in shared memory (not once a round and
// thread, with two divisions by the page each time).
template <typename T>
struct PagedK {
  static constexpr int kAux = 2;          // one 64-bit offset a position
  const T* k;
  const int* bt;
  int kv, page, hd, n_pages;
  struct Unit {
    const T* pool;
    const int* bt_row;
    int kv, kr, page, hd;
    __device__ void stage(int c0, int lo, int hi, void* aux, int tid) const {
      long long* off = static_cast<long long*>(aux);
      for (int s0 = lo + tid; s0 <= hi; s0 += kRows * kThreads) {
        int pg[kRows];
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int s = s0 + t * kThreads;
          pg[t] = s <= hi ? __ldg(bt_row + s / page) : 0;
        }
#pragma unroll
        for (int t = 0; t < kRows; ++t) {
          const int s = s0 + t * kThreads;
          if (s <= hi)
            off[s - c0] = ((static_cast<long long>(pg[t]) * kv + kr) * page
                           + s % page) * hd;
        }
      }
    }
    __device__ const T* row(int s, int c0, const void* aux) const {
      return pool + static_cast<const long long*>(aux)[s - c0];
    }
  };
  __device__ Unit unit(int b, int kr) const {
    return Unit{k, bt + static_cast<size_t>(b) * n_pages, kv, kr, page, hd};
  }
};

// kVec fp32 queries from shared memory (16-byte aligned when kVec % 4 ==
// 0, 8-byte when kVec == 2).
template <int kVec>
__device__ __forceinline__ void load_q(const float* p, float* qv) {
  if constexpr (kVec % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + e);
      qv[e] = x.x; qv[e + 1] = x.y; qv[e + 2] = x.z; qv[e + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    qv[0] = x.x; qv[1] = x.y;
  }
}

// n fp32 values (the block's queries or row scales) into shared memory,
// kRows loads a thread in flight at once (not one round trip a load).
__device__ __forceinline__ void stage_floats(const float* __restrict__ src,
                                             int n, float* dst, int tid) {
  for (int i0 = tid; i0 < n; i0 += kRows * kThreads) {
    float x[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int i = i0 + t * kThreads;
      x[t] = i < n ? __ldg(src + i) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int i = i0 + t * kThreads;
      if (i < n) dst[i] = x[t];
    }
  }
}

// The block's nr score rows over its n positions, from the staged ``sc``
// (or -2e38 everywhere when sc is null); 16-byte stores when S % 4 == 0
// (then the chunk's start and length are multiples of 4).
__device__ void store_rows(float* o, const float* sc, int nr, int n,
                           const Plan& a, int tid) {
  for (int r = 0; r < nr; ++r) {
    float* dst = o + static_cast<size_t>(r) * a.S;
    const float* src = sc + r * a.positions;
    if (a.S % 4 == 0) {
      const float4 neg = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      for (int i = 4 * tid; i < n; i += 4 * kThreads)
        *reinterpret_cast<float4*>(dst + i) =
            sc ? *reinterpret_cast<const float4*>(src + i) : neg;
    } else {
      for (int i = tid; i < n; i += kThreads) dst[i] = sc ? src[i] : kNegInf;
    }
  }
}

template <typename T, int kVec, typename Rows>
__global__ void __launch_bounds__(kThreads)
qk_kernel(const float* __restrict__ q, const Rows rows,
          const float* __restrict__ k_scale, const int* __restrict__ pos,
          float* __restrict__ out, const Plan a) {
  using Load = Raw<kVec * static_cast<int>(sizeof(T))>;
  constexpr int kWords = Load::kWords;
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);       // reps x positions
  float* q_s = sc + a.reps * a.positions;             // reps x hd
  float* aux = q_s + a.reps * a.hd;   // positions: int8 row scales (dense)
                                      // or row offsets (paged)

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x % a.n_chunks;
  const int unit = blockIdx.x / a.n_chunks;   // (b * kv + kr) * slices + z
  const int z = unit % a.slices;
  const int b = unit / a.slices / a.kv;
  const int kr = unit / a.slices % a.kv;
  const int j0 = kr * a.rpg + z * a.rpg / a.slices;
  const int nr = kr * a.rpg + (z + 1) * a.rpg / a.slices - j0;
  const int c0 = chunk * a.positions;
  const int n = min(a.S - c0, a.positions);
  const int p = pos[b];
  const int lo = a.window > 0 ? max(c0, p - a.window + 1) : c0;
  const int hi = min(c0 + n - 1, p);
  float* o = out + (static_cast<size_t>(b) * a.R + j0) * a.S + c0;
  if (lo > hi) {                           // masked: no K byte is read
    store_rows(o, nullptr, nr, n, a, tid);
    return;
  }

  const auto ku = rows.unit(b, kr);
  stage_floats(q + (static_cast<size_t>(b) * a.R + j0) * a.hd, nr * a.hd,
               q_s, tid);
  if (k_scale)
    stage_floats(k_scale + (static_cast<size_t>(b) * a.kv + kr) * a.S + lo,
                 hi - lo + 1, aux + (lo - c0), tid);
  ku.stage(c0, lo, hi, aux, tid);
  __syncthreads();

  const int lanes = a.lanes, ng = kThreads / lanes;
  const int g = tid / lanes, l = tid % lanes;
  const int cols = a.hd / kVec;             // loads of one row
  const int passes = (cols + lanes - 1) / lanes;
  const int per_round = ng * a.rows;
  for (int r0 = 0; r0 < n; r0 += per_round) {       // the block's rounds
    // a round wholly outside [lo, hi] loads nothing (block-uniform)
    const bool any = c0 + r0 <= hi && c0 + min(n, r0 + per_round) - 1 >= lo;
    auto live = [&](int u) {                // row u of this thread is valid
      const int s = c0 + r0 + g + ng * u;
      return u < a.rows && s >= lo && s <= hi;
    };
    unsigned w[kRows][kWords];
    auto load = [&](int t) {                // the t-th load of each row
      const int piece = l + lanes * t;
      if (piece >= cols) return;
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (live(u))
          Load::load(ku.row(c0 + r0 + g + ng * u, c0, aux) + piece * kVec,
                     w[u]);
    };
    if (any) load(0);
    for (int r = 0; r < nr; ++r) {
      float acc[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
      if (any) {
        for (int t = 0; t < passes; ++t) {
          // a one-pass row stays in registers for every rep; a wider one
          // is loaded again (from L1 after the first rep)
          if (passes > 1 && (t > 0 || r > 0)) load(t);
          const int piece = l + lanes * t;
          if (piece >= cols) continue;
          float qv[kVec];
          load_q<kVec>(q_s + r * a.hd + piece * kVec, qv);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            if (!live(u)) continue;
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              part = fmaf(qv[e], elem<T>(w[u], e), part);
            acc[u] += part;
          }
        }
        // the group's lanes, in a shuffle tree; every lane ends with the
        // sum
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (u >= a.rows) break;           // block-uniform
          float v = acc[u];
          for (int m = lanes / 2; m > 0; m >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, m);
          acc[u] = v;
        }
      }
      // stage the rep's scores (a group's stores spread over its lanes)
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = r0 + g + ng * u;
        if (u < a.rows && i < n && l == (u & (lanes - 1))) {
          const bool valid = c0 + i >= lo && c0 + i <= hi;
          sc[r * a.positions + i] =
              valid ? acc[u] * (k_scale ? aux[i] : 1.f) * a.scale : kNegInf;
        }
      }
    }
  }
  __syncthreads();
  store_rows(o, sc, nr, n, a, tid);
}

template <typename T, template <typename> class Rows>
struct Launch {
  const void* q;
  Rows<T> rows;
  const void* k_scale;
  const void* pos;
  void* out;
  Plan p;
  int aux;               // words a block stages for its positions
  cudaStream_t stream;

  template <int kVec>
  int go() const {
    const size_t smem =
        (static_cast<size_t>(p.reps) * (p.positions + p.hd) + aux) * 4;
    auto kern = qk_kernel<T, kVec, Rows<T>>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks =
        static_cast<long long>(p.B) * p.kv * p.slices * p.n_chunks;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<const float*>(q), rows,
        static_cast<const float*>(k_scale), static_cast<const int*>(pos),
        static_cast<float*>(out), p);
    return static_cast<int>(cudaGetLastError());
  }

  // the instance for p.vec elements a load: 16 bytes, or 8, 4, 2 when the
  // row is not a multiple of the wider load (at least two elements)
  int run() const {
    constexpr int kMax = 16 / static_cast<int>(sizeof(T));
    if (p.vec == kMax) return go<kMax>();
    if (p.vec == kMax / 2) return go<kMax / 2>();
    if constexpr (kMax / 4 >= 2) {
      if (p.vec == kMax / 4) return go<kMax / 4>();
    }
    if constexpr (kMax / 8 >= 2) {
      if (p.vec == kMax / 8) return go<kMax / 8>();
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
};

Plan make_plan(int B, int R, int kv, int S, int hd, int rpg, int window,
               int vec, int lanes, int rows, int positions, int reps,
               int slices) {
  return Plan{B, R, kv, S, hd, rpg, window, vec, lanes, rows, positions,
              reps, slices, (S + positions - 1) / positions,
              inv_sqrt_hd(hd)};
}

bool plan_ok(const Plan& p) {
  return p.reps >= 1 && p.reps <= kMaxReps && p.rows >= 1 &&
         p.rows <= kRows && p.lanes >= 1 && p.lanes <= 32 &&
         (p.lanes & (p.lanes - 1)) == 0 &&
         p.positions % (kThreads / p.lanes * p.rows) == 0 &&
         p.positions % 4 == 0;
}

template <typename T>
int dense(const void* q, const void* k, const void* k_scale, const void* pos,
          void* out, const Plan& p, cudaStream_t st) {
  return Launch<T, DenseK>{
      q, DenseK<T>{static_cast<const T*>(k), p.kv, p.S, p.hd}, k_scale, pos,
      out, p, k_scale ? p.positions : 0, st}.run();
}

}  // namespace

// q: (B, R, hd) fp32; k: (B, kv, S, hd) of kv_type 0 fp32, 1 bf16, 2 int8
// (codes read as values, no scale); pos: (B,) int32; out: (B, R, S)
// fp32. R == kv * rpg; the cut (vec, lanes, rows, positions, reps,
// slices) is qk_launch_config's; k aligned to vec elements; all
// contiguous. Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int chai_qk_launch(const void* q, const void* k, const void* pos,
                              void* out, int B, int R, int kv, int S, int hd,
                              int rpg, int window, int kv_type, int vec,
                              int lanes, int rows, int positions, int reps,
                              int slices, void* stream) {
  const Plan p = make_plan(B, R, kv, S, hd, rpg, window, vec, lanes, rows,
                           positions, reps, slices);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_type == 1)
    return dense<__nv_bfloat16>(q, k, nullptr, pos, out, p, st);
  if (kv_type == 2) return dense<int8_t>(q, k, nullptr, pos, out, p, st);
  return dense<float>(q, k, nullptr, pos, out, p, st);
}

// As chai_qk_launch over an int8 cache k: (B, kv, S, hd) with fp32 row
// scales k_scale: (B, kv, S).
extern "C" int chai_qk_i8_launch(const void* q, const void* k,
                                 const void* k_scale, const void* pos,
                                 void* out, int B, int R, int kv, int S,
                                 int hd, int rpg, int window, int vec,
                                 int lanes, int rows, int positions,
                                 int reps, int slices, void* stream) {
  const Plan p = make_plan(B, R, kv, S, hd, rpg, window, vec, lanes, rows,
                           positions, reps, slices);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  return dense<int8_t>(q, k, k_scale, pos, out, p,
                       static_cast<cudaStream_t>(stream));
}

// As chai_qk_launch over a page pool k_pool: (nP, kv, page, hd) read
// through the block table bt: (B, P) int32; S == P * page. Every table
// entry a valid position reaches must name a page of the pool.
extern "C" int paged_chai_qk_launch(const void* q, const void* k_pool,
                                    const void* bt, const void* pos,
                                    void* out, int B, int R, int kv, int P,
                                    int page, int hd, int rpg, int window,
                                    int kv_type, int vec, int lanes,
                                    int rows, int positions, int reps,
                                    int slices, void* stream) {
  const Plan p = make_plan(B, R, kv, P * page, hd, rpg, window, vec, lanes,
                           rows, positions, reps, slices);
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt_i = static_cast<const int*>(bt);
  const int aux = PagedK<float>::kAux * positions;
  if (kv_type == 1)
    return Launch<__nv_bfloat16, PagedK>{
        q, PagedK<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(k_pool),
                                 bt_i, kv, page, hd, P},
        nullptr, pos, out, p, aux, st}.run();
  if (kv_type == 2)
    return Launch<int8_t, PagedK>{
        q, PagedK<int8_t>{static_cast<const int8_t*>(k_pool), bt_i, kv,
                          page, hd, P},
        nullptr, pos, out, p, aux, st}.run();
  return Launch<float, PagedK>{
      q, PagedK<float>{static_cast<const float*>(k_pool), bt_i, kv, page, hd,
                       P},
      nullptr, pos, out, p, aux, st}.run();
}
