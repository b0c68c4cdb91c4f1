// Masked softmax of each (b, rep) row of the raw clustered scores, the
// second stage of the three-kernel CHAI decode pipeline, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: row_softmax (the Pallas TPU
// kernel: one (b, rep) row of S scores per grid step, whole in VMEM).
// Output: (B, R, S) fp32, y = p / max(sum(p), 1e-37) with p = exp(x - m)
// and m = max(max(x), -1e30). A row masked everywhere (every entry
// -2e38) gives m = -1e30, p = exp(-2e38 + 1e30) = 0 and so all zeros, not
// NaN. expf, and the quotient rounded as IEEE division rounds it
// (``div_by``); no fast math.
//
// What bounds it: device memory: one read and one write of the (B, R, S)
// fp32 row tensor, a few operations a byte. Design: each row is read once
// from device memory into registers and written once. A team of threads
// holds a row, each thread kV loads of kVW floats (16-byte loads when S %
// 4 == 0), all issued before any arithmetic:
//   - a row of at most 256 * 4 loads: a team of 32..256 threads of one
//     block (two warps for the pipeline's S = 1024), several rows a block
//     when the rows are many;
//   - a longer row: a thread block cluster of up to 8 blocks of 256
//     threads, up to 8 loads a thread (Hopper's distributed shared
//     memory); a short grid spreads each row over more blocks of its
//     cluster (kernels/chai_attention.py: softmax_launch_config);
//   - a row longer than a cluster holds (more than 8 * 256 * 8 loads: S
//     > 65,536 at 16-byte loads) streams: each thread keeps an online
//     (m, l) over its loads chunk by chunk, and a second read writes the
//     output. Two reads, never three.
// Each thread reduces its own values to a pair (m_t, l_t = sum exp(x -
// m_t)), keeping p = exp(x - m_t); the pairs merge once a level, in a
// fixed order: the warp by shuffles, the team's warps through shared
// memory (one barrier), the cluster's blocks in rank order through
// distributed shared memory (one cluster barrier), so every block
// computes the same m and l and two launches give the same bits. The
// output is p exp(m_t - m) / l.

#include <cooperative_groups.h>

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;
namespace cg = cooperative_groups;

constexpr int kMaxThreads = 256;        // threads of a block
constexpr int kMaxWarps = kMaxThreads / 32;

struct Args {
  const float* x;
  float* y;
  int rows, S, n_vec;   // rows of S floats, n_vec loads a row
  int team;             // threads of one block on a row
  int rows_per_block;   // teams of a block (cluster == 1)
  int cluster;          // blocks on a row
  int chunks;           // passes of a thread's kV loads over the row
};

template <int kVW>
struct Load;
template <>
struct Load<4> {
  __device__ static void get(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Load<1> {
  __device__ static void get(const float* p, float* v) { v[0] = *p; }
  __device__ static void put(float* p, const float* v) { *p = v[0]; }
};

// A pairwise tree over the N values of x (max, or sum): log2(N) dependent
// steps instead of N.
template <int N>
__device__ __forceinline__ float tree(const float (&x)[N], bool is_max) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = x[i];
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w)
      t[i] = is_max ? fmaxf(t[i], t[i + w]) : t[i] + t[i + w];
  return t[0];
}

// a / l rounded as IEEE division rounds it, from r = 1 / l (IEEE, once a
// thread): q0 = a r, the residual a - l q0 exact by fma, q = q0 + e r.
// That is the correctly rounded quotient wherever it is a normal number
// (Markstein; l >= 1 for a row with a live entry), without the division's
// per-element test and branch to its slow path, which serialized the
// elements of a thread (a copy of this source dividing each element ran
// 3.2x slower at 32 values a thread on the H100: tools/softmax_ab.py
// --variants). A quotient below 2^-126 may differ from the division's by
// one unit of 2^-149.
__device__ __forceinline__ float div_by(float a, float l, float r) {
  const float q0 = __fmul_rn(a, r);
  const float e = __fmaf_rn(-l, q0, a);
  return __fmaf_rn(e, r, q0);
}

// (m, l) of two parts of a row merged: m = max(m1, m2), l = l1 exp(m1 - m)
// + l2 exp(m2 - m); every m is >= -1e30, so nothing is inf - inf.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mm = fmaxf(m, m2);
  l = l * expf(m - mm) + l2 * expf(m2 - mm);
  m = mm;
}

// The row's (m, l) from each thread's (m_t, l_t) (its values' max, >=
// -1e30, and the sum of exp(x - m_t)), in a fixed order, in one exchange
// a level: the warp's max by shuffles, each thread's l rescaled to it and
// summed by shuffles; the team's warps in order through ``red`` (one pair
// a warp, one barrier); the cluster's blocks in rank order through ``cl``
// (the block's pair, read by the others from its shared memory after one
// cluster barrier). Every thread of the team gets the result.
__device__ void row_reduce(float& m, float& l, float2* red, float2* cl,
                           const Args& a) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float mw = m;
  for (int o = 16; o > 0; o >>= 1)
    mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  float lw = l * expf(m - mw);
  for (int o = 16; o > 0; o >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, o);
  m = mw;
  l = lw;
  if (a.team > 32) {
    if (lane == 0) red[warp] = make_float2(m, l);
    __syncthreads();
    const int w0 = (tid / a.team) * (a.team / 32);
    m = red[w0].x;
    l = red[w0].y;
    for (int w = 1; w < a.team / 32; ++w) merge(m, l, red[w0 + w].x,
                                                red[w0 + w].y);
  }
  if (a.cluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) *cl = make_float2(m, l);
    cluster.sync();
    const float2 first = *cluster.map_shared_rank(cl, 0);
    m = first.x;
    l = first.y;
    for (int r = 1; r < a.cluster; ++r) {
      const float2 x = *cluster.map_shared_rank(cl, r);
      merge(m, l, x.x, x.y);
    }
  }
}

template <int kV, int kVW>
__global__ void __launch_bounds__(kMaxThreads)
row_softmax_kernel(const Args a) {
  __shared__ float2 red[kMaxWarps];   // per warp: its (m, l)
  __shared__ float2 cl;               // the block's (m, l)
  const int tid = threadIdx.x;
  int row, g;   // the row, and this thread's place among its threads
  if (a.cluster > 1) {
    const int rank = static_cast<int>(blockIdx.x) % a.cluster;
    row = static_cast<int>(blockIdx.x) / a.cluster;
    g = rank * a.team + tid;
  } else {
    row = static_cast<int>(blockIdx.x) * a.rows_per_block + tid / a.team;
    g = tid % a.team;
  }
  const bool live = row < a.rows;
  const int tt = a.team * a.cluster;   // threads over the row
  const size_t base = static_cast<size_t>(live ? row : 0) * a.S;
  const float* xr = a.x + base;
  float* yr = a.y + base;
  constexpr int kN = kV * kVW;
  float v[kN];   // load i's values at v[i * kVW ...]
  // loads i of chunk c: the thread's vectors c * tt * kV + i * tt + g;
  // past the row: -2e38, which adds 0 to every sum
  auto load = [&](int c) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int vi = (c * kV + i) * tt + g;
      if (live && vi < a.n_vec) {
        Load<kVW>::get(xr + static_cast<size_t>(vi) * kVW, v + i * kVW);
      } else {
#pragma unroll
        for (int e = 0; e < kVW; ++e) v[i * kVW + e] = kNegInf;
      }
    }
  };
  auto store = [&](int c) {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int vi = (c * kV + i) * tt + g;
      if (live && vi < a.n_vec)
        Load<kVW>::put(yr + static_cast<size_t>(vi) * kVW, v + i * kVW);
    }
  };
  // this thread's values: their max (>= -1e30), v <- exp(v - max), and
  // the sum of those
  auto exp_sum = [&](float& mx) {
    mx = fmaxf(tree(v, true), -1e30f);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = expf(v[i] - mx);
    return tree(v, false);
  };

  float m_t, l_t;
  if (a.chunks == 1) {   // the row held in registers: one read
    load(0);
    l_t = exp_sum(m_t);
  } else {               // an online (m, l) per thread over the chunks
    m_t = -1e30f;
    l_t = 0.f;
    for (int c = 0; c < a.chunks; ++c) {
      load(c);
      float mc;
      const float lc = exp_sum(mc);
      merge(m_t, l_t, mc, lc);
    }
  }
  float m = m_t, l = l_t;
  row_reduce(m, l, red, &cl, a);
  if (a.cluster > 1)   // the last remote read is done: others may exit
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  l = fmaxf(l, 1e-37f);
  const float r = __frcp_rn(l);
  if (a.chunks == 1) {   // y = exp(x - m_t) exp(m_t - m) / l
    const float f = expf(m_t - m);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = div_by(__fmul_rn(v[i], f), l, r);
    store(0);
  } else {               // the second read: y = exp(x - m) / l
    for (int c = 0; c < a.chunks; ++c) {
      load(c);
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] = div_by(expf(v[i] - m), l, r);
      store(c);
    }
  }
  // a block's shared memory stays until the cluster has read it
  if (a.cluster > 1)
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int kV, int kVW>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = a.cluster > 1
                         ? a.rows * a.cluster
                         : (a.rows + a.rows_per_block - 1) / a.rows_per_block;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(a.cluster > 1 ? a.team : a.team * a.rows_per_block);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, row_softmax_kernel<kV, kVW>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kVW>
int launch_vw(const Args& a, int vecs, cudaStream_t stream) {
  if (vecs == 8) return launch<8, kVW>(a, stream);
  if (vecs == 4) return launch<4, kVW>(a, stream);
  if (vecs == 2) return launch<2, kVW>(a, stream);
  return launch<1, kVW>(a, stream);
}

}  // namespace

// x, y: (rows, S) fp32, contiguous (rows = B * R), 16-byte aligned when
// vw == 4 (then S % 4 == 0). The plan (kernels/chai_attention.py:
// softmax_launch_config): vw floats a load (4 or 1), vecs loads a thread
// holds (1, 2, 4 or 8), ``team`` threads (a multiple of 32, at most 256)
// of a block on a row, rows_per_block teams a block, ``cluster`` blocks
// (1..8, the portable size; a thread block cluster when > 1, then
// rows_per_block == 1) on a row, ``chunks`` passes over it (1: the row in
// registers). Returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int row_softmax_launch(const void* x, void* y, int rows, int S,
                                  int vw, int vecs, int team,
                                  int rows_per_block, int cluster, int chunks,
                                  void* stream) {
  const Args a{static_cast<const float*>(x), static_cast<float*>(y), rows, S,
               (S + vw - 1) / vw, team, rows_per_block, cluster, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (team % 32 || team > kMaxThreads || cluster < 1 || cluster > 8 ||
      (cluster > 1 && rows_per_block != 1) ||
      team * rows_per_block > kMaxThreads || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return vw == 4 ? launch_vw<4>(a, vecs, st) : launch_vw<1>(a, vecs, st);
}
