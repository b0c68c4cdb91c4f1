// One-pass fused clustered decode (CHAI STEADY attention) for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_fused_decode (the Pallas
// TPU kernel, tile body _fused_tile). For every batch row b and
// representative row j it computes rep j's masked scores against its K row
// once per S-tile, keeps the online-softmax state (running max m, sum l),
// and accumulates p . V[h] for every member head h with h2c[b, h] == j.
// Output: (B, H, hd) fp32, acc[h] / max(l, 1e-37).
//
// Arithmetic follows the TPU tile body step for step: scale 1/sqrt(hd),
// mask idx <= pos (and pos - idx < window when window > 0) to -2e38, the
// running max clamped >= -1e30, alpha = exp(m_prev - m_new), p = exp(sc -
// m_new), l = l * alpha + sum(p), acc = acc * alpha + p . V, one update
// per ts-wide tile. K/V elements are fp32 or bf16, all math in fp32. Rep j
// reads K row j / reps_per_group; head h reads V row h / v_rep (GQA).
//
// What bounds it: device memory. Per batch row it must read R*S*hd K and
// H*S*hd V elements once (only the tiles up to pos: later tiles are fully
// masked and would leave m, l and acc bitwise unchanged, so they are
// skipped). Design: one thread block per (b, j). The block loads its rep
// query once and builds its member list from h2c in shared memory; a rep
// with no members reads and writes nothing. Then, with a handful of
// barriers in all rather than several per tile:
//   1. scores: every live position's q.K, one warp per position, into
//      shared memory (at most S floats);
//   2. softmax scan: the tile maxima in parallel, one thread walks the
//      tiles in order computing m_new, alpha and (after the
//      probabilities p are written in parallel) the running l;
//   3. AV: each thread owns two adjacent output elements of one member
//      head, keeps acc in registers and streams that V column over the
//      tiles with paired loads, acc = acc * alpha_t + p_t . V_t per tile.
// Every K/V byte crosses from device memory once. At B=4, R=25 the grid is
// 100 blocks, which underfills the 132 SMs and keeps too few loads in
// flight to reach the bound; splitting S across blocks (split-S with a
// merge pass) and wgmma/TMA are left for later work.
//
// The tile steps are device functions over a "where is tile t" object,
// so a paged variant (tile t located through a block table) can reuse them
// and stay bitwise equal to this dense kernel at equal tile size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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
__device__ float softmax_scan(int n_live, int ts, float* sc_s, float* alpha_s,
                              float* m_s, float* stat_s, float* l_s) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
chai_fused_decode_kernel(const float* __restrict__ q,
                         const T* __restrict__ k, const T* __restrict__ v,
                         const int* __restrict__ h2c,
                         const int* __restrict__ pos,
                         float* __restrict__ out, int R, int H, int kv_k,
                         int kv_v, int S, int hd, int ts, int rpg, int v_rep,
                         int window, float scale) {
  extern __shared__ float smem[];
  const int n_tiles = S / ts;
  float* q_s = smem;                                     // hd
  float* sc_s = q_s + hd;                                // S
  float* alpha_s = sc_s + S;                             // n_tiles
  float* m_s = alpha_s + n_tiles;                        // n_tiles
  float* stat_s = m_s + n_tiles;                         // n_tiles
  int* members = reinterpret_cast<int*>(stat_s + n_tiles);  // H
  __shared__ int n_mem_s;
  __shared__ float l_s;

  const int j = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int h = 0; h < H; ++h)
      if (h2c[static_cast<size_t>(b) * H + h] == j) members[n++] = h;
    n_mem_s = n;
  }
  for (int d = threadIdx.x; d < hd; d += kThreads)
    q_s[d] = q[(static_cast<size_t>(b) * R + j) * hd + d];
  __syncthreads();
  const int n_mem = n_mem_s;
  if (n_mem == 0) return;  // no member head: nothing to compute or write

  const DenseTiles<T> tiles{k, v, kv_k, kv_v, S, ts, hd, b};
  const int p = pos[b];
  const int n_live = p < 0 ? 0 : min(p / ts, n_tiles - 1) + 1;
  tile_scores<T>(tiles, n_live, ts, hd, q_s, j / rpg, p, window, scale, sc_s);
  __syncthreads();
  const float l = softmax_scan(n_live, ts, sc_s, alpha_s, m_s, stat_s, &l_s);
  const float denom = fmaxf(l, 1e-37f);

  const int pairs = hd / 2;
  for (int e = threadIdx.x; e < n_mem * pairs; e += kThreads) {
    const int i = e / pairs, d = 2 * (e - i * pairs);
    const float2 acc = tile_av<T>(tiles, n_live, ts, hd, members[i] / v_rep,
                                  d, sc_s, alpha_s);
    float* o = out + (static_cast<size_t>(b) * H + members[i]) * hd + d;
    o[0] = acc.x / denom;
    o[1] = acc.y / denom;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* h2c,
           const void* pos, void* out, int B, int R, int H, int kv_k,
           int kv_v, int S, int hd, int ts, int rpg, int v_rep, int window,
           cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(hd) + S + 3 * static_cast<size_t>(S / ts)) *
          sizeof(float) + static_cast<size_t>(H) * sizeof(int);
  auto kern = chai_fused_decode_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  dim3 grid(R, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(h2c),
      static_cast<const int*>(pos), static_cast<float*>(out), R, H, kv_k,
      kv_v, S, hd, ts, rpg, v_rep, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, R, hd) fp32; k: (B, kv_k, S, hd); v: (B, kv_v, S, hd), both fp32
// (kv_bf16 == 0) or bf16 (kv_bf16 == 1); h2c: (B, H) int32 with values in
// [0, R); pos: (B,) int32; out: (B, H, hd) fp32. All contiguous; hd even
// and K/V aligned to two elements; S % ts == 0. Returns the launch's
// cudaError_t (0 on success); does not synchronise.
extern "C" int chai_fused_decode_launch(const void* q, const void* k,
                                        const void* v, const void* h2c,
                                        const void* pos, void* out, int B,
                                        int R, int H, int kv_k, int kv_v,
                                        int S, int hd, int ts, int rpg,
                                        int v_rep, int window, int kv_bf16,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16)
    return launch<__nv_bfloat16>(q, k, v, h2c, pos, out, B, R, H, kv_k, kv_v,
                                 S, hd, ts, rpg, v_rep, window, st);
  return launch<float>(q, k, v, h2c, pos, out, B, R, H, kv_k, kv_v, S, hd,
                       ts, rpg, v_rep, window, st);
}
