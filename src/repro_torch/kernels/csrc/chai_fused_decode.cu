// One-pass fused clustered decode (CHAI STEADY attention) over a dense
// cache, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_fused_decode (the Pallas
// TPU kernel, tile body _fused_tile). Output: (B, H, hd) fp32. The tile
// steps and the block body live in chai_decode_tiles.cuh, shared with the
// paged kernel, which stays bitwise equal to this one at equal tile size.
//
// What bounds it: device memory. Per batch row it must read R*S*hd K and
// H*S*hd V elements once (only the tiles up to pos). Design: one thread
// block per (b, j). The block loads its rep query once and builds its
// member list from h2c in shared memory; a rep with no members reads and
// writes nothing. Then, with a handful of barriers in all rather than
// several per tile:
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

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

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
  const DenseTiles<T> tiles{k, v, kv_k, kv_v, S, ts, hd,
                            static_cast<int>(blockIdx.y)};
  decode_block<T>(tiles, q, h2c, pos, out, R, H, S / ts, ts, hd, rpg, v_rep,
                  window, scale, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* h2c,
           const void* pos, void* out, int B, int R, int H, int kv_k,
           int kv_v, int S, int hd, int ts, int rpg, int v_rep, int window,
           cudaStream_t stream) {
  const size_t smem = block_smem_bytes(hd, S / ts, ts, H);
  auto kern = chai_fused_decode_kernel<T>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(R, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(h2c),
      static_cast<const int*>(pos), static_cast<float*>(out), R, H, kv_k,
      kv_v, S, hd, ts, rpg, v_rep, window, inv_sqrt_hd(hd));
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
