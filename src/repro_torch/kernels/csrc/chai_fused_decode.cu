// One-pass fused clustered decode (CHAI STEADY attention) over a dense
// cache, for Hopper.
//
// Replaces repro/kernels/chai_attention.py: chai_fused_decode (the Pallas
// TPU kernel, tile body _fused_tile; grid (B, S / ts) with the online
// softmax carried in VMEM scratch along the sequential S-tile axis).
// Output: (B, H, hd) fp32, or the unnormalized state (emit_state). The
// block body lives in chai_decode_tiles.cuh, shared with the paged kernel,
// which stays bitwise equal to this one at equal tile size.
//
// What bounds it: device memory. Per batch row it must read the K rows of
// the reps that have members and every head's V row at the positions
// 0..pos, once; at 1-5 queries per K row the multiply-adds are far below
// the tensor cores' line, so no wgmma. Design: the grid is (member
// slices, n_split, B * KVk): one block per (member slice, S split, batch
// row, K row), serving every rep of that K row and up to eight of their
// member heads, so a K row is read once for all its reps, a rep with many
// members spreads its V rows over several blocks, and the card holds
// enough blocks (the host's split plan aims at sixteen per SM: short
// splits keep each block's chain of memory round trips short). Each
// block streams its range in chunks with fixed shared memory (no sequence
// length is too long), scores one position per thread and sums V with
// 16-byte loads, and the splits merge in split order inside the launch
// (the unit's last block to arrive), so the call stays one launch with
// run-to-run identical bits. Each block is a chain of dependent memory
// round trips (positions, member list, K, V, the merge's reads), so at
// the main path's sizes the time is that chain, not the bytes.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* h2c;
  const int* pos;
  float* out;
  float* m;
  float* l;
  float* mp;
  float* lp;
  float* accp;
  int* counter;
  int R, H, kv_k, kv_v, S, hd, rpg, v_rep, window, n_cap;
  Plan plan;
  float scale;
};

template <typename T, int kQ, bool kEmit>
__global__ void __launch_bounds__(kThreads)
chai_fused_decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  const int z = blockIdx.x, s = blockIdx.y, u = blockIdx.z;
  const int b = u / a.kv_k, g = u - b * a.kv_k;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  DenseTiles<T> tiles{k + static_cast<size_t>(b) * a.kv_k * a.S * a.hd,
                      v + static_cast<size_t>(b) * a.kv_v * a.S * a.hd, a.S,
                      a.hd};
  const Members mem{a.h2c + static_cast<size_t>(b) * a.H, nullptr, a.H,
                    a.rpg, g, a.v_rep};
  const size_t rep0 = static_cast<size_t>(b) * a.R + g * a.rpg;
  const Outputs o{a.out + static_cast<size_t>(b) * a.H * a.hd,
                  kEmit ? a.m + rep0 : nullptr, kEmit ? a.l + rep0 : nullptr};
  const int ns = a.plan.n_split;
  const size_t part0 = static_cast<size_t>(b) * ns * a.R + g * a.rpg;
  const Partials part{
      a.mp ? a.mp + part0 : nullptr, a.lp ? a.lp + part0 : nullptr,
      a.accp ? a.accp + static_cast<size_t>(b) * ns * a.H * a.hd : nullptr,
      a.R, static_cast<size_t>(a.H) * a.hd, a.counter ? a.counter + u
                                                      : nullptr};
  unit_block<T, kQ, kEmit>(tiles, reinterpret_cast<float*>(smem_raw),
                           a.q + rep0 * a.hd, a.rpg, g, mem, a.plan, s, z,
                           a.pos[b], a.window, a.hd, a.n_cap, a.scale, o,
                           part);
}

template <typename T>
struct Launch {
  Args a;
  int B;
  cudaStream_t stream;
  template <int kQ>
  int run() const {
    const size_t smem = block_smem_bytes(kQ, a.hd, a.H, a.n_cap);
    // m and l null: the finalized mode; else the state mode
    auto kern = a.m ? chai_fused_decode_kernel<T, kQ, true>
                    : chai_fused_decode_kernel<T, kQ, false>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_slices = (a.H + a.n_cap - 1) / a.n_cap;
    dim3 grid(n_slices, a.plan.n_split, B * a.kv_k);
    kern<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, R, hd) fp32; k: (B, kv_k, S, hd); v: (B, kv_v, S, hd), both fp32
// (kv_bf16 == 0) or bf16 (kv_bf16 == 1); h2c: (B, H) int32 with values in
// [0, R); pos: (B,) int32; out: (B, H, hd) fp32; m, l: (B, R) fp32, or
// both null. All contiguous and 16-byte aligned; hd % 8 == 0, hd <= 256;
// R == kv_k * rpg with rpg <= 8; S % ts == 0; ``step`` (<= 128) divides
// ts. The split plan: n_split (<= 64) ranges of ``tps`` tiles; with
// n_split > 1 the scratch mp, lp (B, n_split, R), accp (B, n_split, H,
// hd) fp32 and counter (B * kv_k) int32, all zero, are needed (the merge
// leaves the counters at zero again); with n_split == 1 they may be null.
// A block serves n_cap (1..8) member heads of its unit. With m and l null, out
// is the finalized output; otherwise the state mode writes the
// unnormalized acc to out and each rep's m and l (emit_state). Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int chai_fused_decode_launch(
    const void* q, const void* k, const void* v, const void* h2c,
    const void* pos, void* out, void* m, void* l, void* mp, void* lp,
    void* accp, void* counter, int B, int R, int H, int kv_k, int kv_v,
    int S, int hd, int ts, int step, int rpg, int v_rep, int window,
    int n_split, int tps, int n_cap, int kv_bf16, void* stream) {
  const Args a{static_cast<const float*>(q), k, v,
               static_cast<const int*>(h2c), static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), R, H, kv_k, kv_v, S, hd, rpg,
               v_rep, window, n_cap,
               Plan{n_split, tps, S / ts, ts, step}, inv_sqrt_hd(hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return with_queries(rpg, Launch<__nv_bfloat16>{a, B, st});
  return with_queries(rpg, Launch<float>{a, B, st});
}

// The dynamic shared memory of one block in bytes, for a check that the
// host's mirror (kernels/chai_attention.py) agrees.
extern "C" int chai_decode_smem_bytes(int rpg, int hd, int n_map,
                                      int n_cap) {
  return static_cast<int>(block_smem_bytes(query_bucket(rpg), hd, n_map,
                                           n_cap));
}
