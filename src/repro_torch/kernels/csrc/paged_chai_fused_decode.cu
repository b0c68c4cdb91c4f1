// One-pass fused clustered decode (CHAI STEADY attention) over block-table
// page pools, for Hopper: the continuous engine's paged STEADY decode.
//
// Replaces repro/kernels/chai_attention.py: paged_chai_fused_decode (the
// Pallas TPU kernel; its BlockSpec index maps read the scalar-prefetched
// block tables, one page per grid step). Same function as the dense kernel
// with tile t of batch row b located at page bt_k[b, t] of the K pool
// (the clustered pool, k_max rows) and page bt_v[b, t] of the V pool (the
// dense per-head pool): K and V take different tables. The tile size is
// the page. The block body is chai_decode_tiles.cuh's unit_block, the
// dense kernel's own, over the same split plan, so the two are bitwise
// equal when the dense tile equals the page.
//
// What bounds it: device memory, as for the dense kernel: the K rows of
// reps that have members and every head's V row, only the pages up to pos.
// Design: the dense kernel's (one block per (member slice, S split, batch
// row, K row), splits merged in order inside the launch), with each chunk's entries of
// the row's two block tables staged in shared memory, so shared memory
// stays fixed whatever the table's length. Only pages t <= pos / page are
// read, and every entry of a block table is a page id the engine
// allocated or the null page 0, so the mixed step's rows that are not
// STEADY (a WARMUP row's K table is all null page 0; a FREE row has pos 0)
// read in-bounds pages only; their outputs are discarded by the caller.

#include "chai_decode_tiles.cuh"

namespace {

using namespace chai;

struct Args {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const int* bt_k;
  const int* bt_v;
  const int* h2c;
  const int* pos;
  float* out;
  float* m;
  float* l;
  float* mp;
  float* lp;
  float* accp;
  int* counter;
  int R, H, kv_k, kv_v, P, page, hd, rpg, v_rep, window, n_cap;
  Plan plan;
  float scale;
};

template <typename T, int kQ, bool kEmit>
__global__ void __launch_bounds__(kThreads)
paged_chai_fused_decode_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  const int z = blockIdx.x, s = blockIdx.y, u = blockIdx.z;
  const int b = u / a.kv_k, g = u - b * a.kv_k;
  PagedTiles<T> tiles{static_cast<const T*>(a.k_pool),
                      static_cast<const T*>(a.v_pool),
                      a.bt_k + static_cast<size_t>(b) * a.P,
                      a.bt_v + static_cast<size_t>(b) * a.P,
                      a.kv_k, a.kv_v, a.page, a.hd,
                      (a.page & (a.page - 1)) ? -1 : __ffs(a.page) - 1,
                      nullptr, 0};
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
    auto kern = a.m ? paged_chai_fused_decode_kernel<T, kQ, true>
                    : paged_chai_fused_decode_kernel<T, kQ, false>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_slices = (a.H + a.n_cap - 1) / a.n_cap;
    dim3 grid(n_slices, a.plan.n_split, B * a.kv_k);
    kern<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, R, hd) fp32; k_pool: (nPk, kv_k, page, hd); v_pool:
// (nPv, kv_v, page, hd), both fp32 (kv_bf16 == 0) or bf16 (kv_bf16 == 1);
// bt_k, bt_v: (B, P) int32 page ids into their pools; h2c: (B, H) int32
// with values in [0, R); pos: (B,) int32; out: (B, H, hd) fp32; m, l:
// (B, R) fp32, or both null (finalized output; otherwise the state mode,
// as in chai_fused_decode_launch). The split plan (n_split ranges of
// ``tps`` pages), ``step`` (a divisor of the page, <= 128), the scratch
// and n_cap as in chai_fused_decode_launch. All contiguous and 16-byte
// aligned; hd % 8 == 0, hd <= 256. Returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int paged_chai_fused_decode_launch(
    const void* q, const void* k_pool, const void* v_pool, const void* bt_k,
    const void* bt_v, const void* h2c, const void* pos, void* out, void* m,
    void* l, void* mp, void* lp, void* accp, void* counter, int B, int R,
    int H, int kv_k, int kv_v, int P, int page, int hd, int step, int rpg,
    int v_rep, int window, int n_split, int tps, int n_cap, int kv_bf16,
    void* stream) {
  const Args a{static_cast<const float*>(q), k_pool, v_pool,
               static_cast<const int*>(bt_k), static_cast<const int*>(bt_v),
               static_cast<const int*>(h2c), static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), R, H, kv_k, kv_v, P, page, hd,
               rpg, v_rep, window, n_cap,
               Plan{n_split, tps, P, page, step}, inv_sqrt_hd(hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return with_queries(rpg, Launch<__nv_bfloat16>{a, B, st});
  return with_queries(rpg, Launch<float>{a, B, st});
}
