// Plain MHA/GQA flash decode over one shared K/V page pool read through
// block tables, for Hopper: the MHA baseline's decode attention (CHAI off)
// on the continuous engine's paged layout, the engine default.
//
// Replaces repro/kernels/flash_attention.py: paged_decode (the Pallas TPU
// kernel, body _paged_decode_kernel; its BlockSpec index maps read the
// scalar-prefetched block tables, one page per grid step). Same function
// as the dense kernel with position idx of batch row b in page
// bt_k[b, idx / page] (K) or bt_v[b, idx / page] (V) of the one pool, at
// row idx % page. Null table entries name page 0; they sit past pos and
// are never read. The block body is decode_tiles.cuh's decode_block, the
// dense kernel's own, so the two are bitwise equal when the dense tile
// equals the page.
//
// What bounds it: device memory, as for the dense kernel: the K and V
// rows of the live positions of each (b, KV group), once, plus the table
// entries of their pages. Design: the dense kernel's (a block per (KV
// group with up to 2 of its heads, S split, b); the split plan of the
// dense call at equal shapes; the ordered in-launch merge), reading the
// pool in place: the block reads each position's page id from the table
// (a cached read), so no densifying gather of the pool runs, and the table
// is not staged in shared memory (no cap on the number of pages).

#include "decode_tiles.cuh"

namespace {

using namespace flashdec;

struct Args {
  const void* q;
  const void* pool;
  const int* bt_k;
  const int* bt_v;
  const int* pos;
  float* out;
  float* mp;
  float* lp;
  float* accp;
  int* counter;
  int H, KV, P, page, hd, window, hb, n_hb, q_bf16;
  Plan plan;
  float scale;
};

template <typename T, int kH, int kHdMax>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  const int b = blockIdx.z, s = blockIdx.y, qpk = a.H / a.KV;
  const int g = blockIdx.x / a.n_hb, j0 = (blockIdx.x - g * a.n_hb) * a.hb;
  const int h0 = g * qpk + j0, nh = min(a.hb, qpk - j0);
  const PagedRows<T> rows{static_cast<const T*>(a.pool),
                          a.bt_k + static_cast<size_t>(b) * a.P,
                          a.bt_v + static_cast<size_t>(b) * a.P, a.KV, g,
                          a.page, a.hd};
  const size_t qo = (static_cast<size_t>(b) * a.H + h0) * a.hd;
  const void* qb = a.q_bf16
      ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(a.q) + qo)
      : static_cast<const void*>(static_cast<const float*>(a.q) + qo);
  const size_t p0 = static_cast<size_t>(b) * a.plan.n_split * a.H + h0;
  const Partials part{
      a.mp ? a.mp + p0 : nullptr, a.lp ? a.lp + p0 : nullptr,
      a.accp ? a.accp + p0 * a.hd : nullptr, a.H,
      a.counter ? a.counter + static_cast<size_t>(b) * gridDim.x + blockIdx.x
                : nullptr};
  decode_block<T, kH, kHdMax>(rows, qb, a.q_bf16, a.pos[b], a.plan, s,
                              a.window, nh, a.hd, a.scale, part,
                              a.out + qo);
}

template <typename T>
struct Launch {
  Args a;
  int B;
  cudaStream_t stream;
  template <int kH, int kHdMax>
  int run() const {
    dim3 grid(a.KV * a.n_hb, a.plan.n_split, B);
    paged_decode_kernel<T, kH, kHdMax><<<grid, kThreads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// q: (B, H, hd) fp32 (q_bf16 == 0) or bf16; pool: (nP, KV, page, hd),
// fp32 (kv_bf16 == 0) or bf16; bt_k, bt_v: (B, P) int32 page ids into the
// pool; pos: (B,) int32; out: (B, H, hd) fp32. All contiguous and 16-byte
// aligned; H % KV == 0; hd % 8 == 0, hd <= 320 (the
// instance of kHdMax 256 up to 256, the wide one of 320 above). Head h reads
// KV row h / (H / KV); each block serves hb (1 or 2) heads of one group.
// The split plan (n_split ranges of ``tps`` pages) and its scratch are
// flash_decode_launch's. window > 0 masks positions idx <= pos - window.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int paged_decode_launch(const void* q, const void* pool,
                                   const void* bt_k, const void* bt_v,
                                   const void* pos, void* out, void* mp,
                                   void* lp, void* accp, void* counter,
                                   int B, int H, int KV, int P, int page,
                                   int hd, int window, int hb,
                                   int n_split, int tps, int q_bf16,
                                   int kv_bf16, void* stream) {
  const int n_hb = (H / KV + hb - 1) / hb;
  const Args a{q, pool, static_cast<const int*>(bt_k),
               static_cast<const int*>(bt_v), static_cast<const int*>(pos),
               static_cast<float*>(out), static_cast<float*>(mp),
               static_cast<float*>(lp), static_cast<float*>(accp),
               static_cast<int*>(counter), H, KV, P, page, hd, window, hb,
               n_hb, q_bf16, Plan{n_split, tps, P, page},
               inv_sqrt_hd(hd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_bf16) return with_heads(hb, hd, Launch<__nv_bfloat16>{a, B, st});
  return with_heads(hb, hd, Launch<float>{a, B, st});
}
