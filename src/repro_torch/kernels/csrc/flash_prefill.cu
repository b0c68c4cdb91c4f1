// Causal flash attention over a prefill chunk, for Hopper.
//
// Replaces repro/kernels/flash_attention.py: flash_prefill (the Pallas TPU
// kernel; grid (B, H, T/tq, S/ts) with the kv-tile axis sequential and the
// online-softmax state in VMEM scratch). Queries at absolute positions
// offset + t attend keys 0 .. S-1 with key <= query; head h reads KV head
// h / (H / KV) (GQA). The output is either finalized, (B, T, H, hd) in the
// input dtype, or the head-major online-softmax state m, l (B, H, T) and
// acc (B, H, T, hd) in fp32, which the chunked prefill merges with
// paged_prefix_attend's state over the earlier chunks.
//
// The Pallas kernel's two modes: a sliding ``window`` (> 0: key k is
// visible to the query at position p iff p - window < k <= p) and the
// ``softcap`` (gemma2's attention-logit cap: each scaled score becomes
// cap * tanh(score / cap) before the mask; flash_tiles.cuh: attend_tile).
// With a window the block's key loop starts at the first tile that holds
// a key inside its first row's window (the Pallas kernel's window skip),
// and a warp skips a tile wholly before its own first row's window, so
// tiles outside every window are never read. A row whose window holds no
// key (positions past S + window - 1) writes the exact merge identity.
// The modes run in their own instance of the kernel (kModes): the plain
// instance has neither the window's arithmetic nor the cap's branch, and
// runs as fast as before they were added (tools/prefill_ab.py timed the
// plain mode 1.31x slower with both compiled into one instance).
//
// What bounds it: at a chunk of T = 128 queries the work is small (q, k, v
// and the output are ~1 MB each in bf16 at 32 heads of 128), so the least
// time is the bytes over device memory; the first port, which did every
// multiply-add on the CUDA cores out of fp32 shared memory, took 17x that
// and 5x causal SDPA. Design: one block per (query tile of 64 rows, head,
// batch row): four query warps each owning 16 rows (a probe on the card
// timed 1, 2 and 4 warps: 4 was the fastest), twice, one set for the even
// key tiles and one for the odd, their states merged at the end; the
// Pallas kv-tile axis is a loop inside the block over rounds of two
// 64-key tiles (fewer keys for rows over 256 bytes) staged by cp.async in
// the inputs' dtype, double-buffered, and both products run on the tensor
// cores with the precision split of flash_tiles.cuh. The loop stops at
// the block's causal edge, so tiles wholly above the diagonal are never
// read, and a warp whose rows all precede a tile skips it. T and S need
// not be multiples of the tiles: rows and keys past the edges are
// zero-filled and masked in the kernel. The offset is read from device
// memory, so a traced start position costs no host sync.
//
// Head dim 320 (gemma3-4b's global layers) runs the wide block of
// flash_tiles.cuh (the two warp groups split the output columns over
// every key tile, one tile a round), built into its own library
// (FLASH_FIXED_HD=320, kernels/build.py: VARIANTS) in both instances.

#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T>
struct DenseRows {                 // k, v: (B, S, KV, hd)
  const T* k;
  const T* v;
  size_t base;                     // element offset of (b, key 0, kv head)
  int stride;                      // elements between consecutive keys
  __device__ const T* krow(int j) const {
    return k + base + static_cast<size_t>(j) * stride;
  }
  __device__ const T* vrow(int j) const {
    return v + base + static_cast<size_t>(j) * stride;
  }
};

template <bool kWindow>
struct CausalMask {                // absolute positions: key <= query,
  int q_first;                     // position of the warp's row 0
  int k0;                          // position of the tile's key 0
  int window;                      // kWindow: query - key < window if > 0
  __device__ bool operator()(int r, int j) const {
    const int d = q_first + r - (k0 + j);
    if constexpr (kWindow) return d >= 0 && (window <= 0 || d < window);
    return d >= 0;
  }
};

template <typename T, int HD, bool kModes>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ offset,
                     T* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ acc_out,
                     int n_q, int S, int H, int KV, int window, float scale,
                     float cap) {
  using L = Layout<T, HD>;
  constexpr int kTs = L::kTs;
  constexpr int kPer = L::kRoundTiles;  // tiles a round
  if constexpr (!kModes) window = 0;   // the plain instance: no window
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockRows * L::kStride;    // kStages x kPer K tiles
  T* vs = ks + kStages * kPer * kTs * L::kStride;   // and V tiles
  const int tid = threadIdx.x, warp = tid / 32;
  const int wq = warp % kWarps, kg = warp / kWarps;  // row group, key group
  const int q0 = blockIdx.x * kBlockRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = offset[0];
  stage_rows<T, HD>(qs, kBlockRows, n_q - q0, [&](int r) {
    return q + ((static_cast<size_t>(b) * n_q + q0 + r) * H + h) * HD;
  }, tid, kThreads);
  // The block's last real query sits at off + min(q0 + rows, n_q) - 1: key
  // tiles past it are masked for every row and would leave the state
  // bitwise unchanged. With a window, so are the tiles before t_first,
  // which holds the first key of the block's first row's window; the loop
  // runs over tiles t_first .. t_end - 1, u = t - t_first counting from 0.
  const int q_last = off + min(q0 + kBlockRows, n_q) - 1;
  const int t_end =
      q_last < 0 ? 0 : min((S + kTs - 1) / kTs, q_last / kTs + 1);
  const int t_first =
      window > 0 ? max(0, off + q0 - window + 1) / kTs : 0;
  const int n_tiles = max(0, t_end - t_first);
  const int n_rounds = (n_tiles + kPer - 1) / kPer;
  const DenseRows<T> rows{k, v,
                          (static_cast<size_t>(b) * S * KV + kvh) * HD,
                          KV * HD};
  // loop tile u of round r = u / kPer sits in buffer slot
  // (r % kStages) * kPer + u % kPer
  auto slot = [&](int u) {
    return ((u / kPer) % kStages * kPer + u % kPer) * kTs * L::kStride;
  };
  auto stage_round = [&](int r) {
    for (int u = r * kPer; u < min(n_tiles, (r + 1) * kPer); ++u) {
      const int k0 = (t_first + u) * kTs, n_keys = min(kTs, S - k0);
      stage_rows<T, HD>(ks + slot(u), kTs, n_keys,
                        [&](int j) { return rows.krow(k0 + j); }, tid,
                        kThreads);
      stage_rows<T, HD>(vs + slot(u), kTs, n_keys,
                        [&](int j) { return rows.vrow(k0 + j); }, tid,
                        kThreads);
    }
  };
  if (n_rounds > 0) stage_round(0);
  cp_async_commit();
  // the warp's rows: sequence rows r0 .. r0 + 15, positions off + r0 ..
  const int r0 = q0 + wq * kRows;
  const int w_last = off + min(r0 + kRows, n_q) - 1;
  // the first key of the warp's first row's window (0 without a window)
  const int w_first = window > 0 ? off + r0 - window + 1 : 0;
  const bool w_live = r0 < n_q;
  // the wide block: every warp reads the round's one tile, at its
  // column group's first column of V
  const int v_col = L::kWide ? kg * L::kCols : 0;
  State<L::kCols> st;
  st.init();
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) {
      stage_round(r + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int u = r * kPer + (L::kWide ? 0 : kg), k0 = (t_first + u) * kTs;
    if (u < n_tiles && w_live && k0 <= w_last && k0 + kTs > w_first)
      attend_tile<T, HD, false, kModes>(
          qs + wq * kRows * L::kStride, ks + slot(u), vs + slot(u) + v_col,
          min(kTs, S - k0), CausalMask<kModes>{off + r0, k0, window}, scale,
          cap, st);
    __syncthreads();
  }
  cp_async_wait<0>();
  if constexpr (!L::kWide)
    merge_key_groups<HD>(st, reinterpret_cast<float*>(ks));
  if ((L::kWide || kg == 0) && w_live)
    store_rows<T, HD>(st, b, h, r0, n_q, H, out, m_out, l_out, acc_out);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* offset,
           void* out, void* m_out, void* l_out, void* acc_out, int B,
           int n_q, int S, int H, int KV, int hd, int window, float cap,
           cudaStream_t stream) {
  return with_head_dim(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    constexpr size_t smem = Layout<T, HD>::kBytes;
    auto kern = window > 0 || cap != 0.f ? flash_prefill_kernel<T, HD, true>
                                         : flash_prefill_kernel<T, HD, false>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((n_q + kBlockRows - 1) / kBlockRows, H, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(offset),
        static_cast<T*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), static_cast<float*>(acc_out), n_q, S,
        H, KV, window, inv_sqrt_hd(HD), cap);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// q: (B, n_q, H, hd); k, v: (B, S, KV, hd), all fp32 (bf16 == 0) or bf16
// (bf16 == 1), contiguous; offset: (1,) int32, the position of query 0.
// emit_state == 0: out (B, n_q, H, hd) in the input dtype, m_out, l_out and
// acc_out unused; emit_state == 1: m_out, l_out (B, H, n_q) and acc_out
// (B, H, n_q, hd) fp32, out unused. H % KV == 0, hd a power of two from
// 8 to 256 or 224 (the wide library: 320; else cudaErrorInvalidValue),
// every tensor 16-byte aligned. window > 0: the sliding window (0: none); cap != 0: the softcap.
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* offset,
                                    void* out, void* m_out, void* l_out,
                                    void* acc_out, int B, int n_q, int S,
                                    int H, int KV, int hd, int window,
                                    int emit_state, int bf16, float cap,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emit_state) out = nullptr;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, offset, out, m_out, l_out, acc_out,
                                 B, n_q, S, H, KV, hd, window, cap, st);
  return launch<float>(q, k, v, offset, out, m_out, l_out, acc_out, B, n_q,
                       S, H, KV, hd, window, cap, st);
}
