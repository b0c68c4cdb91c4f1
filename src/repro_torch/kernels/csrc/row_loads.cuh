// Loads of a piece of a K or V row as raw 32-bit words, and its elements
// as fp32: the row loads of the pipeline's QK and AV bodies (chai_qk.cu,
// chai_av.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chai {

// W bytes of a row as 32-bit words (the low 16 bits for W == 2).
template <int W>
struct Raw {
  static constexpr int kWords = W >= 4 ? W / 4 : 1;
  __device__ static void load(const void* p, unsigned* w) {
    if constexpr (W == 16) {
      const uint4 x = __ldg(static_cast<const uint4*>(p));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (W == 8) {
      const uint2 x = __ldg(static_cast<const uint2*>(p));
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (W == 4) {
      w[0] = __ldg(static_cast<const unsigned*>(p));
    } else {
      w[0] = __ldg(static_cast<const unsigned short*>(p));
    }
  }
};

// Element e of the words as fp32: exact for every element type (bf16 is
// the high half of an fp32; an int8 code is its value).
template <typename T>
__device__ __forceinline__ float elem(const unsigned* w, int e);
template <>
__device__ __forceinline__ float elem<float>(const unsigned* w, int e) {
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const unsigned* w,
                                                    int e) {
  const unsigned x = w[e / 2];
  return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
}
template <>
__device__ __forceinline__ float elem<int8_t>(const unsigned* w, int e) {
  return static_cast<float>(static_cast<int>(w[e / 4] << (24 - 8 * (e % 4)))
                            >> 24);
}

}  // namespace chai
