// Row accesses of the render kernels (solid_fold.cu, region_over_sep.cu,
// region_over.cu):
// kC neighbouring values of one row of a plane, widened to f32 on load
// and narrowed on store.
//
// kC = 8 and kC = 4 are the vector forms: 8 bf16 or f16 values, or 4 f32
// values, move in one 16-byte access (4 two-byte values in one of 8
// bytes), so a warp's access covers whole 32-byte sectors of a row. (Two
// 16-byte accesses a thread for 8 f32 values were tried on an H100 and
// lost: each access of a warp wrote half of every sector, and
// solid_fold's f32 mid fold ran slower than with one 4-byte access a
// thread.) The vector forms need the
// address to be a multiple of 16 bytes, which the wrappers
// (ops/cuda_ops.py `_vector_ok`) grant from the row length and the
// tensors' pointers. kC = 1 is the scalar form, for everything else.
//
// Numerics: a bf16 widens exactly (its bits are the high half of the
// f32). Each narrowed value is rounded on its own with
// __float2bfloat16_rn / __float2half_rn, round to nearest even as
// `.to(torch.bfloat16)` and `.half()`, and the pair is then packed, so the
// vector and the scalar form store the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cols {

// kC / 2 32-bit words, each two 2-byte values, in one access.
template <int kC>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  static_assert(kC == 8 || kC == 4, "a thread owns 8, 4 or 1 columns");
  if constexpr (kC == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    w[0] = q.x, w[1] = q.y;
  }
}

template <int kC>
__device__ __forceinline__ void store_words(void* p, const uint32_t* w) {
  static_assert(kC == 8 || kC == 4, "a thread owns 8, 4 or 1 columns");
  if constexpr (kC == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

template <int kC>
__device__ __forceinline__ void load(const float* p, float (&v)[kC]) {
  if constexpr (kC == 1) {
    v[0] = *p;
  } else {
    // kC = 8: the f32 weights of 8 bf16 columns, two accesses.
    static_assert(kC % 4 == 0, "a thread owns 8, 4 or 1 columns");
#pragma unroll
    for (int i = 0; i < kC / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
}

template <int kC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[kC]) {
  if constexpr (kC == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    uint32_t w[kC / 2];
    load_words<kC>(p, w);
#pragma unroll
    for (int i = 0; i < kC / 2; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <int kC>
__device__ __forceinline__ void store(float* p, const float (&v)[kC]) {
  if constexpr (kC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(kC == 1, "a thread owns 4 f32 columns or 1");
    *p = v[0];
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack(__half lo, __half hi) {
  return (uint32_t)__half_as_ushort(lo) |
         ((uint32_t)__half_as_ushort(hi) << 16);
}

template <int kC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[kC]) {
  if constexpr (kC == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    uint32_t w[kC / 2];
#pragma unroll
    for (int i = 0; i < kC / 2; ++i)
      w[i] = pack(__float2bfloat16_rn(v[2 * i]),
                  __float2bfloat16_rn(v[2 * i + 1]));
    store_words<kC>(p, w);
  }
}

template <int kC>
__device__ __forceinline__ void store(__half* p, const float (&v)[kC]) {
  if constexpr (kC == 1) {
    *p = __float2half_rn(v[0]);
  } else {
    uint32_t w[kC / 2];
#pragma unroll
    for (int i = 0; i < kC / 2; ++i)
      w[i] = pack(__float2half_rn(v[2 * i]), __float2half_rn(v[2 * i + 1]));
    store_words<kC>(p, w);
  }
}

}  // namespace cols
