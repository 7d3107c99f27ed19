// solid_fold: premultiplied "over" fold of L solid(+gain/offset) box
// layers, bottom to top, over an empty base or a base (P, A).
//
// Replaces the Pallas TPU kernel canvas_tpu/ops/pallas_ops.py
// `_kernel_factory` (lines 107-170, called from `solid_fold`, 179).
//
// What bounds it on an H100: device-memory bytes. Per pixel the work is
// a handful of compares, selects and multiply-adds per layer, while the
// stores are 16 B/px (mid fold: f32 P and A), 8 B/px (mid fold in bf16,
// or finalize in f16) plus 16 B/px of f32 or 8 B/px of bf16 base reads.
// At 1080p the f32 mid fold writes 33.2 MB per frame and the f16
// finalize from an f32 base moves 49.8 MB, against 3.35 TB/s.
//
// Design: one block covers a strip of pixels of one frame b (grid.y).
// It first loads that frame's L layer scalars (color, box, gain,
// offset: L*40 bytes) into shared memory and computes there, in f32,
// the premultiplied layer color pa[c] = (color[c]*g + o)*a in that
// order. Each thread then walks the layers for its pixels with the
// per-pixel math of pallas_ops.py:143-157, reading the base once and
// writing the output once; neighbouring threads touch neighbouring
// pixels, so every load and store is coalesced. No layer tensor and no
// intermediate ever reaches device memory.
//
// Storage types: the quality <= 9 tier keeps the pass-boundary (P, A)
// accumulators in bf16 (pallas_ops.py:135-138, 166-168, 256-257): the
// base may be read as bf16 (BaseT) and the mid fold may store bf16
// (kMode 3). The math is f32 in every form; a bf16 base is widened on
// load and a bf16 store rounds to nearest even (__float2bfloat16_rn).
//
// Numerics: every multiply, add and divide is an explicitly rounded
// intrinsic (and the file is built with --fmad=false), so no chain is
// contracted into an FMA and the result is bit-identical to the plain
// PyTorch fold (`_fold_torch`), which rounds after every operation.
// The finalize writes f16 with __float2half_rn and the bf16 mid fold
// with __float2bfloat16_rn, the same round-to-nearest-even as the plain
// path's f32 math followed by `.half()` / `.to(torch.bfloat16)`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Layer {
  int y0, y1, x0, x1;  // inclusive box, relative to the frame; y1 < y0 = empty
  float a;             // layer alpha
  float p[3];          // premultiplied color (c*g + o)*a
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// kMode: 0 = store the (P, A) accumulators as f32,
//        1 = finalize to (B, 4, H, W) f32, 2 = finalize to f16,
//        3 = store the (P, A) accumulators as bf16.
// BaseT: the stored type of the base (P, A), float or __nv_bfloat16.
// AccOf<kMode>: the type of the stored A (f32 but for kMode 3; unused by
// a finalize), so the f32 forms compile exactly as they did before the
// bf16 forms were added.
template <int kMode>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<3> {
  using type = __nv_bfloat16;
};

template <bool kBase, typename BaseT, int kMode>
__global__ void solid_fold_kernel(const float* __restrict__ color,
                                  const int* __restrict__ box,
                                  const float* __restrict__ gain,
                                  const float* __restrict__ offset,
                                  const BaseT* __restrict__ baseP,
                                  const BaseT* __restrict__ baseA,
                                  void* __restrict__ out0,
                                  typename AccOf<kMode>::type* __restrict__ outA,
                                  int L, int B, int H, int W) {
  extern __shared__ Layer layers[];
  const int b = blockIdx.y;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int64_t lb = (int64_t)l * B + b;
    const float* c = color + lb * 4;
    const int* bx = box + lb * 4;
    const float g = gain[lb];
    const float o = offset[lb];
    Layer ly;
    ly.y0 = bx[0];
    ly.y1 = bx[1];
    ly.x0 = bx[2];
    ly.x1 = bx[3];
    ly.a = c[3];
    for (int k = 0; k < 3; ++k)
      ly.p[k] = __fmul_rn(__fadd_rn(__fmul_rn(c[k], g), o), c[3]);
    layers[l] = ly;
  }
  __syncthreads();

  const int64_t HW = (int64_t)H * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t px = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; px < HW;
       px += stride) {
    const int row = (int)(px / W);
    const int col = (int)(px - (int64_t)row * W);
    float P0 = 0.f, P1 = 0.f, P2 = 0.f, A = 0.f;
    if (kBase) {
      const BaseT* bp = baseP + (int64_t)b * 3 * HW + px;
      P0 = to_f32(bp[0]);
      P1 = to_f32(bp[HW]);
      P2 = to_f32(bp[2 * HW]);
      A = to_f32(baseA[(int64_t)b * HW + px]);
    }
    for (int l = 0; l < L; ++l) {
      const Layer& ly = layers[l];
      const bool m = (row >= ly.y0) & (row <= ly.y1) & (col >= ly.x0) &
                     (col <= ly.x1);
      const float a = m ? ly.a : 0.f;
      const float keep = __fsub_rn(1.f, a);
      P0 = __fadd_rn(m ? ly.p[0] : 0.f, __fmul_rn(P0, keep));
      P1 = __fadd_rn(m ? ly.p[1] : 0.f, __fmul_rn(P1, keep));
      P2 = __fadd_rn(m ? ly.p[2] : 0.f, __fmul_rn(P2, keep));
      A = __fadd_rn(a, __fmul_rn(A, keep));
    }
    if constexpr (kMode == 3) {
      __nv_bfloat16* op =
          static_cast<__nv_bfloat16*>(out0) + (int64_t)b * 3 * HW + px;
      op[0] = __float2bfloat16_rn(P0);
      op[HW] = __float2bfloat16_rn(P1);
      op[2 * HW] = __float2bfloat16_rn(P2);
      outA[(int64_t)b * HW + px] = __float2bfloat16_rn(A);
    } else if (kMode == 0) {
      float* op = static_cast<float*>(out0) + (int64_t)b * 3 * HW + px;
      op[0] = P0;
      op[HW] = P1;
      op[2 * HW] = P2;
      outA[(int64_t)b * HW + px] = A;
    } else {
      const bool nz = A != 0.f;
      const float safe = nz ? A : 1.f;
      const float r = nz ? __fdiv_rn(P0, safe) : 0.f;
      const float g = nz ? __fdiv_rn(P1, safe) : 0.f;
      const float bl = nz ? __fdiv_rn(P2, safe) : 0.f;
      const int64_t o = (int64_t)b * 4 * HW + px;
      if (kMode == 1) {
        float* op = static_cast<float*>(out0) + o;
        op[0] = r;
        op[HW] = g;
        op[2 * HW] = bl;
        op[3 * HW] = A;
      } else {
        __half* op = static_cast<__half*>(out0) + o;
        op[0] = __float2half_rn(r);
        op[HW] = __float2half_rn(g);
        op[2 * HW] = __float2half_rn(bl);
        op[3 * HW] = __float2half_rn(A);
      }
    }
  }
}

template <bool kBase, typename BaseT>
void launch(int mode, dim3 grid, dim3 block, size_t smem,
            cudaStream_t stream, const float* color, const int* box,
            const float* gain, const float* offset, const void* baseP,
            const void* baseA, void* out0, void* outA, int L, int B, int H,
            int W) {
  const BaseT* bp = static_cast<const BaseT*>(baseP);
  const BaseT* ba = static_cast<const BaseT*>(baseA);
  float* oa = static_cast<float*>(outA);
  if (mode == 0)
    solid_fold_kernel<kBase, BaseT, 0><<<grid, block, smem, stream>>>(
        color, box, gain, offset, bp, ba, out0, oa, L, B, H, W);
  else if (mode == 1)
    solid_fold_kernel<kBase, BaseT, 1><<<grid, block, smem, stream>>>(
        color, box, gain, offset, bp, ba, out0, oa, L, B, H, W);
  else if (mode == 2)
    solid_fold_kernel<kBase, BaseT, 2><<<grid, block, smem, stream>>>(
        color, box, gain, offset, bp, ba, out0, oa, L, B, H, W);
  else
    solid_fold_kernel<kBase, BaseT, 3><<<grid, block, smem, stream>>>(
        color, box, gain, offset, bp, ba, out0,
        static_cast<__nv_bfloat16*>(outA), L, B, H, W);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// baseP/baseA may be null (empty base); base_bf16 = 1 reads them as
// bf16, 0 as f32. mode as kMode above.
int canvas_solid_fold(const void* color, const void* box, const void* gain,
                      const void* offset, const void* baseP,
                      const void* baseA, void* out0, void* outA, int L,
                      int B, int H, int W, int mode, int base_bf16,
                      int blocks_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_x, B);
  const dim3 block(256);
  const size_t smem = sizeof(Layer) * (size_t)(L > 0 ? L : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const int* bx = static_cast<const int*>(box);
  const float* g = static_cast<const float*>(gain);
  const float* o = static_cast<const float*>(offset);
  if (baseP == nullptr)
    launch<false, float>(mode, grid, block, smem, s, c, bx, g, o, baseP,
                         baseA, out0, outA, L, B, H, W);
  else if (base_bf16)
    launch<true, __nv_bfloat16>(mode, grid, block, smem, s, c, bx, g, o,
                                baseP, baseA, out0, outA, L, B, H, W);
  else
    launch<true, float>(mode, grid, block, smem, s, c, bx, g, o, baseP,
                        baseA, out0, outA, L, B, H, W);
  return (int)cudaGetLastError();
}

const char* canvas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
