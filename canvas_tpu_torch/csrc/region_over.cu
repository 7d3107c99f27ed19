// region_over: composite a materialised region layer (B, 4, h, w) over
// the premultiplied accumulators (P, A), in place, at a region offset
// (dy0, dx0), clipping what overhangs the frame's bottom and right edges.
//
// Replaces the Pallas TPU kernel canvas_tpu/ops/pallas_ops.py
// `region_over` (lines 276-372; its aliased in/out accumulators,
// `input_output_aliases`, become an in-place update here). Its
// scalar-prefetched block offsets stay device data: the kernel reads
// (dy0, dx0) from two int32 values in device memory, so one captured
// launch (a CUDA graph of the render program) serves every position of
// an animated region, as one compiled TPU program does.
//
// What bounds it on an H100: device-memory bytes. Each region pixel
// reads the layer (4 channels), reads and writes P (3 channels) and A:
// 48 B/px in f32, about 31 MB per 1080p frame for a 640x1024 region, and
// 24 B/px with the quality <= 9 tier's bf16 layer and accumulators.
// There is no reuse, so the kernel streams each byte once.
//
// Design: one thread per region pixel (b, y, x), x fastest, so a warp
// reads and writes 32 neighbouring pixels of one row of each channel
// plane. The grid covers the whole region: the host does not know the
// offsets. Each block reads them once and its threads skip the pixels
// past row H or column W (that is the edge clipping the TPU kernel does
// on store); everything outside the region is untouched. The offsets
// are block-aligned and inside the frame's (64, 128) envelope (checked
// on the host before upload), so a region always meets the frame. T is
// the stored type of the layer and the accumulators (float, or
// __nv_bfloat16 for the quality <= 9 tier, pallas_ops.py:334-343): the
// blend math is f32 either way, a bf16 store rounds to nearest even.
//
// Numerics: explicitly rounded intrinsics, built with --fmad=false, in
// the op order of the plain version (cuda_ops.region_over_plain):
// P = l_c*la + P*(1-la), A = la + A*(1-la). The two are bit-identical in
// both storage types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void region_over_kernel(const T* __restrict__ layer,
                                   T* __restrict__ P, T* __restrict__ A,
                                   const int* __restrict__ dy0p,
                                   const int* __restrict__ dx0p, int h,
                                   int w, int H, int W) {
  const int b = blockIdx.y;
  const int dy0 = *dy0p;
  const int dx0 = *dx0p;
  const int64_t hw = (int64_t)h * w;
  const int64_t HW = (int64_t)H * W;
  const T* l = layer + (int64_t)b * 4 * hw;
  T* pb = P + (int64_t)b * 3 * HW;
  T* ab = A + (int64_t)b * HW;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += stride) {
    const int y = (int)(i / w);
    const int x = (int)(i - (int64_t)y * w);
    if (dy0 + y >= H || dx0 + x >= W) continue;
    const int64_t o = (int64_t)(dy0 + y) * W + (dx0 + x);
    const float la = to_f32(l[3 * hw + i]);
    const float keep = __fsub_rn(1.f, la);
    T* p = pb + o;
    store(&p[0], __fadd_rn(__fmul_rn(to_f32(l[i]), la),
                           __fmul_rn(to_f32(p[0]), keep)));
    store(&p[HW], __fadd_rn(__fmul_rn(to_f32(l[hw + i]), la),
                            __fmul_rn(to_f32(p[HW]), keep)));
    store(&p[2 * HW], __fadd_rn(__fmul_rn(to_f32(l[2 * hw + i]), la),
                                __fmul_rn(to_f32(p[2 * HW]), keep)));
    store(&ab[o], __fadd_rn(la, __fmul_rn(to_f32(ab[o]), keep)));
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). bf16 = 1:
// the layer, P and A are bf16, else f32. dy0 and dx0 point to one int32
// each in device memory.
int canvas_region_over(const void* layer, void* P, void* A, const void* dy0,
                       const void* dx0, int B, int h, int w, int H, int W,
                       int bf16, int blocks_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || h <= 0 || w <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid(blocks_x, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* oy = static_cast<const int*>(dy0);
  const int* ox = static_cast<const int*>(dx0);
  if (bf16)
    region_over_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(layer),
        static_cast<__nv_bfloat16*>(P), static_cast<__nv_bfloat16*>(A), oy,
        ox, h, w, H, W);
  else
    region_over_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(layer), static_cast<float*>(P),
        static_cast<float*>(A), oy, ox, h, w, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
