// region_over: composite a materialised region layer (B, 4, h, w) over
// the premultiplied accumulators (P, A), in place, at a region offset
// (dy0, dx0), clipping what overhangs the frame's bottom and right edges.
//
// Replaces the Pallas TPU kernel canvas_tpu/ops/pallas_ops.py
// `region_over` (lines 276-372; its aliased in/out accumulators,
// `input_output_aliases`, become an in-place update here, and its
// scalar-prefetched block offsets become host ints).
//
// What bounds it on an H100: device-memory bytes. Each region pixel
// reads the layer (4 channels), reads and writes P (3 channels) and A:
// 48 B/px in f32, about 31 MB per 1080p frame for a 640x1024 region, and
// 24 B/px with the quality <= 9 tier's bf16 layer and accumulators.
// There is no reuse, so the kernel streams each byte once.
//
// Design: one thread per region pixel (b, y, x) inside the frame, x
// fastest, so a warp reads and writes 32 neighbouring pixels of one row
// of each channel plane. The iteration space is the region clipped to
// the frame (rows past H and columns past W are never visited: that is
// the edge clipping the TPU kernel does on store); everything outside
// the region is untouched. T is the stored type of the layer and the
// accumulators (float, or __nv_bfloat16 for the quality <= 9 tier,
// pallas_ops.py:334-343): the blend math is f32 either way, a bf16
// store rounds to nearest even.
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
                                   int h, int w, int hc, int wc, int H,
                                   int W, int dy0, int dx0) {
  const int b = blockIdx.y;
  const int64_t hw = (int64_t)h * w;
  const int64_t HW = (int64_t)H * W;
  const int64_t n_px = (int64_t)hc * wc;
  const T* l = layer + (int64_t)b * 4 * hw;
  T* pb = P + (int64_t)b * 3 * HW;
  T* ab = A + (int64_t)b * HW;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < n_px;
       n += stride) {
    const int y = (int)(n / wc);
    const int x = (int)(n - (int64_t)y * wc);
    const int64_t i = (int64_t)y * w + x;
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

// Returns cudaGetLastError() after the launch (0 = launched, or
// nothing of the region lies inside the frame). bf16 = 1: the layer, P
// and A are bf16, else f32.
int canvas_region_over(const void* layer, void* P, void* A, int B, int h,
                       int w, int H, int W, int dy0, int dx0, int bf16,
                       int blocks_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int hc = h < H - dy0 ? h : H - dy0;
  const int wc = w < W - dx0 ? w : W - dx0;
  if (B <= 0 || hc <= 0 || wc <= 0) return 0;
  const dim3 grid(blocks_x, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    region_over_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(layer),
        static_cast<__nv_bfloat16*>(P), static_cast<__nv_bfloat16*>(A), h,
        w, hc, wc, H, W, dy0, dx0);
  else
    region_over_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(layer), static_cast<float*>(P),
        static_cast<float*>(A), h, w, hc, wc, H, W, dy0, dx0);
  return (int)cudaGetLastError();
}

}  // extern "C"
