// region_over_sep: composite a rank-1 region layer
// value[c, y, x] = color[c] * ry[y] * rx[x] (a factored, resampled solid)
// over the premultiplied accumulators (P, A), in place, at a region
// offset (dy0, dx0), clipping what overhangs the frame's bottom and
// right edges.
//
// Replaces the Pallas TPU kernel canvas_tpu/ops/pallas_ops.py
// `region_over_sep` (lines 375-454; its aliased in/out accumulators,
// `input_output_aliases`, become an in-place update here).
//
// What bounds it on an H100: device-memory bytes. Each region pixel
// reads and writes P (3 channels) and A: 32 B/px with f32 accumulators,
// 16 B/px with the quality <= 9 tier's bf16 ones (about 16.8 or 8.4 MB
// per 1080p frame for a 512x1024 region). The layer itself is never
// materialised: per frame the kernel reads only h + w weights and four
// color scalars (all served from L1/L2).
//
// Design: one thread per region pixel (b, y, x), x fastest, so a warp
// reads and writes 32 neighbouring pixels of one row of each channel
// plane. The thread rebuilds the layer value of its pixel,
// l[c] = (color[b,c]*ry[b,y])*rx[b,x], and applies the over step of
// pallas_ops.py:416-424, P = l[c]*la + P*(1-la) and A = la + A*(1-la)
// with la = l[3]. Pixels past H or W are skipped: that is the edge
// clipping the TPU kernel does on store. Everything outside the region
// is untouched. AccT is the accumulators' stored type (float, or
// __nv_bfloat16 for the quality <= 9 tier, pallas_ops.py:421-424): the
// math is f32 either way, a bf16 store rounds to nearest even.
//
// Numerics: explicitly rounded intrinsics and --fmad=false, in the op
// order of the plain version (cuda_ops.region_over_sep_plain, which
// materialises (color*ry)*rx as the JAX fallback does,
// pallas_ops.py:396-398): the two are bit-identical in both storage
// types.

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

template <typename AccT>
__global__ void region_over_sep_kernel(const float* __restrict__ color,
                                       const float* __restrict__ ry,
                                       const float* __restrict__ rx,
                                       AccT* __restrict__ P,
                                       AccT* __restrict__ A, int h, int w,
                                       int H, int W, int dy0, int dx0) {
  const int b = blockIdx.y;
  const int64_t hw = (int64_t)h * w;
  const int64_t HW = (int64_t)H * W;
  const float c0 = color[b * 4 + 0];
  const float c1 = color[b * 4 + 1];
  const float c2 = color[b * 4 + 2];
  const float c3 = color[b * 4 + 3];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += stride) {
    const int y = (int)(i / w);
    const int x = (int)(i - (int64_t)y * w);
    const int gy = dy0 + y;
    const int gx = dx0 + x;
    if (gy >= H || gx >= W) continue;
    const float wy = ry[(int64_t)b * h + y];
    const float wx = rx[(int64_t)b * w + x];
    const float la = __fmul_rn(__fmul_rn(c3, wy), wx);
    const float keep = __fsub_rn(1.f, la);
    const int64_t o = (int64_t)gy * W + gx;
    AccT* p = P + (int64_t)b * 3 * HW + o;
    store(&p[0], __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(c0, wy), wx), la),
                           __fmul_rn(to_f32(p[0]), keep)));
    store(&p[HW], __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(c1, wy), wx), la),
                            __fmul_rn(to_f32(p[HW]), keep)));
    store(&p[2 * HW],
          __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(c2, wy), wx), la),
                    __fmul_rn(to_f32(p[2 * HW]), keep)));
    AccT* a = A + (int64_t)b * HW + o;
    store(&a[0], __fadd_rn(la, __fmul_rn(to_f32(a[0]), keep)));
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). bf16 = 1:
// P and A are bf16, else f32.
int canvas_region_over_sep(const void* color, const void* ry, const void* rx,
                           void* P, void* A, int B, int h, int w, int H,
                           int W, int dy0, int dx0, int bf16, int blocks_x,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks_x, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const float* y = static_cast<const float*>(ry);
  const float* x = static_cast<const float*>(rx);
  if (bf16)
    region_over_sep_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        c, y, x, static_cast<__nv_bfloat16*>(P),
        static_cast<__nv_bfloat16*>(A), h, w, H, W, dy0, dx0);
  else
    region_over_sep_kernel<float><<<grid, 256, 0, s>>>(
        c, y, x, static_cast<float*>(P), static_cast<float*>(A), h, w, H, W,
        dy0, dx0);
  return (int)cudaGetLastError();
}

}  // extern "C"
