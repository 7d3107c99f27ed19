// fma_chain: k chained fused multiply-adds per element,
// acc = x; acc = acc*c[i] + x for i < k; out = acc.
//
// Replaces the Pallas TPU kernel scripts/vpu_roofline.py `pallas_fma` /
// `fma_kernel_factory` (lines 91-117; pallas_call 104), the roofline
// probe's FMA chain. The TPU grid there was H // 256 x W // 512 (floor)
// and left the ragged rows and columns of a 1088x1920 plane unwritten;
// this kernel covers every element.
//
// What bounds it on an H100: 8 B/element of device-memory traffic for
// small k, and the FP32 pipe (one FFMA per element per step) for large
// k. The probe exists to measure both, so the kernel keeps everything
// else off the critical path: each thread owns 4 neighbouring elements
// (one 16-byte load and store, 4 independent chains), the k constants
// sit in shared memory and are read 4 at a time (one LDS.128 per 16
// FFMAs), and each step is an explicit __fmaf_rn: the build's
// --fmad=false stops nvcc from fusing a*b + c, so without it a step
// would be an FMUL and an FADD.
//
// Numerics: one rounding per step. The plain version
// (study_ops.fma_chain_plain) multiplies and adds with two roundings, so
// the two agree within a bound that study_ops states, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 fma4(float4 a, float c, float4 x) {
  return make_float4(__fmaf_rn(a.x, c, x.x), __fmaf_rn(a.y, c, x.y),
                     __fmaf_rn(a.z, c, x.z), __fmaf_rn(a.w, c, x.w));
}

__global__ void __launch_bounds__(256)
    fma_chain_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     float* __restrict__ out, int64_t n, int k) {
  extern __shared__ float4 cs4[];  // the k constants, padded to a multiple of 4
  float* cs = reinterpret_cast<float*>(cs4);
  const int k4 = (k + 3) & ~3;
  for (int i = threadIdx.x; i < k4; i += blockDim.x) cs[i] = i < k ? c[i] : 0.f;
  __syncthreads();

  const int64_t n4 = n / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 xv = x4[i];
    float4 acc = xv;
    int s = 0;
    for (; s + 4 <= k; s += 4) {
      const float4 cv = cs4[s / 4];
      acc = fma4(acc, cv.x, xv);
      acc = fma4(acc, cv.y, xv);
      acc = fma4(acc, cv.z, xv);
      acc = fma4(acc, cv.w, xv);
    }
    for (; s < k; ++s) acc = fma4(acc, cs[s], xv);
    o4[i] = acc;
  }
  // The last n % 4 elements, one thread each.
  const int64_t tail = n4 * 4 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tail < n) {
    const float xv = x[tail];
    float acc = xv;
    for (int s = 0; s < k; ++s) acc = __fmaf_rn(acc, cs[s], xv);
    out[tail] = acc;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). x and out
// hold n f32 elements, 16-byte aligned; c holds k f32 constants.
int canvas_fma_chain(const void* x, const void* c, void* out, long long n,
                     int k, int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)(((k + 3) & ~3) + 4);
  fma_chain_kernel<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<float*>(out), (int64_t)n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
