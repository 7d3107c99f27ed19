// yuv420_post: the export post 'yuv420' of (B, 4, H, W) f16 frames in
// one pass: each pixel's R, G and B bits gathered to their gamma45 u8
// levels, the studio-range BT.601 matrix (Y 16-235, Cb/Cr 16-240), the
// 2x2 mean of Cb and Cr over an edge-replicate pad of odd sizes, and the
// packed (B, H*W + 2*ceil(H/2)*ceil(W/2)) u8 output: Y, then Cb, then Cr.
//
// Replaces no Pallas kernel: the JAX package left this function,
// canvas_tpu/ops/color.py `_yuv420_pack_studio_math` (line 628), to
// XLA, which fused it into one pass. The port's eager version
// (ops/color.py `yuv420_pack_studio_plain`) is some twenty PyTorch ops,
// each a pass over the whole batch, with int32 and int64 index tensors
// and f32 planes in between: 39.8 ms for a 128-frame 1080p batch on an
// H100, 67x what the bytes need.
//
// What bounds it on an H100: device-memory bytes. It reads the R, G and
// B f16 planes (6 B/px; alpha is never read) and writes Y and the 2x2
// Cb and Cr (1.5 B/px): 7.5 B/px, 1.99 GB and 0.594 ms at 3.35 TB/s for
// a 128-frame 1080p batch. Nothing intermediate reaches device memory.
//
// Design:
// - The level table: `_gamma45_floor` gives whole levels 0-255, so the
//   65,536 levels of the f16 bit patterns fit in 64 KB of u8. Each block
//   copies it into shared memory once and then walks a grid-stride loop
//   over the batch (a persistent grid: as many blocks as fit on the card
//   at once, so the copy is paid a few hundred times, not once per
//   patch). A gather from shared memory costs the same for any value;
//   one through L1 would miss to L2 wherever a warp's 96 levels spread
//   over the table. NaN, infinities, negatives and subnormals take their
//   entry like any other value, as in the eager version.
// - kVec: a thread owns a 2x8 patch: one 16-byte load per row per plane,
//   the Y bytes of both rows as one 8-byte store each, and the Cb and Cr
//   of its four 2x2 quads as one 4-byte store each. This needs W % 8 == 0
//   and 16-byte-aligned input and output (ops/cuda_ops.py `_vector_ok`);
//   a warp then reads and writes whole sectors. An odd H repeats the last
//   row into the last pair's second row, which is not stored.
// - Otherwise the scalar instantiation runs: a thread owns one 2x2 quad,
//   two-byte loads and one-byte stores, its second row and column the
//   last ones again where H or W is odd (the edge-replicate pad).
// Measured on an H100 (80GB HBM3, 700 W), 16-byte form: 0.677 ms for a
// 128-frame 1080p batch (1.14x its floor), 0.108 ms for 16 frames
// (1.46x, where fixed costs weigh more, among them the resident blocks'
// copies of the table), 0.175 ms for 8 frames at 4K (1.18x).
//
// Numerics, those of the eager ops on the card, each op rounded apart:
// a Python float constant is rounded to f32 (the products 224 * 0.5 /
// 0.886 and 224 * 0.5 / 0.701 folded in double first); a division by
// 255.0 is PyTorch's multiply by the f32 reciprocal 1.0f / 255.0f
// (BinaryDivTrueKernel.cu, for a CPU scalar divisor); every multiply and
// add is an explicitly rounded intrinsic (and the file is built with
// --fmad=false); the 2x2 mean is the sum of a quad's two column pairs,
// (top left + bottom left) + (top right + bottom right), times 0.25, the
// order in which PyTorch's reduce kernel adds the four values of
// `mean(dim=(2, 4))` on the card (found there: no other order of the
// four matched every quad of seeded 1080p frames, this one matched all);
// clamp, then round half to even. The bytes equal the eager version's on
// the card (tests/test_torch_gpu.py), which also checks the unrounded Y,
// Cb and Cr of all 256^3 level triples through `canvas_yuv420_levels`.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 65536;  // one u8 level per f16 bit pattern
constexpr int kMaxDevices = 64;

// The eager ops' constants: the Python floats rounded to f32.
constexpr float kR = (float)0.299;
constexpr float kG = (float)0.587;
constexpr float kB = (float)0.114;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kCb = (float)(224.0 * 0.5 / 0.886);
constexpr float kCr = (float)(224.0 * 0.5 / 0.701);

// The unrounded studio Y, Cb and Cr of one level triple, in the eager
// version's op order: Ey = (0.299 R + 0.587 G + 0.114 B) / 255,
// Y = 16 + 219 Ey, Cb = 128 + 112/0.886 (B/255 - Ey),
// Cr = 128 + 112/0.701 (R/255 - Ey).
__device__ __forceinline__ void studio(float r, float g, float b, float& y,
                                       float& cb, float& cr) {
  const float ey = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(kR, r), __fmul_rn(kG, g)),
                __fmul_rn(kB, b)),
      kInv255);
  y = __fadd_rn(__fmul_rn(219.f, ey), 16.f);
  cb = __fadd_rn(__fmul_rn(kCb, __fsub_rn(__fmul_rn(b, kInv255), ey)), 128.f);
  cr = __fadd_rn(__fmul_rn(kCr, __fsub_rn(__fmul_rn(r, kInv255), ey)), 128.f);
}

// clamp(v, 16, hi), then round half to even, as a byte.
__device__ __forceinline__ uint32_t quantize(float v, float hi) {
  return (uint32_t)__float2int_rn(fminf(fmaxf(v, 16.f), hi));
}

// The 2x2 mean of one quad, tl tr over bl br: each column's pair, then
// their sum, as PyTorch's reduce kernel adds them on the card.
__device__ __forceinline__ float mean4(float tl, float tr, float bl,
                                       float br) {
  return __fmul_rn(__fadd_rn(__fadd_rn(tl, bl), __fadd_rn(tr, br)), 0.25f);
}

// kC neighbouring f16 bit patterns of a row from column x0: one 16-byte
// load (kVec), or two loads, the second column clamped to the last.
template <bool kVec>
struct Row {
  static constexpr int kC = kVec ? 8 : 2;  // columns a thread owns
  uint32_t w[kC / 2];                      // two patterns a word

  __device__ __forceinline__ void load(const uint16_t* row, int x0, int W) {
    if constexpr (kVec) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + x0);
      w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
    } else {
      w[0] = (uint32_t)row[x0] | ((uint32_t)row[min(x0 + 1, W - 1)] << 16);
    }
  }

  __device__ __forceinline__ uint32_t bits(int c) const {
    return (w[c / 2] >> (16 * (c % 2))) & 0xffffu;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    yuv420_kernel(const uint16_t* __restrict__ x,
                  const uint8_t* __restrict__ table,
                  uint8_t* __restrict__ out, int H, int W, int per_row,
                  int items) {
  extern __shared__ __align__(16) uint8_t levels[];
  for (int i = threadIdx.x; i < kTable / 16; i += kThreads)
    reinterpret_cast<uint4*>(levels)[i] =
        __ldg(reinterpret_cast<const uint4*>(table) + i);
  __syncthreads();

  constexpr int kC = Row<kVec>::kC;
  const int Hc = (H + 1) / 2;
  const int Wc = (W + 1) / 2;
  const int64_t HW = (int64_t)H * W;
  const int64_t frame = HW + 2 * (int64_t)Hc * Wc;
  for (int item = blockIdx.x * kThreads + threadIdx.x; item < items;
       item += gridDim.x * kThreads) {
    const int r = item / per_row;  // a row pair of one frame
    const int x0 = (item - r * per_row) * kC;
    const int b = r / Hc;
    const int yc = r - b * Hc;
    const int y0 = 2 * yc;
    const bool second = y0 + 1 < H;  // else the pad repeats row y0
    const int y1 = second ? y0 + 1 : y0;
    const uint16_t* f = x + (int64_t)b * 4 * HW;
    Row<kVec> px[2][3];  // [row][R, G, B]
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      px[0][c].load(f + c * HW + (int64_t)y0 * W, x0, W);
      px[1][c].load(f + c * HW + (int64_t)y1 * W, x0, W);
    }
    uint32_t ybytes[2][(kC + 3) / 4] = {};  // kC Y bytes a row, packed
    uint32_t cbbytes = 0, crbytes = 0;    // kC / 2 bytes each
#pragma unroll
    for (int q = 0; q < kC / 2; ++q) {
      float cb[2][2], cr[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 2 * q + j;
          float y;
          studio((float)levels[px[i][0].bits(c)],
                 (float)levels[px[i][1].bits(c)],
                 (float)levels[px[i][2].bits(c)], y, cb[i][j], cr[i][j]);
          ybytes[i][c / 4] |= quantize(y, 235.f) << (8 * (c % 4));
        }
      }
      cbbytes |= quantize(mean4(cb[0][0], cb[0][1], cb[1][0], cb[1][1]),
                          240.f) << (8 * q);
      crbytes |= quantize(mean4(cr[0][0], cr[0][1], cr[1][0], cr[1][1]),
                          240.f) << (8 * q);
    }
    uint8_t* o = out + (int64_t)b * frame;
    uint8_t* ocb = o + HW + (int64_t)yc * Wc + x0 / 2;
    uint8_t* ocr = ocb + (int64_t)Hc * Wc;
    if constexpr (kVec) {
      *reinterpret_cast<uint2*>(o + (int64_t)y0 * W + x0) =
          make_uint2(ybytes[0][0], ybytes[0][1]);
      if (second)
        *reinterpret_cast<uint2*>(o + (int64_t)y1 * W + x0) =
            make_uint2(ybytes[1][0], ybytes[1][1]);
      *reinterpret_cast<uint32_t*>(ocb) = cbbytes;
      *reinterpret_cast<uint32_t*>(ocr) = crbytes;
    } else {
      const bool right = x0 + 1 < W;  // else the pad repeats column x0
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && !second) break;
        uint8_t* oy = o + (int64_t)(y0 + i) * W + x0;
        oy[0] = (uint8_t)ybytes[i][0];
        if (right) oy[1] = (uint8_t)(ybytes[i][0] >> 8);
      }
      *ocb = (uint8_t)cbbytes;
      *ocr = (uint8_t)crbytes;
    }
  }
}

// Blocks of one instantiation that fit on the device at once, found once
// a device (the occupancy calculator and the 64 KB shared-memory
// attribute are host calls; none runs while a stream captures, after the
// first launch on a device).
template <bool kVec>
int resident_blocks(int device, cudaError_t* err) {
  static std::atomic<int> cached[kMaxDevices];
  int n = device < kMaxDevices ? cached[device].load() : 0;
  if (n > 0) return n;
  *err = cudaFuncSetAttribute(yuv420_kernel<kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTable);
  if (*err != cudaSuccess) return 0;
  int sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, yuv420_kernel<kVec>, kThreads, kTable);
  if (*err != cudaSuccess) return 0;
  n = sms * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cached[device].store(n);
  return n;
}

template <bool kVec>
int launch(const void* x, const void* table, void* out, int B, int H, int W,
           int device, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks<kVec>(device, &err);
  if (err != cudaSuccess) return (int)err;
  const int per_row = kVec ? W / 8 : (W + 1) / 2;
  // B * ceil(H/2) * per_row < 2^30, checked by the wrapper
  const int items = B * ((H + 1) / 2) * per_row;
  const int blocks = std::min((items + kThreads - 1) / kThreads, resident);
  yuv420_kernel<kVec><<<blocks, kThreads, kTable, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(table),
      static_cast<uint8_t*>(out), H, W, per_row, items);
  return (int)cudaGetLastError();
}

// Every level triple: R = i >> 16, G = (i >> 8) & 255, B = i & 255.
__global__ void __launch_bounds__(kThreads)
    levels_kernel(float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float y, cb, cr;
  studio((float)(i >> 16), (float)((i >> 8) & 255), (float)(i & 255), y, cb,
         cr);
  out[i] = y;
  out[(1 << 24) + i] = cb;
  out[(2 << 24) + i] = cr;
}

}  // namespace

extern "C" {

// Returns a CUDA error code (0 = launched). x: (B, 4, H, W) f16; table:
// the 65,536 u8 levels of the f16 bit patterns; out: (B, H*W +
// 2*ceil(H/2)*ceil(W/2)) u8. vec = 1 launches the 16-byte form: W % 8 ==
// 0 and x and out at multiples of 16 bytes.
int canvas_yuv420_post(const void* x, const void* table, void* out, int B,
                       int H, int W, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (vec && W % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(x, table, out, B, H, W, device, s)
             : launch<false>(x, table, out, B, H, W, device, s);
}

// The unrounded Y, Cb and Cr of every level triple, by the kernel's own
// arithmetic: out is (3, 256^3) f32, triple i = (R, G, B) as above.
int canvas_yuv420_levels(void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  levels_kernel<<<(1 << 24) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
