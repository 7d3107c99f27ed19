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
// There is no reuse, so the kernel streams each byte once. A first
// version gave each thread one pixel of a 1-D index (a 64-bit division
// and remainder, a clip test and four 2- or 4-byte read-modify-writes
// per pixel) and was held back by its instructions: 1.21x its byte floor
// in f32 and 1.96x in bf16, which halved the bytes and not the time
// (0.5861 and 0.4748 ms at config7's three DV regions, B=16, on an H100
// at 700 W; this design 0.55 and 0.28 ms, 1.14-1.15x and 1.17-1.19x).
//
// Design, that of region_over_sep.cu: the region is whole (64, 128)
// blocks at (64, 128)-aligned offsets (the planner's invariant, checked
// by the wrapper), so a block of 256 threads owns a 128-column tile of it
// (blockIdx.x, blockIdx.y; the frame in blockIdx.z) and nothing is
// divided.
// - kVec: a thread owns one row of 8 (bf16) or 4 (f32) neighbouring
//   columns, one 16-byte access per plane (cols.cuh): it loads the four
//   layer planes and the four accumulator planes, then blends and stores
//   P = l_c*la + P*(1-la), A = la + A*(1-la). The layer is contiguous
//   (B, 4, h, w) with w % 128 == 0, so its rows start at a multiple of 16
//   bytes whenever its pointer does. This needs W % 8 == 0 and
//   16-byte-aligned pointers; as dx0 % 128 == 0, each vector then lies
//   wholly inside or outside the frame, and one test a vector clips the
//   right edge. Tiles are 16x128 (bf16) or 8x128 (f32).
// - Otherwise the scalar instantiation runs: one pixel per thread over
//   2x128 tiles, the same arithmetic.
// The grid is the region's whole tiles, (w / 128, h / tile rows, B),
// since the host does not know the offsets: each block reads them once,
// returns at once when its tile lies wholly past H or W, and each thread
// skips its row when it lies past H (that is the edge clipping the TPU
// kernel does on store); everything outside the region is untouched.
// The offsets are checked on the host before upload (block-aligned,
// inside the frame's (64, 128) envelope). Each pixel is read and written
// by one thread only. T is the stored type of the layer and the
// accumulators (float, or __nv_bfloat16 for the quality <= 9 tier,
// pallas_ops.py:334-343): the blend math is f32 either way, a bf16 store
// rounds to nearest even.
//
// Measured against this tile on the card, at config7's three regions
// and B=16: two and four rows a thread (5,120, 2,560 and 1,280 bf16
// blocks for a 640x1024 region) came within 1.4% of one row, which was
// the fastest in both types; a streaming hint on the read-once layer
// (ld.global.cs) lost 1.7-3.1% in every shape. TMA, wgmma and shared
// memory bring nothing to a one-pass stream with no reuse.
//
// Numerics: explicitly rounded intrinsics, built with --fmad=false, in
// the op order of the plain version (cuda_ops.region_over_plain):
// P = l_c*la + P*(1-la), A = la + A*(1-la). The two are bit-identical in
// both storage types and both instantiations.

#include "cols.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;  // columns of a tile

// The tile of a block: 16x128 with 8 columns a thread (bf16, vector),
// 8x128 with 4 (f32, vector), 2x128 with one (scalar).
template <typename T, bool kVec>
struct Geometry {
  // Columns a thread owns: one 16-byte access in the vector form.
  static constexpr int kC = kVec ? 16 / (int)sizeof(T) : 1;
  static constexpr int kTX = kTileW / kC;        // threads along a row
  static constexpr int kTileH = kThreads / kTX;  // rows of a tile
  static_assert(64 % kTileH == 0, "a tile lies in one row of 64x128 blocks");
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    region_over_kernel(const T* __restrict__ layer, T* __restrict__ P,
                       T* __restrict__ A, const int* __restrict__ dy0p,
                       const int* __restrict__ dx0p, int h, int w, int H,
                       int W) {
  using G = Geometry<T, kVec>;
  constexpr int kC = G::kC;
  const int b = blockIdx.z;
  const int dy0 = *dy0p;
  const int dx0 = *dx0p;
  const int tile_x = (int)blockIdx.x * kTileW;
  const int tile_y = (int)blockIdx.y * G::kTileH;
  if (dx0 + tile_x >= W || dy0 + tile_y >= H) return;  // wholly outside
  const int x = tile_x + ((int)threadIdx.x % G::kTX) * kC;
  const int gx = dx0 + x;
  if (gx >= W) return;  // this thread's columns lie past the right edge
  const int y = tile_y + (int)threadIdx.x / G::kTX;
  const int gy = dy0 + y;
  if (gy >= H) return;  // this thread's row lies past the bottom edge
  const int64_t hw = (int64_t)h * w;
  const int64_t HW = (int64_t)H * W;
  const T* l = layer + (int64_t)b * 4 * hw + (int64_t)y * w + x;
  const int64_t o = (int64_t)gy * W + gx;
  T* p = P + (int64_t)b * 3 * HW + o;
  T* a = A + (int64_t)b * HW + o;
  float l0[kC], l1[kC], l2[kC], la[kC], p0[kC], p1[kC], p2[kC], pa[kC];
  cols::load<kC>(l, l0);
  cols::load<kC>(l + hw, l1);
  cols::load<kC>(l + 2 * hw, l2);
  cols::load<kC>(l + 3 * hw, la);
  cols::load<kC>(p, p0);
  cols::load<kC>(p + HW, p1);
  cols::load<kC>(p + 2 * HW, p2);
  cols::load<kC>(a, pa);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float keep = __fsub_rn(1.f, la[c]);
    p0[c] = __fadd_rn(__fmul_rn(l0[c], la[c]), __fmul_rn(p0[c], keep));
    p1[c] = __fadd_rn(__fmul_rn(l1[c], la[c]), __fmul_rn(p1[c], keep));
    p2[c] = __fadd_rn(__fmul_rn(l2[c], la[c]), __fmul_rn(p2[c], keep));
    pa[c] = __fadd_rn(la[c], __fmul_rn(pa[c], keep));
  }
  cols::store<kC>(p, p0);
  cols::store<kC>(p + HW, p1);
  cols::store<kC>(p + 2 * HW, p2);
  cols::store<kC>(a, pa);
}

template <typename T, bool kVec>
void launch(cudaStream_t s, const void* layer, void* P, void* A,
            const int* dy0, const int* dx0, int B, int h, int w, int H,
            int W) {
  // Every tile of the region (h % 64 == 0, w % 128 == 0: whole tiles).
  constexpr int kTileH = Geometry<T, kVec>::kTileH;
  const dim3 grid(w / kTileW, h / kTileH, B);
  region_over_kernel<T, kVec><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(layer), static_cast<T*>(P), static_cast<T*>(A),
      dy0, dx0, h, w, H, W);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). bf16 = 1:
// the layer, P and A are bf16, else f32. vec = 1 launches the 16-byte
// form: W % 8 == 0 and the layer, P and A at multiples of 16 bytes. dy0
// and dx0 point to one int32 each in device memory.
int canvas_region_over(const void* layer, void* P, void* A, const void* dy0,
                       const void* dx0, int B, int h, int w, int H, int W,
                       int bf16, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || h <= 0 || w <= 0 || H <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* oy = static_cast<const int*>(dy0);
  const int* ox = static_cast<const int*>(dx0);
  if (bf16 && vec)
    launch<__nv_bfloat16, true>(s, layer, P, A, oy, ox, B, h, w, H, W);
  else if (bf16)
    launch<__nv_bfloat16, false>(s, layer, P, A, oy, ox, B, h, w, H, W);
  else if (vec)
    launch<float, true>(s, layer, P, A, oy, ox, B, h, w, H, W);
  else
    launch<float, false>(s, layer, P, A, oy, ox, B, h, w, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
