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
// color scalars (all served from L1/L2). A first version gave each thread
// one pixel of a 1-D index (a 64-bit division, two weight loads and four
// 2- or 4-byte read-modify-writes per pixel) and was held back by its
// instructions, most of all in bf16.
//
// Design: the region is whole (64, 128) blocks at (64, 128)-aligned
// offsets (the planner's invariant, checked by the wrapper), so a block
// of 256 threads owns a 128-column tile of it (blockIdx.x, blockIdx.y;
// the frame in blockIdx.z) and nothing is divided.
// - kVec: a thread owns 4 rows of 8 (bf16) or 4 (f32) neighbouring
//   columns, one 16-byte access per plane and row (cols.cuh). It loads
//   its rx weights once and keeps them; per row it forms c[k]*ry once and
//   then, per pixel, the layer value l[k] = (c[k]*ry)*rx and the over
//   step of pallas_ops.py:416-424, P = l[k]*la + P*(1-la) and
//   A = la + A*(1-la) with la = l[3]. This needs W % 8 == 0 and
//   16-byte-aligned pointers; as dx0 % 128 == 0, each vector then lies
//   wholly inside or outside the frame.
// - Otherwise the scalar instantiation runs: one column and 4 rows per
//   thread over 8x128 tiles, the same arithmetic.
// Rows past H and columns past W are skipped: that is the edge clipping
// the TPU kernel does on store; blocks wholly outside are not launched.
// Each pixel is read and written by one thread only. AccT is the
// accumulators' stored type (float, or __nv_bfloat16 for the
// quality <= 9 tier, pallas_ops.py:421-424): the math is f32 either way.
//
// Numerics: explicitly rounded intrinsics and --fmad=false, in the op
// order of the plain version (cuda_ops.region_over_sep_plain, which
// materialises (color*ry)*rx as the JAX fallback does,
// pallas_ops.py:396-398): the two are bit-identical in both storage
// types and both instantiations.

#include "cols.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;  // columns of a tile
constexpr int kRows = 4;     // rows a thread owns

// The tile of a block: 64x128 with 8 columns a thread (bf16, vector),
// 32x128 with 4 (f32, vector), 8x128 with one (scalar).
template <typename AccT, bool kVec>
struct Geometry {
  // Columns a thread owns: one 16-byte access in the vector form.
  static constexpr int kC = kVec ? 16 / (int)sizeof(AccT) : 1;
  static constexpr int kTX = kTileW / kC;     // threads along a tile row
  static constexpr int kTY = kThreads / kTX;  // rows of threads
  static constexpr int kTileH = kRows * kTY;  // rows of a tile
};

template <typename AccT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    region_over_sep_kernel(const float* __restrict__ color,
                           const float* __restrict__ ry,
                           const float* __restrict__ rx, AccT* __restrict__ P,
                           AccT* __restrict__ A, int h, int w, int H, int W,
                           int dy0, int dx0) {
  constexpr int kC = Geometry<AccT, kVec>::kC;
  constexpr int kTX = Geometry<AccT, kVec>::kTX;
  constexpr int kTY = Geometry<AccT, kVec>::kTY;
  constexpr int kTileH = Geometry<AccT, kVec>::kTileH;
  const int b = blockIdx.z;
  const int x = (int)blockIdx.x * kTileW + ((int)threadIdx.x % kTX) * kC;
  const int gx = dx0 + x;
  if (gx >= W) return;
  const int y_first = (int)blockIdx.y * kTileH + (int)threadIdx.x / kTX;
  float wx[kC];
  cols::load<kC>(rx + (int64_t)b * w + x, wx);
  const float c0 = color[b * 4 + 0];
  const float c1 = color[b * 4 + 1];
  const float c2 = color[b * 4 + 2];
  const float c3 = color[b * 4 + 3];
  const int64_t HW = (int64_t)H * W;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y_first + j * kTY;
    const int gy = dy0 + y;
    if (gy >= H) continue;
    const float wy = ry[(int64_t)b * h + y];
    const float cy0 = __fmul_rn(c0, wy);
    const float cy1 = __fmul_rn(c1, wy);
    const float cy2 = __fmul_rn(c2, wy);
    const float cy3 = __fmul_rn(c3, wy);
    const int64_t o = (int64_t)gy * W + gx;
    AccT* p = P + (int64_t)b * 3 * HW + o;
    AccT* a = A + (int64_t)b * HW + o;
    float p0[kC], p1[kC], p2[kC], pa[kC];
    cols::load<kC>(p, p0);
    cols::load<kC>(p + HW, p1);
    cols::load<kC>(p + 2 * HW, p2);
    cols::load<kC>(a, pa);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float la = __fmul_rn(cy3, wx[c]);
      const float keep = __fsub_rn(1.f, la);
      p0[c] = __fadd_rn(__fmul_rn(__fmul_rn(cy0, wx[c]), la),
                        __fmul_rn(p0[c], keep));
      p1[c] = __fadd_rn(__fmul_rn(__fmul_rn(cy1, wx[c]), la),
                        __fmul_rn(p1[c], keep));
      p2[c] = __fadd_rn(__fmul_rn(__fmul_rn(cy2, wx[c]), la),
                        __fmul_rn(p2[c], keep));
      pa[c] = __fadd_rn(la, __fmul_rn(pa[c], keep));
    }
    cols::store<kC>(p, p0);
    cols::store<kC>(p + HW, p1);
    cols::store<kC>(p + 2 * HW, p2);
    cols::store<kC>(a, pa);
  }
}

template <typename AccT, bool kVec>
void launch(cudaStream_t s, const float* color, const float* ry,
            const float* rx, void* P, void* A, int B, int h, int w, int H,
            int W, int dy0, int dx0) {
  // Only the tiles that meet the frame.
  constexpr int kTileH = Geometry<AccT, kVec>::kTileH;
  const int cols_in = w < W - dx0 ? w : W - dx0;
  const int rows_in = h < H - dy0 ? h : H - dy0;
  if (cols_in <= 0 || rows_in <= 0 || B <= 0) return;
  const dim3 grid((cols_in + kTileW - 1) / kTileW,
                  (rows_in + kTileH - 1) / kTileH, B);
  region_over_sep_kernel<AccT, kVec><<<grid, kThreads, 0, s>>>(
      color, ry, rx, static_cast<AccT*>(P), static_cast<AccT*>(A), h, w, H, W,
      dy0, dx0);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). bf16 = 1:
// P and A are bf16, else f32. vec = 1 launches the 16-byte form:
// W % 8 == 0 and rx, P and A at multiples of 16 bytes.
int canvas_region_over_sep(const void* color, const void* ry, const void* rx,
                           void* P, void* A, int B, int h, int w, int H,
                           int W, int dy0, int dx0, int bf16, int vec,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const float* y = static_cast<const float*>(ry);
  const float* x = static_cast<const float*>(rx);
  if (bf16 && vec)
    launch<__nv_bfloat16, true>(s, c, y, x, P, A, B, h, w, H, W, dy0, dx0);
  else if (bf16)
    launch<__nv_bfloat16, false>(s, c, y, x, P, A, B, h, w, H, W, dy0, dx0);
  else if (vec)
    launch<float, true>(s, c, y, x, P, A, B, h, w, H, W, dy0, dx0);
  else
    launch<float, false>(s, c, y, x, P, A, B, h, w, H, W, dy0, dx0);
  return (int)cudaGetLastError();
}

}  // extern "C"
