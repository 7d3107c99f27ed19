// Shared by the 2-D tiled fold kernels (fold_study.cu, tile_fold.cu):
// the per-layer scalars each block keeps in shared memory, the tile
// geometry, and the per-pixel layer steps.
//
// Tiles: a block of 256 threads, blockDim = (kTileW, kThreadRows),
// covers a tile of kTileH = 16 rows by kTileW = 128 columns of one frame
// (blockIdx.z). Thread (tx, ty) owns column x0 + tx and the kRows rows
// y0 + ty + j * kThreadRows, so a warp reads and writes 32 neighbouring
// pixels of a row, and the column half of a layer's box test is made
// once per layer per thread. "The tile lies inside / outside / across
// this layer's box" is one answer for the whole block, so a branch on
// it never diverges. The 16x128 shape was chosen by measurement: 64x32,
// 32x64, 16x128 and 8x256 came within 2% of each other in every kernel
// on an H100, 16x128 the fastest or tied (PERF.md).
//
// Numerics: every step is written with explicitly rounded intrinsics
// (and the files are built with --fmad=false), in the op order of the
// plain PyTorch versions, so each kernel is bit-identical to its plain
// version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fold_tile {

constexpr int kThreads = 256;
constexpr int kTileW = 128;                     // columns of a tile
constexpr int kThreadRows = kThreads / kTileW;  // rows of threads
constexpr int kRows = 8;                        // rows each thread owns
constexpr int kTileH = kRows * kThreadRows;     // rows of a tile

struct Layer {
  int y0, y1, x0, x1;  // inclusive box, relative to the frame; y1 < y0 = empty
  float a;             // layer alpha
  float p[3];          // premultiplied color
};

// The tile of this block, clipped to the frame.
struct Tile {
  int y0, y1, x0, x1;
  __device__ Tile(int H, int W) {
    y0 = (int)blockIdx.y * kTileH;
    y1 = min(y0 + kTileH, H) - 1;
    x0 = (int)blockIdx.x * kTileW;
    x1 = min(x0 + kTileW, W) - 1;
  }
  __device__ bool inside(const Layer& l) const {  // every pixel in the box
    return l.y0 <= y0 && l.y1 >= y1 && l.x0 <= x0 && l.x1 >= x1;
  }
  __device__ bool meets(const Layer& l) const {  // the box meets the tile
    return l.y0 <= y1 && l.y1 >= y0 && l.x0 <= x1 && l.x1 >= x0;
  }
};

__device__ __forceinline__ int thread_id() {
  return (int)(threadIdx.y * kTileW + threadIdx.x);
}

__device__ __forceinline__ int column() {
  return (int)(blockIdx.x * kTileW + threadIdx.x);
}

__device__ __forceinline__ int row(int j) {
  return (int)(blockIdx.y * kTileH + threadIdx.y + j * kThreadRows);
}

// Layer l of frame b from (L, B, 4) color/box and (L, B) gain/offset:
// p[c] = (color[c]*g + o)*a, rounded in that order.
__device__ __forceinline__ Layer load_solid(const float* color, const int* box,
                                            const float* gain,
                                            const float* offset, int l, int b,
                                            int B) {
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
  return ly;
}

// Select form (the shipped fold): a = m ? a : 0,
// P = (m ? p : 0) + P*(1 - a), A = a + A*(1 - a).
__device__ __forceinline__ void step_select(const Layer& l, bool m, float* acc) {
  const float a = m ? l.a : 0.f;
  const float keep = __fsub_rn(1.f, a);
  acc[0] = __fadd_rn(m ? l.p[0] : 0.f, __fmul_rn(acc[0], keep));
  acc[1] = __fadd_rn(m ? l.p[1] : 0.f, __fmul_rn(acc[1], keep));
  acc[2] = __fadd_rn(m ? l.p[2] : 0.f, __fmul_rn(acc[2], keep));
  acc[3] = __fadd_rn(a, __fmul_rn(acc[3], keep));
}

// The select form with m = 1 (a tile inside the box).
__device__ __forceinline__ void step_inside(const Layer& l, float* acc) {
  const float keep = __fsub_rn(1.f, l.a);
  acc[0] = __fadd_rn(l.p[0], __fmul_rn(acc[0], keep));
  acc[1] = __fadd_rn(l.p[1], __fmul_rn(acc[1], keep));
  acc[2] = __fadd_rn(l.p[2], __fmul_rn(acc[2], keep));
  acc[3] = __fadd_rn(l.a, __fmul_rn(acc[3], keep));
}

// Rank-1 float masks (fold_interior_study.py:92-103): with rf, cf in
// {0, 1}, a = (a*rf)*cf, P = (p*rf)*cf + P*(1 - a), A = a + A*(1 - a).
__device__ __forceinline__ void step_rank1(const Layer& l, float rf, float cf,
                                           float* acc) {
  const float a = __fmul_rn(__fmul_rn(l.a, rf), cf);
  const float keep = __fsub_rn(1.f, a);
  for (int c = 0; c < 3; ++c)
    acc[c] = __fadd_rn(__fmul_rn(__fmul_rn(l.p[c], rf), cf),
                       __fmul_rn(acc[c], keep));
  acc[3] = __fadd_rn(a, __fmul_rn(acc[3], keep));
}

// Multiplicative indicators (vpu_roofline.py:164-175): wt = rf*cf,
// a = a*wt, P = p*wt + P*(1 - a), A = a + A*(1 - a).
__device__ __forceinline__ void step_mult(const Layer& l, float rf, float cf,
                                          float* acc) {
  const float wt = __fmul_rn(rf, cf);
  const float a = __fmul_rn(l.a, wt);
  const float keep = __fsub_rn(1.f, a);
  for (int c = 0; c < 3; ++c)
    acc[c] = __fadd_rn(__fmul_rn(l.p[c], wt), __fmul_rn(acc[c], keep));
  acc[3] = __fadd_rn(a, __fmul_rn(acc[3], keep));
}

// Un-premultiply and store one pixel at o of a (B, 4, H, W) f32 frame
// (HW = H*W): rgb = A != 0 ? P / A : 0, alpha = A.
__device__ __forceinline__ void store_final(float* out, int64_t o, int64_t HW,
                                            const float* acc) {
  const bool nz = acc[3] != 0.f;
  const float safe = nz ? acc[3] : 1.f;
  out[o] = nz ? __fdiv_rn(acc[0], safe) : 0.f;
  out[o + HW] = nz ? __fdiv_rn(acc[1], safe) : 0.f;
  out[o + 2 * HW] = nz ? __fdiv_rn(acc[2], safe) : 0.f;
  out[o + 3 * HW] = acc[3];
}

// One block per tile of each of the B frames of H x W pixels.
inline dim3 tile_grid(int H, int W, int B) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
}

inline dim3 tile_block() { return dim3(kTileW, kThreadRows); }

}  // namespace fold_tile
