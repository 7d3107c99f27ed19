// The fold studies: four forms of the solid fold on an empty base with
// finalize (fold_interior), and the roofline probe's fold over an image
// base, in a select and a multiplicative-indicator form (roofline_fold).
//
// Replaces two Pallas TPU kernels:
// - scripts/fold_interior_study.py `run_fold` (line 154; kernel body
//   `make_kernel`, 42-151; pallas_call 165): variants `current` (select
//   masks), `rank1` (float row x column mask multiplies), `cond` (per
//   layer: tile inside the box -> unmasked body, else masked) and
//   `switch` (per layer: outside -> skip, inside -> unmasked, else
//   masked), finalized to f32;
// - scripts/vpu_roofline.py `fold_run` / `fold_kernel` (151-216;
//   pallas_call 202): 6 layers whose color and box are shared by all
//   frames, over the image x (B, 4, H, W), stored unfinalized. The TPU
//   grid there was H // TH x W // TW (floor) and left the ragged 64 rows
//   and 384 columns of a 1088x1920 plane unwritten; this kernel covers
//   the whole plane.
//
// What bounds them on an H100: the mid/final store is 16 B/px (plus
// 16 B/px of reads for roofline_fold), against ~25 instructions per
// pixel per layer for the select form; at L = 6 the instructions can
// outweigh the bytes. The design cuts both the per-pixel overhead and the
// per-layer work where it can: a 2-D tile per block (fold_tile.cuh), so
// a pixel's row and column come from its thread and loop index with no
// division, the column test is made once per layer per thread, and the
// `cond` / `switch` forms decide per layer, once for the whole block,
// whether the tile lies inside, outside or across the box. That branch
// is uniform over the block, so it never diverges.
//
// Numerics: explicitly rounded intrinsics under --fmad=false, in the op
// order of the plain versions (study_ops.fold_variant_plain,
// roofline_fold_plain); all four fold_interior forms and both
// roofline_fold forms are bit-identical to their plain versions and to
// each other (skipped work multiplies by exactly 1 and adds exactly 0).

#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

// kVariant: 0 current, 1 rank1, 2 cond, 3 switch.
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    fold_interior_kernel(const float* __restrict__ color,
                         const int* __restrict__ box,
                         const float* __restrict__ gain,
                         const float* __restrict__ offset,
                         float* __restrict__ out, int L, int B, int H, int W) {
  extern __shared__ Layer layers[];
  const int b = blockIdx.z;
  for (int l = thread_id(); l < L; l += kThreads)
    layers[l] = load_solid(color, box, gain, offset, l, b, B);
  __syncthreads();

  const int x = column();
  if (x >= W) return;
  const Tile t(H, W);
  float acc[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int l = 0; l < L; ++l) {
    const Layer ly = layers[l];
    const bool cm = (x >= ly.x0) & (x <= ly.x1);
    if (kVariant == 1) {
      const float cf = cm ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int y = row(j);
        const float rf = ((y >= ly.y0) & (y <= ly.y1)) ? 1.f : 0.f;
        step_rank1(ly, rf, cf, acc[j]);
      }
      continue;
    }
    if (kVariant == 3 && !t.meets(ly)) continue;
    if (kVariant >= 2 && t.inside(ly)) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) step_inside(ly, acc[j]);
      continue;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = row(j);
      step_select(ly, cm & (y >= ly.y0) & (y <= ly.y1), acc[j]);
    }
  }

  const int64_t HW = (int64_t)H * W;
  float* ob = out + (int64_t)b * 4 * HW;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = row(j);
    if (y < H) store_final(ob, (int64_t)y * W + x, HW, acc[j]);
  }
}

template <bool kMult>
__global__ void __launch_bounds__(kThreads)
    roofline_fold_kernel(const float* __restrict__ x_in,
                         const float* __restrict__ col,
                         const int* __restrict__ box, float* __restrict__ out,
                         int L, int H, int W) {
  extern __shared__ Layer layers[];
  for (int l = thread_id(); l < L; l += kThreads) {
    Layer ly;
    ly.y0 = box[l * 4 + 0];
    ly.y1 = box[l * 4 + 1];
    ly.x0 = box[l * 4 + 2];
    ly.x1 = box[l * 4 + 3];
    ly.a = col[l * 4 + 3];
    for (int c = 0; c < 3; ++c) ly.p[c] = __fmul_rn(col[l * 4 + c], ly.a);
    layers[l] = ly;
  }
  __syncthreads();

  const int x = column();
  if (x >= W) return;
  const int64_t HW = (int64_t)H * W;
  const float* xb = x_in + (int64_t)blockIdx.z * 4 * HW;
  float* ob = out + (int64_t)blockIdx.z * 4 * HW;
  float acc[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = row(j);
    const int64_t o = (int64_t)y * W + x;
    for (int c = 0; c < 4; ++c) acc[j][c] = y < H ? xb[o + c * HW] : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const Layer ly = layers[l];
    const bool cm = (x >= ly.x0) & (x <= ly.x1);
    const float cf = cm ? 1.f : 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = row(j);
      const bool rm = (y >= ly.y0) & (y <= ly.y1);
      if (kMult)
        step_mult(ly, rm ? 1.f : 0.f, cf, acc[j]);
      else
        step_select(ly, rm & cm, acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = row(j);
    if (y >= H) continue;
    const int64_t o = (int64_t)y * W + x;
    for (int c = 0; c < 4; ++c) ob[o + c * HW] = acc[j][c];
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); an
// unsupported variant returns cudaErrorInvalidValue. out (B, 4, H, W) f32.
int canvas_fold_interior(const void* color, const void* box, const void* gain,
                         const void* offset, void* out, int L, int B, int H,
                         int W, int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  const dim3 grid = tile_grid(H, W, B), block = tile_block();
  const size_t smem = sizeof(Layer) * (size_t)(L > 0 ? L : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const int* bx = static_cast<const int*>(box);
  const float* g = static_cast<const float*>(gain);
  const float* o = static_cast<const float*>(offset);
  float* op = static_cast<float*>(out);
  switch (variant) {
    case 0:
      fold_interior_kernel<0><<<grid, block, smem, s>>>(c, bx, g, o, op, L, B,
                                                        H, W);
      break;
    case 1:
      fold_interior_kernel<1><<<grid, block, smem, s>>>(c, bx, g, o, op, L, B,
                                                        H, W);
      break;
    case 2:
      fold_interior_kernel<2><<<grid, block, smem, s>>>(c, bx, g, o, op, L, B,
                                                        H, W);
      break;
    default:
      fold_interior_kernel<3><<<grid, block, smem, s>>>(c, bx, g, o, op, L, B,
                                                        H, W);
  }
  return (int)cudaGetLastError();
}

// x, out (B, 4, H, W) f32; col (L, 4) f32, box (L, 4) int32 shared by all
// frames. mult: 0 select form, 1 multiplicative indicators.
int canvas_roofline_fold(const void* x, const void* col, const void* box,
                         void* out, int L, int B, int H, int W, int mult,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid(H, W, B), block = tile_block();
  const size_t smem = sizeof(Layer) * (size_t)(L > 0 ? L : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* c = static_cast<const float*>(col);
  const int* bx = static_cast<const int*>(box);
  float* op = static_cast<float*>(out);
  if (mult)
    roofline_fold_kernel<true><<<grid, block, smem, s>>>(xp, c, bx, op, L, H,
                                                         W);
  else
    roofline_fold_kernel<false><<<grid, block, smem, s>>>(xp, c, bx, op, L, H,
                                                          W);
  return (int)cudaGetLastError();
}

}  // extern "C"
