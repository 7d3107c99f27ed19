// tile_fold: the solid fold of L solid(+gain/offset) box layers over an
// empty base or a base (P, A), where each tile folds only the layers
// whose box meets it, in z order; stores the (P, A) accumulators or
// finalizes to (B, 4, H, W) f32.
//
// Replaces the Pallas TPU kernel scripts/fold_tile_study.py `tile_fold`
// (line 33; pallas_call 151). The TPU kernel took per-(frame, tile)
// layer lists built on the host side by a keyed argsort (51-65) through
// scalar prefetch, and ran a dynamic-trip loop over them (110-111). Here
// each block builds its own list in shared memory from the frame's L
// boxes: one pass over L layers by one thread, in z order, so no sort
// and no host-side work. Skipping a layer that misses the tile is
// bit-exact: for every pixel of the tile its mask is 0, a = 0, and the
// masked step multiplies by exactly 1 and adds exactly 0.
//
// What bounds it on an H100: as solid_fold, 16 B/px of stores (plus
// 16 B/px of base reads) against the per-layer mask math; this kernel
// drops the math of the layers that miss the tile, keeps the masked
// step for those that meet it, and takes its tile geometry from
// fold_tile.cuh (no per-pixel division).
//
// Numerics: explicitly rounded intrinsics under --fmad=false, in the op
// order of the plain version (study_ops.tile_fold_plain), which is
// bit-identical to it and to cuda_ops.solid_fold_plain.

#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

// kMode: 0 = store the (P, A) accumulators, 1 = finalize to f32.
template <bool kBase, int kMode>
__global__ void __launch_bounds__(kThreads)
    tile_fold_kernel(const float* __restrict__ color,
                     const int* __restrict__ box,
                     const float* __restrict__ gain,
                     const float* __restrict__ offset,
                     const float* __restrict__ baseP,
                     const float* __restrict__ baseA, float* __restrict__ out0,
                     float* __restrict__ outA, int L, int B, int H, int W) {
  extern __shared__ Layer layers[];  // L layers, then the covering list
  __shared__ int n_cover;
  int* cover = reinterpret_cast<int*>(layers + L);
  const int b = blockIdx.z;
  for (int l = thread_id(); l < L; l += kThreads)
    layers[l] = load_solid(color, box, gain, offset, l, b, B);
  __syncthreads();
  const Tile t(H, W);
  if (thread_id() == 0) {
    int n = 0;
    for (int l = 0; l < L; ++l)
      if (t.meets(layers[l])) cover[n++] = l;
    n_cover = n;
  }
  __syncthreads();

  const int x = column();
  if (x >= W) return;
  const int64_t HW = (int64_t)H * W;
  float acc[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = row(j);
    const int64_t o = (int64_t)y * W + x;
    if (kBase && y < H) {
      const float* bp = baseP + (int64_t)b * 3 * HW + o;
      acc[j][0] = bp[0];
      acc[j][1] = bp[HW];
      acc[j][2] = bp[2 * HW];
      acc[j][3] = baseA[(int64_t)b * HW + o];
    } else {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  }

  const int n = n_cover;
  for (int k = 0; k < n; ++k) {
    const Layer ly = layers[cover[k]];
    const bool cm = (x >= ly.x0) & (x <= ly.x1);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = row(j);
      step_select(ly, cm & (y >= ly.y0) & (y <= ly.y1), acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = row(j);
    if (y >= H) continue;
    const int64_t o = (int64_t)y * W + x;
    if (kMode == 0) {
      float* op = out0 + (int64_t)b * 3 * HW + o;
      op[0] = acc[j][0];
      op[HW] = acc[j][1];
      op[2 * HW] = acc[j][2];
      outA[(int64_t)b * HW + o] = acc[j][3];
    } else {
      store_final(out0 + (int64_t)b * 4 * HW, o, HW, acc[j]);
    }
  }
}

template <bool kBase, int kMode>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
            const float* color, const int* box, const float* gain,
            const float* offset, const float* baseP, const float* baseA,
            float* out0, float* outA, int L, int B, int H, int W) {
  tile_fold_kernel<kBase, kMode><<<grid, block, smem, stream>>>(
      color, box, gain, offset, baseP, baseA, out0, outA, L, B, H, W);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// baseP/baseA may be null (empty base). mode 0: out0 = P (B, 3, H, W), outA = A
// (B, 1, H, W); mode 1: out0 = (B, 4, H, W) f32, outA unused.
int canvas_tile_fold(const void* color, const void* box, const void* gain,
                     const void* offset, const void* baseP, const void* baseA,
                     void* out0, void* outA, int L, int B, int H, int W,
                     int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = tile_grid(H, W, B), block = tile_block();
  const size_t smem = (sizeof(Layer) + sizeof(int)) * (size_t)(L > 0 ? L : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(color);
  const int* bx = static_cast<const int*>(box);
  const float* g = static_cast<const float*>(gain);
  const float* o = static_cast<const float*>(offset);
  const float* bp = static_cast<const float*>(baseP);
  const float* ba = static_cast<const float*>(baseA);
  float* o0 = static_cast<float*>(out0);
  float* oa = static_cast<float*>(outA);
  if (bp != nullptr) {
    if (mode == 0)
      launch<true, 0>(grid, block, smem, s, c, bx, g, o, bp, ba, o0, oa, L, B,
                      H, W);
    else
      launch<true, 1>(grid, block, smem, s, c, bx, g, o, bp, ba, o0, oa, L, B,
                      H, W);
  } else {
    if (mode == 0)
      launch<false, 0>(grid, block, smem, s, c, bx, g, o, bp, ba, o0, oa, L,
                       B, H, W);
    else
      launch<false, 1>(grid, block, smem, s, c, bx, g, o, bp, ba, o0, oa, L,
                       B, H, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
