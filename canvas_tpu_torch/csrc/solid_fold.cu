// solid_fold: premultiplied "over" fold of L solid(+gain/offset) box
// layers, bottom to top, over an empty base or a base (P, A).
//
// Replaces the Pallas TPU kernel canvas_tpu/ops/pallas_ops.py
// `_kernel_factory` (lines 107-170, called from `solid_fold`, 179).
//
// What bounds it on an H100: device-memory bytes, once the instructions
// are out of the way. The stores are 16 B/px (mid fold: f32 P and A),
// 8 B/px (mid fold in bf16, or finalize in f16) plus 16 B/px of f32 or
// 8 B/px of bf16 base reads. A first version walked a 1-D pixel index
// (a 64-bit division per pixel), tested every layer in every pixel and
// moved 2 or 4 bytes per access: about 208 instructions per pixel, which
// took longer than the bytes in every form, most of all in bf16.
//
// Design (the tiles and lists of tile_fold.cu, with wide accesses):
// - One block of 256 threads per 16x128 tile of one frame (fold_tile.cuh;
//   the frame in blockIdx.z). No division anywhere.
// - The block loads the frame's L layer scalars into shared memory (the
//   premultiplied color pa[c] = (color[c]*g + o)*a, rounded in that
//   order), then its first warp builds the tile's covering list, in z
//   order, with a ballot per 32 layers: a layer whose box is empty or
//   misses the tile is left out; one whose box contains the tile is
//   marked so and takes `step_inside` (no compares, no selects); the rest
//   take `step_select`. The choice is one for the whole block, so the
//   branch never diverges.
// - kVec: a thread owns 8 neighbouring columns of one row where every
//   plane holds 2-byte values, 4 columns of two rows where one holds f32,
//   so the widest plane is read or written with one 16-byte access a
//   thread (cols.cuh) and a warp's access covers whole sectors. This
//   needs W % 8 == 0 and 16-byte-aligned planes; the wrapper decides.
//   Without it the scalar instantiation runs: one column and 8 rows per
//   thread, the same tiles and lists.
// No layer tensor and no intermediate ever reaches device memory.
//
// Storage types: the quality <= 9 tier keeps the pass-boundary (P, A)
// accumulators in bf16 (pallas_ops.py:135-138, 166-168, 256-257): the
// base may be read as bf16 (BaseT) and the mid fold may store bf16
// (kMode 3). The math is f32 in every form.
//
// Numerics: every multiply, add and divide is an explicitly rounded
// intrinsic (and the file is built with --fmad=false), so no chain is
// contracted into an FMA and the result equals the plain PyTorch fold
// (`_fold_torch`), which rounds after every operation. Leaving out a
// layer that misses the tile is exact: for every pixel of the tile its
// mask is 0, so the masked step multiplies by exactly 1 and adds exactly
// 0 (only the sign of a zero could differ, -0 + 0 = +0, which no
// comparison of values sees). Narrow stores round to nearest even per
// value (cols.cuh), as `.half()` and `.to(torch.bfloat16)` do.

#include "cols.cuh"
#include "fold_tile.cuh"

namespace {

using namespace fold_tile;

// kMode: 0 = store the (P, A) accumulators as f32,
//        1 = finalize to (B, 4, H, W) f32, 2 = finalize to f16,
//        3 = store the (P, A) accumulators as bf16.
template <int kMode>
struct OutOf {
  using type = float;
};
template <>
struct OutOf<2> {
  using type = __half;
};
template <>
struct OutOf<3> {
  using type = __nv_bfloat16;
};

// BaseT: the stored type of the base (P, A), float or __nv_bfloat16.
template <bool kBase, typename BaseT, int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
    solid_fold_kernel(const float* __restrict__ color,
                      const int* __restrict__ box,
                      const float* __restrict__ gain,
                      const float* __restrict__ offset,
                      const BaseT* __restrict__ baseP,
                      const BaseT* __restrict__ baseA, void* __restrict__ out0,
                      void* __restrict__ outA, int L, int B, int H, int W) {
  using OutT = typename OutOf<kMode>::type;
  // Columns a thread owns: one 16-byte access of the widest plane.
  constexpr bool kAnyF32 = (kBase && sizeof(BaseT) == 4) || sizeof(OutT) == 4;
  constexpr int kC = kVec ? (kAnyF32 ? 4 : 8) : 1;
  constexpr int kTX = kTileW / kC;         // threads along a row of the tile
  constexpr int kTY = kThreads / kTX;      // rows of threads
  constexpr int kR = kTileH / kTY;         // rows a thread owns
  extern __shared__ Layer layers[];  // L layers, then the covering list
  __shared__ int n_cover;
  int* cover = reinterpret_cast<int*>(layers + L);
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  for (int l = tid; l < L; l += kThreads)
    layers[l] = load_solid(color, box, gain, offset, l, b, B);
  __syncthreads();
  const Tile t(H, W);
  if (tid < 32) {
    // Entry k of the list: 2 * layer + (the tile lies inside its box).
    int n = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + tid;
      bool listed = false, inside = false;
      if (l < L) {
        const Layer ly = layers[l];
        listed = ly.y0 <= ly.y1 && ly.x0 <= ly.x1 && t.meets(ly);
        inside = t.inside(ly);
      }
      const unsigned votes = __ballot_sync(0xffffffffu, listed);
      if (listed)
        cover[n + __popc(votes & ((1u << tid) - 1u))] = 2 * l + (int)inside;
      n += __popc(votes);
    }
    if (tid == 0) n_cover = n;
  }
  __syncthreads();

  const int x = t.x0 + (tid % kTX) * kC;
  const int y_first = t.y0 + tid / kTX;    // row j: y_first + j * kTY
  if (x >= W || y_first >= H) return;
  const int64_t HW = (int64_t)H * W;
  float acc[kR][kC][4];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int y = y_first + j * kTY;
    float base[4][kC] = {};
    if constexpr (kBase) {
      if (y < H) {
        const int64_t o = (int64_t)y * W + x;
        const BaseT* bp = baseP + (int64_t)b * 3 * HW + o;
        cols::load<kC>(bp, base[0]);
        cols::load<kC>(bp + HW, base[1]);
        cols::load<kC>(bp + 2 * HW, base[2]);
        cols::load<kC>(baseA + (int64_t)b * HW + o, base[3]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][c][k] = base[k][c];
  }

  const int n = n_cover;
  for (int i = 0; i < n; ++i) {
    const int entry = cover[i];
    const Layer ly = layers[entry >> 1];
    if (entry & 1) {
#pragma unroll
      for (int j = 0; j < kR; ++j)
#pragma unroll
        for (int c = 0; c < kC; ++c) step_inside(ly, acc[j][c]);
    } else {
      bool cm[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) cm[c] = (x + c >= ly.x0) & (x + c <= ly.x1);
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int y = y_first + j * kTY;
        const bool rm = (y >= ly.y0) & (y <= ly.y1);
#pragma unroll
        for (int c = 0; c < kC; ++c) step_select(ly, rm & cm[c], acc[j][c]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int y = y_first + j * kTY;
    if (y >= H) continue;
    const int64_t o = (int64_t)y * W + x;
    float ch[4][kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* a = acc[j][c];
      if (kMode == 0 || kMode == 3) {
        ch[0][c] = a[0], ch[1][c] = a[1], ch[2][c] = a[2];
      } else {
        const bool nz = a[3] != 0.f;
        const float safe = nz ? a[3] : 1.f;
        ch[0][c] = nz ? __fdiv_rn(a[0], safe) : 0.f;
        ch[1][c] = nz ? __fdiv_rn(a[1], safe) : 0.f;
        ch[2][c] = nz ? __fdiv_rn(a[2], safe) : 0.f;
      }
      ch[3][c] = a[3];
    }
    if (kMode == 0 || kMode == 3) {
      OutT* op = static_cast<OutT*>(out0) + (int64_t)b * 3 * HW + o;
      cols::store<kC>(op, ch[0]);
      cols::store<kC>(op + HW, ch[1]);
      cols::store<kC>(op + 2 * HW, ch[2]);
      cols::store<kC>(static_cast<OutT*>(outA) + (int64_t)b * HW + o, ch[3]);
    } else {
      OutT* op = static_cast<OutT*>(out0) + (int64_t)b * 4 * HW + o;
      cols::store<kC>(op, ch[0]);
      cols::store<kC>(op + HW, ch[1]);
      cols::store<kC>(op + 2 * HW, ch[2]);
      cols::store<kC>(op + 3 * HW, ch[3]);
    }
  }
}

struct Args {
  const float* color;
  const int* box;
  const float* gain;
  const float* offset;
  const void* baseP;
  const void* baseA;
  void* out0;
  void* outA;
  int L, B, H, W;
  cudaStream_t stream;
};

template <bool kBase, typename BaseT, int kMode, bool kVec>
void launch(const Args& a) {
  const size_t smem =
      (sizeof(Layer) + sizeof(int)) * (size_t)(a.L > 0 ? a.L : 1);
  solid_fold_kernel<kBase, BaseT, kMode, kVec>
      <<<tile_grid(a.H, a.W, a.B), kThreads, smem, a.stream>>>(
          a.color, a.box, a.gain, a.offset,
          static_cast<const BaseT*>(a.baseP),
          static_cast<const BaseT*>(a.baseA), a.out0, a.outA, a.L, a.B, a.H,
          a.W);
}

template <bool kBase, typename BaseT, int kMode>
void launch_form(const Args& a, bool vec) {
  if (vec)
    launch<kBase, BaseT, kMode, true>(a);
  else
    launch<kBase, BaseT, kMode, false>(a);
}

template <bool kBase, typename BaseT>
void launch_mode(const Args& a, int mode, bool vec) {
  if (mode == 0)
    launch_form<kBase, BaseT, 0>(a, vec);
  else if (mode == 1)
    launch_form<kBase, BaseT, 1>(a, vec);
  else if (mode == 2)
    launch_form<kBase, BaseT, 2>(a, vec);
  else
    launch_form<kBase, BaseT, 3>(a, vec);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
// baseP/baseA may be null (empty base); base_bf16 = 1 reads them as
// bf16, 0 as f32. mode as kMode above. vec = 1 launches the 16-byte
// form: W % 8 == 0 and every plane pointer a multiple of 16.
int canvas_solid_fold(const void* color, const void* box, const void* gain,
                      const void* offset, const void* baseP,
                      const void* baseA, void* out0, void* outA, int L,
                      int B, int H, int W, int mode, int base_bf16, int vec,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const float*>(color),
                  static_cast<const int*>(box),
                  static_cast<const float*>(gain),
                  static_cast<const float*>(offset),
                  baseP,
                  baseA,
                  out0,
                  outA,
                  L,
                  B,
                  H,
                  W,
                  static_cast<cudaStream_t>(stream)};
  if (baseP == nullptr)
    launch_mode<false, float>(a, mode, vec != 0);
  else if (base_bf16)
    launch_mode<true, __nv_bfloat16>(a, mode, vec != 0);
  else
    launch_mode<true, float>(a, mode, vec != 0);
  return (int)cudaGetLastError();
}

const char* canvas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
