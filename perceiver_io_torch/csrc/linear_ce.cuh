// Shared pieces of the fused linear + cross-entropy kernels
// (linear_ce_fwd.cu, linear_ce_bwd.cu): the tiling of each width class, the
// staging of row and vocab tiles into shared memory, and the per-thread
// logits of one tile.
//
// A width class kC is the smallest of 64, 128, 256, 512 that is at least the
// channel count C (a multiple of 8). It fixes the tiles so that every thread
// keeps at most 32 accumulators and a block fits in shared memory at C = 512:
// - the forward and dx kernels: a block owns kRows rows (32, or 16 at kC =
//   512), kLanes = 256 / kRows threads per row; each vocab tile is 64 columns,
//   kPer of them per thread, and a dx thread accumulates kAcc = kC / kLanes
//   channels of its row;
// - the dW/db kernel: a block owns kDwCols vocab columns (32, or 16 at kC =
//   512) and loops over 64-row tiles, four threads per row for the logits;
//   each thread accumulates kDwAcc = kC * kDwCols / 256 entries of dW.
// Tiles are staged as f32 with an odd row stride, so column reads of the
// threads of a warp hit distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace linear_ce {

constexpr int kThreads = 256;
constexpr int kVocabTile = 64;        // vocab columns per tile of the row-owning kernels
constexpr int kDwRows = 64;           // rows per tile of the dW/db kernel's loop
constexpr float kMaskValue = -1e30f;  // pallas_ce.MASK_VALUE: the running max's floor

template <int kC>
struct Tiles {
  static_assert(kC == 64 || kC == 128 || kC == 256 || kC == 512, "width class");
  static constexpr int kRows = kC <= 256 ? 32 : 16;
  static constexpr int kLanes = kThreads / kRows;
  static constexpr int kPer = kVocabTile / kLanes;
  static constexpr int kAcc = kC / kLanes;
  static constexpr int kDwCols = kC <= 256 ? 32 : 16;
  static constexpr int kDwLanes = kThreads / kDwRows;
  static constexpr int kDwPer = kDwCols / kDwLanes;
  static constexpr int kDwAcc = kC * kDwCols / kThreads;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a value entering a product in x's dtype (w.astype(x.dtype), d.astype(x.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + n_rows) of x (R, C) into an f32 [n_rows][C + 1] tile; rows
// at or past R become zeros
template <typename T>
__device__ __forceinline__ void stage_rows(float* xs, const T* __restrict__ x, int r0,
                                           int n_rows, int rows, int channels) {
  const int stride = channels + 1;
  for (int idx = threadIdx.x; idx < n_rows * channels; idx += kThreads) {
    const int r = idx / channels, c = idx - r * channels;
    xs[r * stride + c] = r0 + r < rows ? to_f32(x[int64_t(r0 + r) * channels + c]) : 0.f;
  }
}

// columns [v0, v0 + kCols) of W (C, V) f32, rounded to x's dtype T, into an
// f32 [C][kCols + 1] tile, and the f32 bias into bs; columns at or past V
// become zeros (they are skipped or given d = 0 by the callers)
template <typename T, int kCols>
__device__ __forceinline__ void stage_cols(float* ws, float* bs, const float* __restrict__ w,
                                           const float* __restrict__ b, int v0, int channels,
                                           int vocab) {
  constexpr int stride = kCols + 1;
  for (int idx = threadIdx.x; idx < channels * kCols; idx += kThreads) {
    const int c = idx / kCols, j = idx - c * kCols;
    ws[c * stride + j] = v0 + j < vocab ? round_to<T>(w[int64_t(c) * vocab + v0 + j]) : 0.f;
  }
  for (int j = threadIdx.x; j < kCols; j += kThreads) bs[j] = v0 + j < vocab ? b[v0 + j] : 0.f;
}

// z[i] = x_row . w[:, lane + i * kLanes] over the C channels, f32 FMAs
// (without the bias)
template <int kPer, int kLanes, int kStride>
__device__ __forceinline__ void tile_logits(float (&z)[kPer], const float* xrow,
                                            const float* ws, int lane, int channels) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) z[i] = 0.f;
#pragma unroll 4
  for (int c = 0; c < channels; ++c) {
    const float xc = xrow[c];
    const float* wc = ws + c * kStride + lane;
#pragma unroll
    for (int i = 0; i < kPer; ++i) z[i] = fmaf(xc, wc[i * kLanes], z[i]);
  }
}

// the width class of C, or 0 when C is not a multiple of 8 up to 512
inline int width_class(int channels) {
  if (channels <= 0 || channels % 8) return 0;
  if (channels <= 64) return 64;
  if (channels <= 128) return 128;
  if (channels <= 256) return 256;
  if (channels <= 512) return 512;
  return 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace linear_ce
