// Fused linear + cross-entropy backward, written by hand for Hopper
// (sm_90a): one kernel for dx, one for dW and db.
//
// Replaces: perceiver_io_tpu/ops/pallas_ce.py::_fused_ce_bwd_impl, Pallas
// kernels _bwd_dx_kernel (dx) and _bwd_dw_kernel (dW, db).
//
// Computes, from the forward's saved lse (R,) f32 and the loss cotangent g
// (R,) f32, with the logits recomputed as in linear_ce_fwd.cu:
//   d[r, v]  = (exp(logit[r, v] - lse[r]) - [v == label[r]]) * g[r]   (f32)
//   dx[r, c] = sum_v round(d[r, v]) * round(W[c, v])   -> x's dtype
//   dW[c, v] = sum_r x[r, c] * round(d[r, v])          -> f32
//   db[v]    = sum_r d[r, v]                            -> f32 (unrounded d)
// where round() is x's dtype, each product accumulated in f32, exactly the
// TPU kernels' rounding points. A row whose g is 0 (an ignored label) adds
// exactly 0; rows at or past R and columns at or past V add nothing.
//
// What bounds it on the H100: at the flagship_mlm head (R = 10240, C = 64,
// V = 10003, bf16 x) each kernel recomputes the logits and runs one more
// product, 2 x 2.R.C.V = 26.2 GFLOP (27 us at 989 TF/s), and R.V = 1.02e8
// exponentials (25 us at 16 a clock per SM on 132 SMs), against 4-7 MB of
// inputs and outputs: the products bound it, the exponentials close behind.
// Rows whose g is 0 need neither, and the bf16 design skips them a 64-row
// tile at a time.
//
// Two designs, chosen by dtype (not a fallback). Both are two launches, each
// owning its outputs outright (no atomics, results repeat bit for bit).
//
// - float32: exact f32, scalar FMAs from shared memory (wgmma has no full-f32
//   mode).
//   dx kernel: one block per tile of kRows rows (linear_ce.cuh) looping over
//   64-column vocab tiles. Per tile: stage W and the bias, each thread
//   recomputes d for its kPer columns of its row and writes it to a per-row
//   shared strip; the row's kLanes threads (one warp) then read the strip and
//   accumulate kAcc channels of dx each.
//   dW/db kernel: one block per tile of kDwCols vocab columns, whose W tile
//   and bias are staged once, looping over 64-row tiles of x, labels, lse and
//   g. Per tile: each thread recomputes d for its kDwPer columns of one row
//   into a shared [64][kDwCols] strip; then each thread owns one column and
//   kDwAcc channels of it and accumulates x^T.d and the column's db (which
//   the threads of the first channel write).
//
// - bfloat16: tensor cores (linear_ce_wgmma.cuh, shared with the forward),
//   the pattern of the attention backward (attention_bwd.cu) with x's rows
//   for the queries, the vocab columns for the keys, W for both K and V and
//   lse for (m, l). W is read as Wt = round(W)^T, made once per train step by
//   the wrapper and shared with the forward. dx kernel: a block per 64 rows
//   of x streams the vocab tiles; per tile S = X.Wt^T (SS), d in registers,
//   dx += round(d).Wt (RS); a row tile whose g are all 0 writes exact zeros
//   and runs nothing, so on the training path's gathered rows most blocks end
//   at once. dW/db kernel: a block per 64 vocab columns streams the live row
//   tiles of x in the transposed frame. Forming d is what a step spends most
//   on, past the two products, so it is kept to few instructions: each
//   exponential is one ex2.approx.ftz (exp2f wraps a subnormal-range fix-up
//   around it), and nothing is masked past R or V. dW leaves through shared
//   memory, so its (C, V) f32 rows are stored coalesced.

#include <math.h>

#include "linear_ce.cuh"
#include "linear_ce_wgmma.cuh"

namespace linear_ce {
namespace {

template <int kC>
size_t dx_smem_bytes(int channels) {  // x tile, W tile, bias, d strip
  using Tl = Tiles<kC>;
  return sizeof(float) * (size_t(Tl::kRows) * (channels + 1) +
                          size_t(channels) * (kVocabTile + 1) + kVocabTile +
                          size_t(Tl::kRows) * (kVocabTile + 1));
}

template <int kC>
size_t dw_smem_bytes(int channels) {  // W tile, bias, x tile, d strip, labels, lse, g
  using Tl = Tiles<kC>;
  return sizeof(float) * (size_t(channels) * (Tl::kDwCols + 1) + Tl::kDwCols +
                          size_t(kDwRows) * (channels + 1) +
                          size_t(kDwRows) * (Tl::kDwCols + 1) + 3 * kDwRows);
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
linear_ce_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, const int* __restrict__ labels,
                        const float* __restrict__ lse, const float* __restrict__ g,
                        T* __restrict__ dx, int rows, int channels, int vocab) {
  using Tl = Tiles<kC>;
  constexpr int kStride = kVocabTile + 1;
  extern __shared__ float smem[];
  float* xs = smem;                              // [kRows][C + 1]
  float* ws = xs + Tl::kRows * (channels + 1);   // [C][kStride]
  float* bs = ws + channels * kStride;           // [kVocabTile]
  float* ds = bs + kVocabTile;                   // [kRows][kStride]

  const int tid = threadIdx.x;
  const int row = tid / Tl::kLanes;
  const int lane = tid % Tl::kLanes;
  const int r0 = blockIdx.x * Tl::kRows;
  const int r = r0 + row;
  const bool live = r < rows;
  const int label = live ? labels[r] : -1;
  const float lse_r = live ? lse[r] : 0.f;
  const float g_r = live ? g[r] : 0.f;
  stage_rows<T>(xs, x, r0, Tl::kRows, rows, channels);
  const float* xrow = xs + row * (channels + 1);
  float* drow = ds + row * kStride;

  float acc[Tl::kAcc];
#pragma unroll
  for (int k = 0; k < Tl::kAcc; ++k) acc[k] = 0.f;

  for (int v0 = 0; v0 < vocab; v0 += kVocabTile) {
    __syncthreads();  // the previous tile is consumed (and the x tile stored)
    stage_cols<T, kVocabTile>(ws, bs, w, b, v0, channels, vocab);
    __syncthreads();

    float z[Tl::kPer];
    tile_logits<Tl::kPer, Tl::kLanes, kStride>(z, xrow, ws, lane, channels);
#pragma unroll
    for (int i = 0; i < Tl::kPer; ++i) {
      const int j = lane + i * Tl::kLanes;
      float d = 0.f;
      if (live && v0 + j < vocab) {
        const float p = expf(z[i] + bs[j] - lse_r);
        d = (p - (v0 + j == label ? 1.f : 0.f)) * g_r;
      }
      drow[j] = round_to<T>(d);
    }
    __syncwarp();  // the row's lanes see each other's d

#pragma unroll 4
    for (int j = 0; j < kVocabTile; ++j) {
      const float d = drow[j];
#pragma unroll
      for (int k = 0; k < Tl::kAcc; ++k) {
        const int c = lane + k * Tl::kLanes;
        if (c < channels) acc[k] = fmaf(d, ws[c * kStride + j], acc[k]);
      }
    }
  }

  if (live) {
    T* out = dx + int64_t(r) * channels;
#pragma unroll
    for (int k = 0; k < Tl::kAcc; ++k) {
      const int c = lane + k * Tl::kLanes;
      if (c < channels) out[c] = from_f32<T>(acc[k]);
    }
  }
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
linear_ce_bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, const int* __restrict__ labels,
                        const float* __restrict__ lse, const float* __restrict__ g,
                        float* __restrict__ dw, float* __restrict__ db, int rows,
                        int channels, int vocab) {
  using Tl = Tiles<kC>;
  constexpr int kCols = Tl::kDwCols;
  constexpr int kStride = kCols + 1;
  constexpr int kChannelStep = kThreads / kCols;
  extern __shared__ float smem[];
  float* ws = smem;                                   // [C][kStride]
  float* bs = ws + channels * kStride;                // [kCols]
  float* xs = bs + kCols;                             // [kDwRows][C + 1]
  float* ds = xs + kDwRows * (channels + 1);          // [kDwRows][kStride]
  float* lses = ds + kDwRows * kStride;               // [kDwRows]
  float* gs = lses + kDwRows;                         // [kDwRows]
  int* labs = reinterpret_cast<int*>(gs + kDwRows);   // [kDwRows]

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * kCols;
  // the logits: four threads per row of the row tile
  const int row = tid / Tl::kDwLanes;
  const int lane = tid % Tl::kDwLanes;
  // dW and db: one column and kDwAcc channels of it per thread
  const int col = tid % kCols;
  const int c0 = tid / kCols;

  stage_cols<T, kCols>(ws, bs, w, b, v0, channels, vocab);
  float acc[Tl::kDwAcc];
#pragma unroll
  for (int k = 0; k < Tl::kDwAcc; ++k) acc[k] = 0.f;
  float db_acc = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kDwRows) {
    __syncthreads();  // the previous tile is consumed (and the W tile stored)
    stage_rows<T>(xs, x, r0, kDwRows, rows, channels);
    if (tid < kDwRows) {
      const bool live = r0 + tid < rows;
      labs[tid] = live ? labels[r0 + tid] : -1;
      lses[tid] = live ? lse[r0 + tid] : 0.f;
      gs[tid] = live ? g[r0 + tid] : 0.f;
    }
    __syncthreads();

    float z[Tl::kDwPer];
    tile_logits<Tl::kDwPer, Tl::kDwLanes, kStride>(z, xs + row * (channels + 1), ws, lane,
                                                   channels);
    const bool live = r0 + row < rows;
#pragma unroll
    for (int i = 0; i < Tl::kDwPer; ++i) {
      const int j = lane + i * Tl::kDwLanes;
      float d = 0.f;
      if (live && v0 + j < vocab) {
        const float p = expf(z[i] + bs[j] - lses[row]);
        d = (p - (v0 + j == labs[row] ? 1.f : 0.f)) * gs[row];
      }
      ds[row * kStride + j] = d;
    }
    __syncthreads();

#pragma unroll 4
    for (int rr = 0; rr < kDwRows; ++rr) {
      const float d = ds[rr * kStride + col];
      db_acc += d;
      const float dr = round_to<T>(d);
      const float* xr = xs + rr * (channels + 1);
#pragma unroll
      for (int k = 0; k < Tl::kDwAcc; ++k) {
        const int c = c0 + k * kChannelStep;
        if (c < channels) acc[k] = fmaf(xr[c], dr, acc[k]);
      }
    }
  }

  if (v0 + col < vocab) {
#pragma unroll
    for (int k = 0; k < Tl::kDwAcc; ++k) {
      const int c = c0 + k * kChannelStep;
      if (c < channels) dw[int64_t(c) * vocab + v0 + col] = acc[k];
    }
    if (c0 == 0) db[v0 + col] = db_acc;
  }
}

template <int kC>
__global__ void __cluster_dims__(1, 1, kParts) __launch_bounds__(kBlockThreads, 1)
linear_ce_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap wt_map,
                              const __grid_constant__ Io io) {
  ce_wgmma<kC, Mode::kDx>(&x_map, &wt_map, io);
}

template <int kC>
__global__ void __cluster_dims__(1, 1, kParts) __launch_bounds__(kBlockThreads, 1)
linear_ce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap wt_map,
                              const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ Io io) {
  ce_wgmma<kC, Mode::kDw>(&wt_map, &x_map, io);
}

struct Args {
  const void* x;
  const float *w, *b, *lse, *g;
  const __nv_bfloat16* wt;
  const int* labels;
  void* dx;
  float *dw, *db;
  int rows, channels, vocab;
  cudaStream_t stream;
};

template <typename T, int kC>
cudaError_t launch_dx(const Args& a) {
  const size_t smem = dx_smem_bytes<kC>(a.channels);
  cudaError_t err = allow_smem(linear_ce_bwd_dx_kernel<T, kC>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.rows + Tiles<kC>::kRows - 1) / Tiles<kC>::kRows;
  linear_ce_bwd_dx_kernel<T, kC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.w, a.b, a.labels, a.lse, a.g, static_cast<T*>(a.dx),
      a.rows, a.channels, a.vocab);
  return cudaGetLastError();
}

template <typename T, int kC>
cudaError_t launch_dw(const Args& a) {
  const size_t smem = dw_smem_bytes<kC>(a.channels);
  cudaError_t err = allow_smem(linear_ce_bwd_dw_kernel<T, kC>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.vocab + Tiles<kC>::kDwCols - 1) / Tiles<kC>::kDwCols;
  linear_ce_bwd_dw_kernel<T, kC><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.w, a.b, a.labels, a.lse, a.g, a.dw, a.db, a.rows,
      a.channels, a.vocab);
  return cudaGetLastError();
}

template <int kC, bool kDx>
cudaError_t launch_wgmma(const Args& a) {
  Io io{};
  io.b = a.b;
  io.labels = a.labels;
  io.lse = const_cast<float*>(a.lse);
  io.g = a.g;
  io.dx = static_cast<__nv_bfloat16*>(a.dx);
  io.dw = a.dw;
  io.db = a.db;
  io.rows = a.rows;
  io.channels = a.channels;
  io.vocab = a.vocab;
  if constexpr (kDx)
    return launch_ce_wgmma<kC, Mode::kDx>(linear_ce_bwd_dx_wgmma_kernel<kC>, a.x, a.wt, io,
                                          a.stream);
  else
    return launch_ce_wgmma<kC, Mode::kDw>(linear_ce_bwd_dw_wgmma_kernel<kC>, a.x, a.wt, io,
                                          a.stream);
}

// float32: the scalar design, by the width classes of linear_ce.cuh
template <bool kDx>
cudaError_t dispatch_scalar(const Args& a) {
  switch (width_class(a.channels)) {
    case 64: return kDx ? launch_dx<float, 64>(a) : launch_dw<float, 64>(a);
    case 128: return kDx ? launch_dx<float, 128>(a) : launch_dw<float, 128>(a);
    case 256: return kDx ? launch_dx<float, 256>(a) : launch_dw<float, 256>(a);
    case 512: return kDx ? launch_dx<float, 512>(a) : launch_dw<float, 512>(a);
    default: return cudaErrorInvalidValue;
  }
}

// bfloat16: the wgmma design, by the channel count rounded up to 16, 32, 64,
// 128, 256 or 512
template <bool kDx>
cudaError_t dispatch_wgmma(const Args& a) {
  switch (wgmma_width(a.channels)) {
    case 16: return launch_wgmma<16, kDx>(a);
    case 32: return launch_wgmma<32, kDx>(a);
    case 64: return launch_wgmma<64, kDx>(a);
    case 128: return launch_wgmma<128, kDx>(a);
    case 256: return launch_wgmma<256, kDx>(a);
    case 512: return launch_wgmma<512, kDx>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDx>
int dispatch(int dtype, const Args& a) {
  if (dtype == 0) return dispatch_scalar<kDx>(a);
  if (dtype == 1) return dispatch_wgmma<kDx>(a);
  return cudaErrorInvalidValue;
}

Args make_args(const void* x, const void* w, const void* wt, const void* b, const void* labels,
               const void* lse, const void* g, void* dx, void* dw, void* db, int rows,
               int channels, int vocab, void* stream) {
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.b = static_cast<const float*>(b);
  a.labels = static_cast<const int*>(labels);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.dx = dx;
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.rows = rows; a.channels = channels; a.vocab = vocab;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace
}  // namespace linear_ce

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design),
// of x and dx. x is (rows, channels) contiguous (bf16: 16-byte aligned, for
// TMA), w (channels, vocab) f32 contiguous, read by the f32 design; wt
// (vocab, channels) bf16 contiguous, W rounded to bf16 and transposed, read
// by the bf16 design (null for f32); b (vocab,) f32, labels (rows,) int32 in
// [0, vocab), lse and g (rows,) f32; dx is (rows, channels) in x's dtype, dw
// (channels, vocab) f32 and db (vocab,) f32, contiguous. channels is a
// multiple of 8 up to 512, rows and vocab at least 1 for bf16. Each returns
// the cudaError_t of its launch (0 on success; cudaErrorInvalidValue if a
// tensor map cannot be encoded).
extern "C" int linear_ce_bwd_dx(int dtype, const void* x, const void* w, const void* wt,
                                const void* b, const void* labels, const void* lse,
                                const void* g, void* dx, int rows, int channels, int vocab,
                                void* stream) {
  return linear_ce::dispatch<true>(
      dtype, linear_ce::make_args(x, w, wt, b, labels, lse, g, dx, nullptr, nullptr, rows,
                                  channels, vocab, stream));
}

extern "C" int linear_ce_bwd_dw(int dtype, const void* x, const void* w, const void* wt,
                                const void* b, const void* labels, const void* lse,
                                const void* g, void* dw, void* db, int rows, int channels,
                                int vocab, void* stream) {
  return linear_ce::dispatch<false>(
      dtype, linear_ce::make_args(x, w, wt, b, labels, lse, g, nullptr, dw, db, rows,
                                  channels, vocab, stream));
}
