// Fused linear + cross-entropy forward, written by hand for Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_ce.py::_fused_ce_fwd_impl, Pallas
// kernel _fwd_kernel.
//
// Computes, for each row r of x (R, C) against W (C, V) f32, b (V,) f32 and
// an integer label per row:
//   logit[r, v] = sum_c x[r, c] * round(W[c, v]) + b[v]   (W rounded to x's
//                 dtype, the product accumulated in f32, the f32 bias after)
//   lse[r]      = log sum_v exp(logit[r, v])   (online over vocab tiles, the
//                 running max starting at -1e30, as the TPU kernel's)
//   loss[r]     = lse[r] - logit[r, label[r]]
// both (R,) f32. The (R, V) logits never reach device memory. Columns past
// V are skipped, which is what the TPU kernel's padding columns (bias
// -2e30) add to the sum: exactly nothing.
//
// What bounds it on the H100: at the flagship_mlm head (R = 64 * 160 = 10240,
// C = 64, V = 10003, bf16 x) the product is 2.R.C.V = 13.1 GFLOP (13 us at
// 989 TF/s) and the R.V = 1.02e8 exponentials take 25 us at 16 a clock per SM
// on 132 SMs, against 4.0 MB of inputs and outputs: the exponentials set the
// bound.
//
// Two designs, chosen by dtype (not a fallback). Each block owns its rows'
// outputs: no atomics, results repeat bit for bit.
//
// - float32: exact f32, scalar FMAs from shared memory (wgmma has no full-f32
//   mode). One block per tile of kRows rows (linear_ce.cuh), 256 threads,
//   kLanes per row. The block stages its x rows once, then loops over
//   64-column vocab tiles: stage the W tile (rounded) and the bias, each
//   thread computes its kPer logits of its row and folds them into its own
//   running max, sum and picked label logit; at the end the row's lanes,
//   neighbouring threads of one warp, merge their (max, sum, picked) by
//   shuffles.
//
// - bfloat16: tensor cores, the forward mode of linear_ce_wgmma.cuh (shared
//   with the backward's dx and dW/db kernels): a block owns 64 rows of x,
//   staged once by TMA, and streams 64-row tiles of Wt = round(W)^T (made by
//   the wrapper, once per train step, and shared with the backward) through
//   a TMA ring; per tile the logits are one SS wgmma, and each exponential
//   one ex2.approx.ftz. A row's partial (max, sum, label logit) states, four
//   threads of a quad, two warpgroups and the two blocks of a cluster, are
//   merged in that order by shuffles, shared memory and distributed shared
//   memory. Columns past V get the TPU kernel's pad bias (-2e30), which
//   leaves them out of the max and the sum exactly; rows past R are computed
//   from TMA's zero rows and not stored.

#include <math.h>

#include "linear_ce.cuh"
#include "linear_ce_wgmma.cuh"

namespace linear_ce {
namespace {

template <int kC>
size_t fwd_smem_bytes(int channels) {  // x tile, W tile, bias
  using Tl = Tiles<kC>;
  return sizeof(float) * (size_t(Tl::kRows) * (channels + 1) +
                          size_t(channels) * (kVocabTile + 1) + kVocabTile);
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
linear_ce_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const int* __restrict__ labels,
                     float* __restrict__ loss, float* __restrict__ lse, int rows,
                     int channels, int vocab) {
  using Tl = Tiles<kC>;
  constexpr int kStride = kVocabTile + 1;
  extern __shared__ float smem[];
  float* xs = smem;                              // [kRows][C + 1]
  float* ws = xs + Tl::kRows * (channels + 1);   // [C][kStride]
  float* bs = ws + channels * kStride;           // [kVocabTile]

  const int tid = threadIdx.x;
  const int row = tid / Tl::kLanes;
  const int lane = tid % Tl::kLanes;
  const int r0 = blockIdx.x * Tl::kRows;
  const int r = r0 + row;
  const bool live = r < rows;
  const int label = live ? labels[r] : -1;
  stage_rows<T>(xs, x, r0, Tl::kRows, rows, channels);
  const float* xrow = xs + row * (channels + 1);

  float m = kMaskValue, s = 0.f, picked = 0.f;
  for (int v0 = 0; v0 < vocab; v0 += kVocabTile) {
    __syncthreads();  // the previous tile is consumed (and the x tile stored)
    stage_cols<T, kVocabTile>(ws, bs, w, b, v0, channels, vocab);
    __syncthreads();

    float z[Tl::kPer];
    tile_logits<Tl::kPer, Tl::kLanes, kStride>(z, xrow, ws, lane, channels);
    float tile_max = kMaskValue;
#pragma unroll
    for (int i = 0; i < Tl::kPer; ++i) {
      const int j = lane + i * Tl::kLanes;
      z[i] += bs[j];
      if (v0 + j < vocab) {
        tile_max = fmaxf(tile_max, z[i]);
        if (v0 + j == label) picked = z[i];
      }
    }
    const float m_new = fmaxf(m, tile_max);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < Tl::kPer; ++i) {
      if (v0 + lane + i * Tl::kLanes < vocab) sum += expf(z[i] - m_new);
    }
    s = s * expf(m - m_new) + sum;
    m = m_new;
  }

  // merge the row's lanes (kLanes neighbouring threads of one warp)
#pragma unroll
  for (int off = Tl::kLanes / 2; off > 0; off /= 2) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, off);
    picked += __shfl_xor_sync(0xffffffffu, picked, off);
    const float m_new = fmaxf(m, m_o);
    s = s * expf(m - m_new) + s_o * expf(m_o - m_new);
    m = m_new;
  }
  if (live && lane == 0) {
    const float row_lse = m + logf(s);
    lse[r] = row_lse;
    loss[r] = row_lse - picked;
  }
}

template <typename T, int kC>
cudaError_t launch(const void* x, const float* w, const float* b, const int* labels,
                   float* loss, float* lse, int rows, int channels, int vocab,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<kC>(channels);
  cudaError_t err = allow_smem(linear_ce_fwd_kernel<T, kC>, smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + Tiles<kC>::kRows - 1) / Tiles<kC>::kRows;
  linear_ce_fwd_kernel<T, kC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, b, labels, loss, lse, rows, channels, vocab);
  return cudaGetLastError();
}

// float32: the scalar design, by the width classes of linear_ce.cuh
cudaError_t dispatch_scalar(const void* x, const float* w, const float* b, const int* labels,
                            float* loss, float* lse, int rows, int channels, int vocab,
                            cudaStream_t stream) {
  switch (width_class(channels)) {
    case 64: return launch<float, 64>(x, w, b, labels, loss, lse, rows, channels, vocab, stream);
    case 128: return launch<float, 128>(x, w, b, labels, loss, lse, rows, channels, vocab, stream);
    case 256: return launch<float, 256>(x, w, b, labels, loss, lse, rows, channels, vocab, stream);
    case 512: return launch<float, 512>(x, w, b, labels, loss, lse, rows, channels, vocab, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int kC>
__global__ void __cluster_dims__(1, 1, kParts) __launch_bounds__(kBlockThreads, 2)
linear_ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap wt_map,
                           const __grid_constant__ Io io) {
  ce_wgmma<kC, Mode::kFwd>(&x_map, &wt_map, io);
}

template <int kC>
cudaError_t launch_wgmma(const void* x, const void* wt, const Io& io, cudaStream_t stream) {
  return launch_ce_wgmma<kC, Mode::kFwd>(linear_ce_fwd_wgmma_kernel<kC>, x, wt, io, stream);
}

// bfloat16: the wgmma design, by the channel count rounded up to 16, 32, 64,
// 128, 256 or 512
cudaError_t dispatch_wgmma(const void* x, const void* wt, const Io& io, cudaStream_t stream) {
  switch (wgmma_width(io.channels)) {
    case 16: return launch_wgmma<16>(x, wt, io, stream);
    case 32: return launch_wgmma<32>(x, wt, io, stream);
    case 64: return launch_wgmma<64>(x, wt, io, stream);
    case 128: return launch_wgmma<128>(x, wt, io, stream);
    case 256: return launch_wgmma<256>(x, wt, io, stream);
    case 512: return launch_wgmma<512>(x, wt, io, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace linear_ce

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design),
// of x. x is (rows, channels) contiguous (bf16: 16-byte aligned, for TMA),
// w (channels, vocab) f32 contiguous, read by the f32 design; wt (vocab,
// channels) bf16 contiguous, W rounded to bf16 and transposed, read by the
// bf16 design (null for f32); b (vocab,) f32, labels (rows,) int32 in [0,
// vocab); loss and lse are (rows,) f32. channels is a multiple of 8 up to
// 512, rows and vocab at least 1 for bf16. Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue if a tensor map cannot be
// encoded).
extern "C" int linear_ce_fwd(int dtype, const void* x, const void* w, const void* wt,
                             const void* b, const void* labels, void* loss, void* lse, int rows,
                             int channels, int vocab, void* stream) {
  using namespace linear_ce;
  const float* bf = static_cast<const float*>(b);
  const int* lab = static_cast<const int*>(labels);
  float* lossf = static_cast<float*>(loss);
  float* lsef = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_scalar(x, static_cast<const float*>(w), bf, lab, lossf, lsef, rows, channels,
                           vocab, s);
  if (dtype == 1) {
    Io io{};
    io.b = bf;
    io.labels = lab;
    io.lse = lsef;
    io.loss = lossf;
    io.rows = rows;
    io.channels = channels;
    io.vocab = vocab;
    return dispatch_wgmma(x, wt, io, s);
  }
  return cudaErrorInvalidValue;
}
