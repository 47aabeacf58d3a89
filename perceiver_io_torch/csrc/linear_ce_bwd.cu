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
// - bfloat16: tensor cores, the pattern of the attention backward
//   (attention_bwd.cu) with x's rows for the queries, the vocab columns for
//   the keys, W for both K and V and lse for (m, l). W is read as
//   Wt = round(W)^T, a (V, C) bf16 tensor the wrapper makes once per
//   backward, so x and Wt are both K-major (C contiguous) and one swizzled
//   shared-memory tile of either serves both products of a step. Each block
//   owns 64 rows of one of them (x for dx, Wt for dW/db), staged once by
//   TMA, and streams its share of the other's 64-row tiles: the two blocks of
//   a cluster (grid.z) take alternate tiles, and a block's two consumer
//   warpgroups alternate again, each through its own two-stage TMA ring (one
//   stage at C = 512). Rank 0 adds its peer's sums through distributed
//   shared memory:
//   dx kernel, per 64-row tile of x: for each vocab tile S = X.Wt^T (SS,
//     K = C), d in registers (the bias staged per tile), rounded as the A
//     operand of dx += d.Wt (RS, the Wt tile as an MN-major B). A row tile
//     whose g are all 0 writes exact zeros and runs nothing, so on the
//     training path's gathered rows most blocks end at once: the cluster
//     spreads the live row tiles over twice the SMs.
//   dW/db kernel, per 64-column vocab tile, in the transposed frame: for
//     each row tile S^T = Wt.X^T (SS), d^T in registers (labels, lse and g
//     of the row tile staged beside its x tile), db += the row sums of the
//     unrounded d^T (per thread, then a quad shuffle), dW^T += round(d^T).X
//     (RS, the x tile as an MN-major B). Row tiles whose g are all 0 are
//     never loaded: each block lists the live ones from g (a warp vote per
//     tile, up to kListChunk tiles at a time) and takes every other one.
//   Forming d is what a step spends most on, past the two products, so it
//   is kept to few instructions: each exponential is one ex2.approx.ftz
//   (exp2f wraps a subnormal-range fix-up around it), and nothing is masked
//   past R or V, where g is 0 or TMA's zero rows of x or Wt take d's term
//   out of both products (dW and db are not stored there).
//   The two warpgroups' accumulators, then the cluster's two blocks' sums,
//   are added in a fixed order through shared memory (the drained rings),
//   and dW leaves through it too, so its (C, V) f32 rows are stored
//   coalesced. A thread accumulates at most 256 channels (128 registers);
//   at C = 512 the channels split across two blocks (grid.y), each
//   recomputing the logits. C below 16 (C = 8) is zero-padded to 16 by
//   TMA's out-of-bounds fill, as C = 24 to 32.

#include <math.h>

#include "attention_tiles.cuh"
#include "linear_ce.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: the wgmma design
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;                 // rows of an owned or a streamed tile
constexpr int kGroups = 2;                    // consumer warpgroups of a block
constexpr int kGroupThreads = 128;
constexpr int kBlockThreads = kGroups * kGroupThreads;
constexpr int kListChunk = 256;               // row tiles the dW/db kernel lists at once
constexpr int kParts = 2;                     // blocks of a cluster, splitting the streamed tiles
constexpr int kDwStride = kTileRows + 4;      // floats between channels of the dW exchange

// The tiles of a width class kC: the channel count rounded up to 16, 32, 64,
// 128, 256 or 512, the columns past C zero-filled by TMA.
template <int kC>
struct Geo {
  static_assert(kC == 16 || kC == 32 || kC == 64 || kC == 128 || kC == 256 || kC == 512,
                "width class");
  static constexpr int kAtomCols = kC < 64 ? kC : 64;       // columns of one swizzle atom
  static constexpr int kAtoms = kC / kAtomCols;
  static constexpr int kRowBytes = 2 * kAtomCols;           // 32, 64 or 128
  static constexpr uint32_t kLayout = hopper::layout_for_row_bytes(kRowBytes);
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;    // bytes between 8-row groups
  static constexpr int kAtomBytes = kTileRows * kRowBytes;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  static constexpr int kAccAtoms = kAtoms < 4 ? kAtoms : 4;  // at most 256 channels a thread
  static constexpr int kAccCols = kAccAtoms * kAtomCols;
  static constexpr int kSplit = kAtoms / kAccAtoms;          // blocks along the channels
  static constexpr int kRegs = kAtomCols / 2;                // accumulator floats per atom
  static constexpr int kStages = kC <= 256 ? 2 : 1;
  static constexpr int kRing = kGroups * kStages;            // streamed tiles in shared memory
  // 1024 bytes of alignment slack, the owned tile, the rings, the streamed
  // tiles' column statistics ([kRing][3][64] floats), the ring barriers and
  // the owned tile's, and the dW/db kernel's list of live row tiles
  static constexpr size_t kSmem = 1024 + size_t(kTileBytes) * (1 + kRing) +
                                  sizeof(float) * kRing * 3 * kTileRows +
                                  8 * (kRing + 1) + sizeof(int) * (kListChunk + 1);
  // the drained rings hold the exchange of the two warpgroups' accumulators
  static_assert(sizeof(float) * kTileRows * (kAccCols + 8) <= size_t(kRing) * kTileBytes &&
                    sizeof(float) * (kAccCols * kDwStride + kTileRows) <=
                        size_t(kRing) * kTileBytes,
                "exchange buffer");
};

// 2^x by one MUFU.EX2 (a result below 2^-126 flushes to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads) : "memory");
}

// The row tiles base .. base + n - 1 whose cotangents are not all 0 (a warp
// vote per tile), listed in live[0 .. count) with the count in
// live[kListChunk]. All threads of the block call it; it synchronises them.
__device__ __forceinline__ int list_live_rows(const float* __restrict__ g, int rows, int base,
                                              int n, int* live) {
  constexpr int kWarps = kBlockThreads / 32, kUnroll = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = warp; i0 < n; i0 += kWarps * kUnroll) {
    bool nonzero[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the loads of kUnroll tiles in flight together
      const int r = (base + i0 + u * kWarps) * kTileRows + lane;
      const float g0 = r < rows ? g[r] : 0.f;
      const float g1 = r + 32 < rows ? g[r + 32] : 0.f;
      nonzero[u] = g0 != 0.f || g1 != 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kWarps;
      const bool any = __any_sync(0xffffffffu, nonzero[u]);
      if (lane == 0 && i < n) live[i] = any;
    }
  }
  __syncthreads();
  if (warp == 0) {  // the flags compacted in place into the list of live tiles
    int count = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const bool flag = i0 + lane < n && live[i0 + lane];
      const uint32_t ballot = __ballot_sync(0xffffffffu, flag);
      if (flag) live[count + __popc(ballot & ((1u << lane) - 1))] = base + i0 + lane;
      count += __popc(ballot);
    }
    if (lane == 0) live[kListChunk] = count;
  }
  __syncthreads();
  return live[kListChunk];
}

// The body of both bf16 kernels. The block owns 64 rows (o0 ..) of own_map's
// tensor (x for dx, Wt for dW/db) and streams 64-row tiles of stream_map's
// (its share of Wt's for dx, x's for dW/db): S = Own.Stream^T, d from S,
// acc += round(d).Stream.
template <int kC, bool kDx>
__device__ __forceinline__ void bwd_wgmma(const CUtensorMap* own_map,
                                          const CUtensorMap* stream_map,
                                          const float* __restrict__ b,
                                          const int* __restrict__ labels,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ g,
                                          __nv_bfloat16* __restrict__ dx, float* __restrict__ dw,
                                          float* __restrict__ db, int rows, int channels,
                                          int vocab) {
  using G = Geo<kC>;
  using attn_tiles::kLog2e;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* own = smem;                                        // [atom][64 rows]
  uint8_t* ring = own + G::kTileBytes;                        // [group][stage][atom][64 rows]
  float* colstat = reinterpret_cast<float*>(ring + G::kRing * G::kTileBytes);
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(colstat + G::kRing * 3 * kTileRows);
  uint64_t* own_bar = ring_bar + G::kRing;
  int* live = reinterpret_cast<int*>(own_bar + 1);            // [kListChunk + 1]

  const int tid = threadIdx.x;
  const int grp = tid / kGroupThreads;
  const int gtid = tid % kGroupThreads;
  const int warp = gtid / 32, lane = tid % 32;
  const int o0 = blockIdx.x * kTileRows;
  const int c_lo = blockIdx.y * G::kAccCols;                  // this block's output channels
  const int acc_atom0 = blockIdx.y * G::kAccAtoms;
  const int n_tiles = ((kDx ? vocab : rows) + kTileRows - 1) / kTileRows;
  // the block's rank in its cluster, which takes every kParts-th streamed
  // tile from this one on
  const int part = int(hopper::cluster_rank());
  // this thread's accumulator rows row_l and row_l + 8 of the owned tile, and
  // its columns 8c + col_in_chunk + e of a streamed tile
  const int row_l = warp * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);

  if constexpr (kDx) {
    // a row tile whose cotangents are all 0 has dx = 0 exactly: write it, load nothing
    const bool any = __syncthreads_or(tid < kTileRows && o0 + tid < rows && g[o0 + tid] != 0.f);
    if (!any) {  // (the cluster's blocks decide alike, so none waits at its barrier)
      if (part != 0) return;
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      for (int i = tid; i < kTileRows * G::kAccCols / 2; i += kBlockThreads) {
        const int r = o0 + i / (G::kAccCols / 2), c = c_lo + 2 * (i % (G::kAccCols / 2));
        if (r < rows && c < channels)
          *reinterpret_cast<__nv_bfloat162*>(dx + int64_t(r) * channels + c) = zero;
      }
      return;
    }
  }

  if (tid == 0) {
    for (int i = 0; i < G::kRing; ++i) hopper::mbar_init(&ring_bar[i], 1);
    hopper::mbar_init(own_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(own_bar, G::kTileBytes);
#pragma unroll
    for (int a = 0; a < G::kAtoms; ++a)
      hopper::tma_load_2d(own + a * G::kAtomBytes, own_map, own_bar, a * G::kAtomCols, o0);
  }

  // the owned rows' own statistics: dx, label, lse.log2(e) and g of x's
  // rows; dW/db, the bias of W's columns (0 past V, where d is 0)
  int row_label[2];
  float row_a[2], row_g[2];
  bool row_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = o0 + row_l + 8 * r;
    if constexpr (kDx) {
      row_valid[r] = o < rows;
      row_label[r] = row_valid[r] ? labels[o] : -1;
      row_a[r] = row_valid[r] ? lse[o] * kLog2e : 0.f;
      row_g[r] = row_valid[r] ? g[o] : 0.f;
    } else {
      row_valid[r] = o < vocab;
      row_label[r] = o;
      row_a[r] = row_valid[r] ? b[o] : 0.f;
      row_g[r] = 0.f;
    }
  }

  // one streamed tile's column statistics into slot `slot`, by the group's
  // first 64 threads: dx, the bias of the tile's vocab columns; dW/db, the
  // label, lse.log2(e) and g of its rows (past R: label -1, g 0)
  auto stage_stats = [&](int tile, int slot) {
    if (gtid < kTileRows) {
      float* cs = colstat + slot * 3 * kTileRows;
      const int k = tile * kTileRows + gtid;
      if constexpr (kDx) {
        cs[gtid] = k < vocab ? b[k] : 0.f;
      } else {
        const bool ok = k < rows;
        reinterpret_cast<int*>(cs)[gtid] = ok ? labels[k] : -1;
        cs[kTileRows + gtid] = ok ? lse[k] * kLog2e : 0.f;
        cs[2 * kTileRows + gtid] = ok ? g[k] : 0.f;
      }
    }
  };
  // one streamed tile into ring slot `slot`, by the group's first thread
  auto load_tile = [&](int tile, int slot) {
    if (gtid == 0) {
      hopper::mbar_expect_tx(&ring_bar[slot], G::kTileBytes);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
        hopper::tma_load_2d(ring + slot * G::kTileBytes + a * G::kAtomBytes, stream_map,
                            &ring_bar[slot], a * G::kAtomCols, tile * kTileRows);
    }
  };

  float acc[G::kAccAtoms][G::kRegs];
#pragma unroll
  for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) acc[a][i] = 0.f;
  float db_part[2] = {0.f, 0.f};

  int done = 0;  // streamed tiles this group has consumed
  const int chunk = kDx ? n_tiles : kListChunk;
  for (int base = 0; base < n_tiles; base += chunk) {
    // the streamed tiles of this chunk: the vocab tiles (dx) or the row
    // tiles with a nonzero cotangent (dW/db), of which this block takes every
    // kParts-th from its rank on; group grp takes k = grp, grp + 2, ...
    const int total =
        kDx ? n_tiles : list_live_rows(g, rows, base, min(chunk, n_tiles - base), live);
    const int n = (total - part + kParts - 1) / kParts;
    auto tile_of = [&](int k) { return kDx ? part + kParts * k : live[part + kParts * k]; };
    const int n_grp = (n - grp + 1) / 2;
    for (int st = 0; st < G::kStages && st < n_grp; ++st) {
      const int slot = grp * G::kStages + (done + st) % G::kStages;
      stage_stats(tile_of(grp + 2 * st), slot);
      load_tile(tile_of(grp + 2 * st), slot);
    }
    group_sync(grp);  // the staged statistics are visible to the group
    if (base == 0) hopper::mbar_wait(own_bar, 0);

    for (int i = 0; i < n_grp; ++i) {
      const int slot = grp * G::kStages + (done + i) % G::kStages;
      hopper::mbar_wait(&ring_bar[slot], ((done + i) / G::kStages) & 1);
      const uint8_t* tile = ring + slot * G::kTileBytes;
      const float* cs = colstat + slot * 3 * kTileRows;

      float s[32];  // S = Own . Stream^T over the channels (K-major, both)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const int atom = 16 * kk / G::kAtomCols;
        const int in_row = 16 * kk % G::kAtomCols * 2;
        hopper::wgmma_ss_m64n64k16(
            s,
            hopper::make_desc(own + atom * G::kAtomBytes + in_row, G::kGroupBytes, G::kLayout),
            hopper::make_desc(tile + atom * G::kAtomBytes + in_row, G::kGroupBytes, G::kLayout),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // d = p.g - [label].g in place of s: s[4c + 2r + e] is (owned row
      // row_l + 8r, streamed column 8c + col_in_chunk + e). Nothing is
      // masked past R or V: there g is 0 (x's rows) or the tile's rows of x
      // or Wt are TMA's zeros, so d adds nothing to dx and dW, and dW and db
      // are not stored there.
      if constexpr (kDx) {  // rows of x, vocab columns
        const int t0 = tile_of(grp + 2 * i) * kTileRows;
        int label_at[2];  // the label's column in the tile, less col_in_chunk
#pragma unroll
        for (int r = 0; r < 2; ++r) label_at[r] = row_label[r] - t0 - col_in_chunk;
#pragma unroll
        for (int c = 0; c < kTileRows / 8; ++c) {
          const float2 bias = *reinterpret_cast<const float2*>(cs + 8 * c + col_in_chunk);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i_s = 4 * c + 2 * r + e;
              const float p = ex2((s[i_s] + (e ? bias.y : bias.x)) * kLog2e - row_a[r]);
              s[i_s] = fmaf(p, row_g[r], label_at[r] == 8 * c + e ? -row_g[r] : 0.f);
            }
        }
      } else {  // vocab rows, rows of x
#pragma unroll
        for (int c = 0; c < kTileRows / 8; ++c) {
          const int j = 8 * c + col_in_chunk;
          const int2 label = *reinterpret_cast<const int2*>(cs + j);
          const float2 lse2 = *reinterpret_cast<const float2*>(cs + kTileRows + j);
          const float2 gj = *reinterpret_cast<const float2*>(cs + 2 * kTileRows + j);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i_s = 4 * c + 2 * r + e;
              const float g_e = e ? gj.y : gj.x;
              const float p = ex2((s[i_s] + row_a[r]) * kLog2e - (e ? lse2.y : lse2.x));
              const float d = fmaf(p, g_e, (e ? label.y : label.x) == row_label[r] ? -g_e : 0.f);
              db_part[r] += d;
              s[i_s] = d;
            }
        }
      }
      uint32_t d_a[4][4];
      attn_tiles::to_fragments(s, d_a);
      hopper::wgmma_fence();  // acc += round(d) . Stream (the streamed tile MN-major)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int a = 0; a < G::kAccAtoms; ++a)
          hopper::wgmma_rs_tb<G::kRegs>(
              acc[a], d_a[kk],
              hopper::make_desc(tile + (acc_atom0 + a) * G::kAtomBytes + kk * 16 * G::kRowBytes,
                                G::kGroupBytes, G::kLayout));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < G::kAccAtoms; ++a) hopper::fence_regs(acc[a]);

      group_sync(grp);  // the group is done with this slot
      if (i + G::kStages < n_grp) {
        const int next = tile_of(grp + 2 * (i + G::kStages));
        stage_stats(next, slot);
        load_tile(next, slot);
        if constexpr (G::kStages == 1) group_sync(grp);  // read in the next iteration
      }
    }
    done += n_grp;
    __syncthreads();  // both groups are done with this chunk's list and rings
  }

  // The exchange, in the drained rings: group 1's accumulator to shared
  // memory, group 0 adds its own, then the cluster's block of rank 0 adds
  // its peer's sum (one fixed order) and stores.
  float* xch = reinterpret_cast<float*>(ring);
  if constexpr (kDx) {
    constexpr int kStride = G::kAccCols + 8;
    auto at = [&](int a, int c, int r) {
      return xch + (row_l + 8 * r) * kStride + a * G::kAtomCols + 8 * c + col_in_chunk;
    };
    if (grp == 1) {
#pragma unroll
      for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
        for (int c = 0; c < G::kAtomCols / 8; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(at(a, c, r)) =
                make_float2(acc[a][4 * c + 2 * r], acc[a][4 * c + 2 * r + 1]);
    }
    __syncthreads();
    if (grp == 0) {  // the block's sum, then the cluster's: rank 0's plus rank 1's
#pragma unroll
      for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
        for (int c = 0; c < G::kAtomCols / 8; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float2* x = reinterpret_cast<float2*>(at(a, c, r));
            *x = make_float2(acc[a][4 * c + 2 * r] + x->x, acc[a][4 * c + 2 * r + 1] + x->y);
          }
    }
    hopper::cluster_sync();  // every block's sum is in its shared memory
    if (grp == 0 && part == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = o0 + row_l + 8 * r;
        if (row >= rows) continue;
        __nv_bfloat16* out = dx + int64_t(row) * channels + c_lo;
#pragma unroll
        for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
          for (int c = 0; c < G::kAtomCols / 8; ++c) {
            const int col = a * G::kAtomCols + 8 * c + col_in_chunk;
            float2 sum = *reinterpret_cast<const float2*>(at(a, c, r));
#pragma unroll
            for (int peer = 1; peer < kParts; ++peer) {
              const float2 other = hopper::load_peer_f32x2(at(a, c, r), peer);
              sum.x += other.x;
              sum.y += other.y;
            }
            if (c_lo + col < channels)
              *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(sum.x, sum.y);
          }
      }
    }
    hopper::cluster_sync();  // rank 0 has read its peers' shared memory
  } else {
    float* db_x = xch + G::kAccCols * kDwStride;  // [64]: group 1's db, then the block's
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row sums over the quad's columns
      db_part[r] += __shfl_xor_sync(0xffffffffu, db_part[r], 1);
      db_part[r] += __shfl_xor_sync(0xffffffffu, db_part[r], 2);
    }
    auto at = [&](int a, int c, int r, int e) {
      return xch + (a * G::kAtomCols + 8 * c + col_in_chunk + e) * kDwStride + row_l + 8 * r;
    };
    if (grp == 1) {
#pragma unroll
      for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
        for (int c = 0; c < G::kAtomCols / 8; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) *at(a, c, r, e) = acc[a][4 * c + 2 * r + e];
      if (lane % 4 == 0) {
        db_x[row_l] = db_part[0];
        db_x[row_l + 8] = db_part[1];
      }
    }
    __syncthreads();
    if (grp == 0) {  // the block's sums
#pragma unroll
      for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
        for (int c = 0; c < G::kAtomCols / 8; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e) *at(a, c, r, e) += acc[a][4 * c + 2 * r + e];
      if (lane % 4 == 0) {
        db_x[row_l] += db_part[0];
        db_x[row_l + 8] += db_part[1];
      }
    }
    hopper::cluster_sync();  // every block's sums are in its shared memory
    if (part == 0) {  // rows of dW, coalesced, and db: rank 0's sums plus its peers'
      for (int i = tid; i < G::kAccCols * kTileRows / 2; i += kBlockThreads) {
        const int c = i / (kTileRows / 2), v = 2 * (i % (kTileRows / 2));
        const float* own_sum = xch + c * kDwStride + v;
        float2 sum = *reinterpret_cast<const float2*>(own_sum);
#pragma unroll
        for (int peer = 1; peer < kParts; ++peer) {
          const float2 other = hopper::load_peer_f32x2(own_sum, peer);
          sum.x += other.x;
          sum.y += other.y;
        }
        float* out = dw + int64_t(c_lo + c) * vocab + o0 + v;
        if (c_lo + c < channels && o0 + v < vocab) out[0] = sum.x;
        if (c_lo + c < channels && o0 + v + 1 < vocab) out[1] = sum.y;
      }
      if (blockIdx.y == 0 && tid < kTileRows / 2) {
        const int v = 2 * tid;
        float2 sum = *reinterpret_cast<const float2*>(db_x + v);
#pragma unroll
        for (int peer = 1; peer < kParts; ++peer) {
          const float2 other = hopper::load_peer_f32x2(db_x + v, peer);
          sum.x += other.x;
          sum.y += other.y;
        }
        if (o0 + v < vocab) db[o0 + v] = sum.x;
        if (o0 + v + 1 < vocab) db[o0 + v + 1] = sum.y;
      }
    }
    hopper::cluster_sync();  // rank 0 has read its peers' shared memory
  }
}

template <int kC>
__global__ void __cluster_dims__(1, 1, kParts) __launch_bounds__(kBlockThreads, 1)
linear_ce_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap wt_map,
                              const float* __restrict__ b, const int* __restrict__ labels,
                              const float* __restrict__ lse, const float* __restrict__ g,
                              __nv_bfloat16* __restrict__ dx, int rows, int channels, int vocab) {
  bwd_wgmma<kC, true>(&x_map, &wt_map, b, labels, lse, g, dx, nullptr, nullptr, rows, channels,
                      vocab);
}

template <int kC>
__global__ void __cluster_dims__(1, 1, kParts) __launch_bounds__(kBlockThreads, 1)
linear_ce_bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap wt_map,
                              const __grid_constant__ CUtensorMap x_map,
                              const float* __restrict__ b, const int* __restrict__ labels,
                              const float* __restrict__ lse, const float* __restrict__ g,
                              float* __restrict__ dw, float* __restrict__ db, int rows,
                              int channels, int vocab) {
  bwd_wgmma<kC, false>(&wt_map, &x_map, b, labels, lse, g, nullptr, dw, db, rows, channels,
                       vocab);
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

// 2-D bf16 tensor maps of x (R, C) and Wt (V, C): boxes of one swizzle atom
// of columns by 64 rows; columns past C and rows past R or V land as zeros
template <int kC>
bool encode_maps(const Args& a, CUtensorMap* x_map, CUtensorMap* wt_map) {
  const cuuint64_t x_dims[2] = {cuuint64_t(a.channels), cuuint64_t(a.rows)};
  const cuuint64_t wt_dims[2] = {cuuint64_t(a.channels), cuuint64_t(a.vocab)};
  const cuuint64_t stride[1] = {cuuint64_t(a.channels) * 2};
  const cuuint32_t box[2] = {cuuint32_t(Geo<kC>::kAtomCols), cuuint32_t(kTileRows)};
  return hopper::encode_bf16_map(x_map, 2, a.x, x_dims, stride, box) &&
         hopper::encode_bf16_map(wt_map, 2, a.wt, wt_dims, stride, box);
}

template <int kC, bool kDx>
cudaError_t launch_wgmma(const Args& a) {
  using G = Geo<kC>;
  CUtensorMap x_map, wt_map;
  if (a.wt == nullptr || !encode_maps<kC>(a, &x_map, &wt_map)) return cudaErrorInvalidValue;
  const dim3 grid(((kDx ? a.rows : a.vocab) + kTileRows - 1) / kTileRows, G::kSplit, kParts);
  if constexpr (kDx) {
    cudaError_t err = attn_tiles::set_smem(linear_ce_bwd_dx_wgmma_kernel<kC>, G::kSmem);
    if (err != cudaSuccess) return err;
    linear_ce_bwd_dx_wgmma_kernel<kC><<<grid, kBlockThreads, G::kSmem, a.stream>>>(
        x_map, wt_map, a.b, a.labels, a.lse, a.g, static_cast<__nv_bfloat16*>(a.dx), a.rows,
        a.channels, a.vocab);
  } else {
    cudaError_t err = attn_tiles::set_smem(linear_ce_bwd_dw_wgmma_kernel<kC>, G::kSmem);
    if (err != cudaSuccess) return err;
    linear_ce_bwd_dw_wgmma_kernel<kC><<<grid, kBlockThreads, G::kSmem, a.stream>>>(
        wt_map, x_map, a.b, a.labels, a.lse, a.g, a.dw, a.db, a.rows, a.channels, a.vocab);
  }
  return cudaGetLastError();
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
  if (width_class(a.channels) == 0) return cudaErrorInvalidValue;
  if (a.channels <= 16) return launch_wgmma<16, kDx>(a);
  if (a.channels <= 32) return launch_wgmma<32, kDx>(a);
  if (a.channels <= 64) return launch_wgmma<64, kDx>(a);
  if (a.channels <= 128) return launch_wgmma<128, kDx>(a);
  if (a.channels <= 256) return launch_wgmma<256, kDx>(a);
  return launch_wgmma<512, kDx>(a);
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
