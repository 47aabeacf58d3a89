// The bf16 design of the fused linear + cross-entropy kernels, on Hopper's
// tensor cores: one tile-and-ring body, ce_wgmma<kC, kMode>, in three modes,
// the forward (linear_ce_fwd.cu, loss and lse) and the backward's dx and
// dW/db kernels (linear_ce_bwd.cu).
//
// W is read as Wt = round(W)^T, a (V, C) bf16 tensor the wrapper makes once
// per train step, so x (R, C) and Wt are both K-major (C contiguous), read
// by 2-D TMA maps in swizzled 64-row tiles, and one shared-memory tile of
// either serves every product of a step. A block owns 64 rows of one of them
// (x for the forward and dx, Wt for dW/db), staged once by TMA, and streams
// its share of the other's 64-row tiles: the two blocks of a cluster (grid.z)
// take alternate tiles, and a block's two consumer warpgroups alternate
// again, each through its own TMA ring. Per streamed tile, S = Own.Stream^T
// is one SS wgmma over K = C (C = 8 zero-padded to 16 and C = 24 to 32 by
// TMA's out-of-bounds fill); then, by mode:
//   forward, per 64-row tile of x over the vocab tiles: the bias (staged per
//     tile; columns past V get pallas_ce.PAD_BIAS, -2e30, so they leave the
//     max and the sum exactly) makes the logits z, and each thread folds its
//     16 columns of its two rows into a running (max m, sum s, label logit):
//     m from the tile's max, s rescaled by exp(m_old - m) plus each
//     exp(z - m), one ex2.approx.ftz on z.log2(e) - m.log2(e) apiece. Only
//     the product and the exponentials: the accumulator is the 64 x 64 S
//     tile alone at every C (no channel split), and 64-column tiles at C <=
//     64 leave room for a four-stage ring and two blocks an SM, whose four
//     warpgroups overlap one another's products and exponentials.
//   dx, per 64-row tile of x: d = (p - [label]).g from lse in registers (the
//     bias staged per tile), rounded as the A operand of dx += d.Wt (RS, the
//     Wt tile as an MN-major B). A row tile whose g are all 0 writes exact
//     zeros and runs nothing.
//   dW/db, per 64-column vocab tile, in the transposed frame: d^T from S^T =
//     Wt.X^T (labels, lse and g of the row tile staged beside it), db += the
//     row sums of the unrounded d^T, dW^T += round(d^T).X (RS). Row tiles
//     whose g are all 0 are never loaded: each block lists the live ones
//     from g (a warp vote per tile, up to kListChunk at a time).
// Nothing is masked past R (x's rows there are TMA's zeros: the forward
// stores nothing for them, g is 0 in the backward) or, in the backward,
// past V (Wt's zero rows take d's term out of both products; dW and db are
// not stored there). The two warpgroups' partial results, then the
// cluster's two blocks', are combined in a fixed order through shared
// memory (the drained rings) and rank 0 reads its peer's through
// distributed shared memory: no atomics, results repeat bit for bit. A
// backward thread accumulates at most 256 channels (128 registers); at C =
// 512 the backward's channels split across two blocks (grid.y), each
// recomputing the logits.

#pragma once

#include <math.h>

#include "attention_tiles.cuh"
#include "linear_ce.cuh"

namespace linear_ce {
namespace {

enum class Mode { kFwd, kDx, kDw };

constexpr int kTileRows = 64;                 // rows of an owned or a streamed tile
constexpr int kGroups = 2;                    // consumer warpgroups of a block
constexpr int kGroupThreads = 128;
constexpr int kBlockThreads = kGroups * kGroupThreads;
constexpr int kListChunk = 256;               // row tiles the dW/db kernel lists at once
constexpr int kParts = 2;                     // blocks of a cluster, splitting the streamed tiles
constexpr int kDwStride = kTileRows + 4;      // floats between channels of the dW exchange
constexpr float kPadBias = 2.f * kMaskValue;  // pallas_ce.PAD_BIAS: the forward's columns past V

// The tiles of a width class kC: the channel count rounded up to 16, 32, 64,
// 128, 256 or 512, the columns past C zero-filled by TMA.
template <int kC, Mode kMode>
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
  // blocks along the channels: the backward's accumulator splits at C = 512
  static constexpr int kSplit = kMode == Mode::kFwd ? 1 : kAtoms / kAccAtoms;
  static constexpr int kRegs = kAtomCols / 2;                // accumulator floats per atom
  // ring stages per warpgroup: the forward consumes a tile faster (one
  // product), so it keeps more in flight where two blocks still fit an SM
  static constexpr int kStages =
      kMode == Mode::kFwd ? (kC <= 64 ? 4 : kC <= 256 ? 2 : 1) : (kC <= 256 ? 2 : 1);
  static constexpr int kRing = kGroups * kStages;            // streamed tiles in shared memory
  // 1024 bytes of alignment slack, the owned tile, the rings, the streamed
  // tiles' column statistics ([kRing][3][64] floats), the ring barriers and
  // the owned tile's, and the dW/db kernel's list of live row tiles
  static constexpr size_t kSmem = 1024 + size_t(kTileBytes) * (1 + kRing) +
                                  sizeof(float) * kRing * 3 * kTileRows +
                                  8 * (kRing + 1) + sizeof(int) * (kListChunk + 1);
  // the drained rings hold the exchange of the two warpgroups' results
  static_assert(sizeof(float) * kTileRows * (kAccCols + 8) <= size_t(kRing) * kTileBytes &&
                    sizeof(float) * (kAccCols * kDwStride + kTileRows) <=
                        size_t(kRing) * kTileBytes,
                "exchange buffer");
};

// The pointers and sizes of one launch. lse is the backward's input and the
// forward's output; each mode reads or writes only its own.
struct Io {
  const float* b;
  const int* labels;
  float* lse;
  const float* g;
  __nv_bfloat16* dx;
  float* dw;
  float* db;
  float* loss;
  int rows, channels, vocab;
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

// (m, s, picked) of a row merged with another part's: the larger max, each
// sum rescaled to it, the label logits added (at most one part holds it)
__device__ __forceinline__ void merge_row(float& m, float& s, float& picked, float m_o,
                                          float s_o, float picked_o) {
  using attn_tiles::kLog2e;
  const float m_new = fmaxf(m, m_o);
  s = s * ex2((m - m_new) * kLog2e) + s_o * ex2((m_o - m_new) * kLog2e);
  m = m_new;
  picked += picked_o;
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

// The body of the three bf16 kernels. The block owns 64 rows (o0 ..) of
// own_map's tensor (x for the forward and dx, Wt for dW/db) and streams
// 64-row tiles of stream_map's (its share of Wt's for the forward and dx,
// x's for dW/db): S = Own.Stream^T; the forward folds S into the rows'
// (m, s, picked), the backward forms d from S and adds round(d).Stream.
template <int kC, Mode kMode>
__device__ __forceinline__ void ce_wgmma(const CUtensorMap* own_map,
                                         const CUtensorMap* stream_map, const Io& io) {
  using G = Geo<kC, kMode>;
  using attn_tiles::kLog2e;
  constexpr bool kFwd = kMode == Mode::kFwd, kDx = kMode == Mode::kDx;
  constexpr bool kOwnX = kMode != Mode::kDw;  // x's rows owned, Wt's streamed
  const float* __restrict__ b = io.b;
  const int* __restrict__ labels = io.labels;
  const float* __restrict__ g = io.g;
  const int rows = io.rows, channels = io.channels, vocab = io.vocab;
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
  const int n_tiles = ((kOwnX ? vocab : rows) + kTileRows - 1) / kTileRows;
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
          *reinterpret_cast<__nv_bfloat162*>(io.dx + int64_t(r) * channels + c) = zero;
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

  // the owned rows' own statistics: forward, the label of x's rows; dx,
  // label, lse.log2(e) and g of x's rows; dW/db, the bias of W's columns (0
  // past V, where d is 0)
  int row_label[2];
  float row_a[2], row_g[2];
  bool row_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = o0 + row_l + 8 * r;
    row_a[r] = row_g[r] = 0.f;
    if constexpr (kOwnX) {
      row_valid[r] = o < rows;
      row_label[r] = row_valid[r] ? labels[o] : -1;
      if constexpr (kDx) {
        row_a[r] = row_valid[r] ? io.lse[o] * kLog2e : 0.f;
        row_g[r] = row_valid[r] ? g[o] : 0.f;
      }
    } else {
      row_valid[r] = o < vocab;
      row_label[r] = o;
      row_a[r] = row_valid[r] ? b[o] : 0.f;
    }
  }

  // one streamed tile's column statistics into slot `slot`, by the group's
  // first 64 threads: forward and dx, the bias of the tile's vocab columns
  // (past V: the forward's pad bias, dx's 0); dW/db, the label, lse.log2(e)
  // and g of its rows (past R: label -1, g 0)
  auto stage_stats = [&](int tile, int slot) {
    if (gtid < kTileRows) {
      float* cs = colstat + slot * 3 * kTileRows;
      const int k = tile * kTileRows + gtid;
      if constexpr (kOwnX) {
        cs[gtid] = k < vocab ? b[k] : (kFwd ? kPadBias : 0.f);
      } else {
        const bool ok = k < rows;
        reinterpret_cast<int*>(cs)[gtid] = ok ? labels[k] : -1;
        cs[kTileRows + gtid] = ok ? io.lse[k] * kLog2e : 0.f;
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

  float acc[G::kAccAtoms][G::kRegs];  // the backward's product
#pragma unroll
  for (int a = 0; a < G::kAccAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) acc[a][i] = 0.f;
  float db_part[2] = {0.f, 0.f};
  // the forward's running max, sum and label logit of each of the thread's rows
  float run_m[2] = {kMaskValue, kMaskValue}, run_s[2] = {0.f, 0.f}, picked[2] = {0.f, 0.f};

  int done = 0;  // streamed tiles this group has consumed
  const int chunk = kOwnX ? n_tiles : kListChunk;
  for (int base = 0; base < n_tiles; base += chunk) {
    // the streamed tiles of this chunk: the vocab tiles (forward, dx) or the
    // row tiles with a nonzero cotangent (dW/db), of which this block takes
    // every kParts-th from its rank on; group grp takes k = grp, grp + 2, ...
    const int total =
        kOwnX ? n_tiles : list_live_rows(g, rows, base, min(chunk, n_tiles - base), live);
    const int n = (total - part + kParts - 1) / kParts;
    auto tile_of = [&](int k) { return kOwnX ? part + kParts * k : live[part + kParts * k]; };
    const int n_grp = (n - grp + 1) / 2;
    for (int st = 0; st < G::kStages && st < n_grp; ++st) {
      const int slot = grp * G::kStages + (done + st) % G::kStages;
      stage_stats(tile_of(grp + 2 * st), slot);
      load_tile(tile_of(grp + 2 * st), slot);
    }
    group_sync(grp);  // the staged statistics are visible to the group
    if (base == 0) hopper::mbar_wait(own_bar, 0);

    auto slot_of = [&](int i) { return grp * G::kStages + (done + i) % G::kStages; };
    auto wait_tile = [&](int i) {
      hopper::mbar_wait(&ring_bar[slot_of(i)], ((done + i) / G::kStages) & 1);
    };
    // S = Own . Stream^T over the channels (K-major, both) for the tile in
    // ring slot `slot`, started: s[4c + 2r + e] is (owned row row_l + 8r,
    // streamed column 8c + col_in_chunk + e).
    auto product = [&](float (&s)[32], int slot) {
      const uint8_t* tile = ring + slot * G::kTileBytes;
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
    };
    // the group is done with tile i's slot: the tile kStages on goes there
    auto release = [&](int i) {
      group_sync(grp);
      if (i + G::kStages < n_grp) {
        const int next = tile_of(grp + 2 * (i + G::kStages));
        stage_stats(next, slot_of(i));
        load_tile(next, slot_of(i));
        if constexpr (G::kStages == 1) group_sync(grp);  // read in the next iteration
      }
    };
    // the forward: tile i's S (rows of x, vocab columns) folded into the
    // online (m, s, picked)
    auto fold = [&](float (&s)[32], int i) {
      const float* cs = colstat + slot_of(i) * 3 * kTileRows;
      const int t0 = tile_of(grp + 2 * i) * kTileRows;
      float tile_max[2] = {run_m[0], run_m[1]};
#pragma unroll
      for (int c = 0; c < kTileRows / 8; ++c) {
        const float2 bias = *reinterpret_cast<const float2*>(cs + 8 * c + col_in_chunk);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i_s = 4 * c + 2 * r + e;
            s[i_s] += e ? bias.y : bias.x;  // the logit, as x.round(W) + b
            tile_max[r] = fmaxf(tile_max[r], s[i_s]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the label's column is 8c + e of this thread's if j = 8c + e, e < 2
        const int j = row_label[r] - t0 - col_in_chunk;
        if (j >= 0 && j < kTileRows && (j & 6) == 0) {
#pragma unroll
          for (int c = 0; c < kTileRows / 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (j == 8 * c + e) picked[r] = s[4 * c + 2 * r + e];
        }
        const float m_l2 = tile_max[r] * kLog2e;
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < kTileRows / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum[e] += ex2(fmaf(s[4 * c + 2 * r + e], kLog2e, -m_l2));
        // (the difference first: at the floor m = -1e30 an fma's residual
        // alone would overflow ex2)
        run_s[r] = fmaf(run_s[r], ex2((run_m[r] - tile_max[r]) * kLog2e), sum[0] + sum[1]);
        run_m[r] = tile_max[r];
      }
    };

    for (int i = 0; i < n_grp; ++i) {
      wait_tile(i);
      float s[32];
      product(s, slot_of(i));
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if constexpr (kFwd) {
        fold(s, i);
      } else {
        const uint8_t* tile = ring + slot_of(i) * G::kTileBytes;
        const float* cs = colstat + slot_of(i) * 3 * kTileRows;
        // d = p.g - [label].g in place of s. Nothing is masked past R or V:
        // there g is 0 (x's rows) or the tile's rows of x or Wt are TMA's
        // zeros, so d adds nothing to dx and dW, and dW and db are not stored
        // there.
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
                const float d =
                    fmaf(p, g_e, (e ? label.y : label.x) == row_label[r] ? -g_e : 0.f);
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
      }
      release(i);
    }
    done += n_grp;
    __syncthreads();  // both groups are done with this chunk's list and rings
  }

  // The exchange, in the drained rings: group 1's results to shared memory,
  // group 0 adds its own, then the cluster's block of rank 0 adds its peer's
  // (one fixed order) and stores.
  float* xch = reinterpret_cast<float*>(ring);
  if constexpr (kFwd) {
    // the row's four threads (a quad) merge their (m, s, picked); xch holds
    // (m, s, picked, 0) of each of the 64 rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int off = 1; off < 4; off *= 2)
        merge_row(run_m[r], run_s[r], picked[r], __shfl_xor_sync(0xffffffffu, run_m[r], off),
                  __shfl_xor_sync(0xffffffffu, run_s[r], off),
                  __shfl_xor_sync(0xffffffffu, picked[r], off));
    const bool quad_lead = lane % 4 == 0;
    if (grp == 1 && quad_lead) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(xch + 4 * (row_l + 8 * r)) =
            make_float4(run_m[r], run_s[r], picked[r], 0.f);
    }
    __syncthreads();
    if (grp == 0 && quad_lead) {  // the block's rows
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float4* x = reinterpret_cast<float4*>(xch + 4 * (row_l + 8 * r));
        const float4 other = *x;
        merge_row(run_m[r], run_s[r], picked[r], other.x, other.y, other.z);
        *x = make_float4(run_m[r], run_s[r], picked[r], 0.f);
      }
    }
    hopper::cluster_sync();  // every block's rows are in its shared memory
    if (grp == 0 && quad_lead && part == 0) {  // the cluster's: rank 0's, then its peers'
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* at = xch + 4 * (row_l + 8 * r);
#pragma unroll
        for (int peer = 1; peer < kParts; ++peer) {
          const float2 ms = hopper::load_peer_f32x2(at, peer);
          const float2 p0 = hopper::load_peer_f32x2(at + 2, peer);
          merge_row(run_m[r], run_s[r], picked[r], ms.x, ms.y, p0.x);
        }
        const int row = o0 + row_l + 8 * r;
        if (row < rows) {
          const float row_lse = run_m[r] + logf(run_s[r]);
          io.lse[row] = row_lse;
          io.loss[row] = row_lse - picked[r];
        }
      }
    }
    hopper::cluster_sync();  // rank 0 has read its peers' shared memory
  } else if constexpr (kDx) {
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
        __nv_bfloat16* out = io.dx + int64_t(row) * channels + c_lo;
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
        float* out = io.dw + int64_t(c_lo + c) * vocab + o0 + v;
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
        if (o0 + v < vocab) io.db[o0 + v] = sum.x;
        if (o0 + v + 1 < vocab) io.db[o0 + v + 1] = sum.y;
      }
    }
    hopper::cluster_sync();  // rank 0 has read its peers' shared memory
  }
}

// 2-D bf16 tensor maps of x (R, C) and Wt (V, C): boxes of one swizzle atom
// of columns by 64 rows; columns past C and rows past R or V land as zeros
template <int kC>
bool encode_maps(const void* x, const void* wt, const Io& io, CUtensorMap* x_map,
                 CUtensorMap* wt_map) {
  const cuuint64_t x_dims[2] = {cuuint64_t(io.channels), cuuint64_t(io.rows)};
  const cuuint64_t wt_dims[2] = {cuuint64_t(io.channels), cuuint64_t(io.vocab)};
  const cuuint64_t stride[1] = {cuuint64_t(io.channels) * 2};
  const cuuint32_t box[2] = {cuuint32_t(Geo<kC, Mode::kFwd>::kAtomCols), cuuint32_t(kTileRows)};
  return hopper::encode_bf16_map(x_map, 2, x, x_dims, stride, box) &&
         hopper::encode_bf16_map(wt_map, 2, wt, wt_dims, stride, box);
}

// Launches `kernel`, a __global__ wrapper of ce_wgmma<kC, kMode> taking
// (own map, streamed map, io), over x (R, C) and Wt (V, C) bf16: a block per
// 64 owned rows (and per channel half, grid.y, in the backward at C = 512),
// clusters of kParts along grid.z
template <int kC, Mode kMode, typename Kernel>
cudaError_t launch_ce_wgmma(Kernel kernel, const void* x, const void* wt, const Io& io,
                            cudaStream_t stream) {
  using G = Geo<kC, kMode>;
  constexpr bool kOwnX = kMode != Mode::kDw;
  CUtensorMap x_map, wt_map;
  if (wt == nullptr || !encode_maps<kC>(x, wt, io, &x_map, &wt_map)) return cudaErrorInvalidValue;
  const cudaError_t err = attn_tiles::set_smem(kernel, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((kOwnX ? io.rows : io.vocab) + kTileRows - 1) / kTileRows, G::kSplit, kParts);
  if constexpr (kOwnX) {
    kernel<<<grid, kBlockThreads, G::kSmem, stream>>>(x_map, wt_map, io);
  } else {
    kernel<<<grid, kBlockThreads, G::kSmem, stream>>>(wt_map, x_map, io);
  }
  return cudaGetLastError();
}

// the wgmma width class of C: C rounded up to 16, 32, 64, 128, 256 or 512,
// or 0 when C is not a multiple of 8 up to 512
inline int wgmma_width(int channels) {
  if (width_class(channels) == 0) return 0;
  for (int w = 16;; w *= 2)
    if (channels <= w) return w;
}

}  // namespace
}  // namespace linear_ce
