// Fused multi-head attention backward for the Perceiver latent attention,
// written by hand for Hopper (sm_90a): one kernel for dq, one for dk and dv.
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_bwd_impl,
// Pallas kernels _bwd_dq_kernel (dq) and _bwd_dkv_kernel (dk, dv), with
// _recompute_probs_and_ds, with or without causal_offset (_causal_bias).
//
// Computes, per (batch b, head h), from the forward's saved row statistics
// m (running max) and l (denominator) and delta[t] = sum_d g[t,d] * out[t,d]:
//   logit[t,s] = q[t] . k[s] * D^-0.5 + bias[b,s]        (bias after the scale)
//                + causal[t,s]  (with the causal flag: -1e30 where key
//                               s > t + causal_offset, t the GLOBAL query row,
//                               added by index after the pad bias)
//   p[t,s]     = exp(logit[t,s] - m[t]) / l[t]
//   ds[t,s]    = p[t,s] * (g[t] . v[s] - delta[t]), and 0 on a row whose m is
//                pinned at the mask value (m <= -0.5e30: every key masked)
//   dq[t] = D^-0.5 * sum_s ds[t,s] * k[s]    (ds rounded to k's dtype first)
//   dk[s] = D^-0.5 * sum_t ds[t,s] * q[t]    (ds rounded to q's dtype first)
//   dv[s] =          sum_t p[t,s]  * g[t]    (p rounded to g's dtype first)
// exactly as the TPU kernels do: f32 logits and accumulators, the scale
// applied at the end, outputs in the input dtype. p stays intact on a fully
// masked row (uniform 1/S), so dv keeps that row's uniform contribution
// while dq and dk get none, the where-masked gradient of the einsum path.
// With the causal flag, a row whose visible keys are all padding has m at
// -1e30 too: its p is uniform over the keys masked exactly once (a key
// masked twice scores -2e30, p = 0), so dv keeps that share, and its ds is
// zeroed. The causal bias is a template argument (kCausal), compiled in only
// for a causal call, so a call without it runs the code it ran before; no
// tile past the diagonal is skipped (the forward skips none either).
//
// What bounds it on the H100: at the training shapes (the encoder
// cross-attention B=64, T=256, S=512, H=4, D=128 in bf16) the two kernels
// recompute the logits and g.v^T in both passes, seven products of
// 2.B.H.T.S.D (60 GFLOP) against 201 MB of q, k, v, out, g, dq, dk, dv;
// the least time is the bytes at 3.35 TB/s (60 us), the five products the
// function needs at 989 TF/s close behind (43 us). Where keys are padding
// (the flagship encoder's rows are mostly padding), the bf16 design skips
// them whole tiles at a time, so the work follows the valid keys.
//
// Two designs, chosen by dtype (not a fallback). Both are two launches,
// each deterministic (no atomics) and owning its outputs outright, so no
// block ever sums into another's, as the TPU kernel's two pallas_calls.
//
// - float32: exact f32, scalar FMAs (wgmma has no full-f32 mode; the f32
//   parity bar needs exact products). dq kernel: one block per (64-query
//   tile, head, batch), 256 threads, four per query row; the q and g tiles
//   stay in shared memory, the block loops over 64-key K/V tiles, each
//   thread recomputes p and ds for 16 of the tile's keys, passes ds to its
//   row's other three threads through a per-row shared strip, and
//   accumulates D/4 columns of dq in registers. dk/dv kernel: one block per
//   (64-key tile, head, batch), the same with keys and queries swapped, the
//   query tile's m, l and delta staged beside q and g. Tiles are staged as
//   f32 with row stride D+1, so column reads hit distinct banks; rows past
//   the end of T or S are staged as zeros and contribute 0.
//
// - bfloat16: tensor cores. Each block owns 128 rows (two consumer
//   warpgroups of 64) and streams 64-row tiles of the other side through a
//   two-stage TMA ring (mbarriers), in swizzled layouts (rows of 32, 64 or
//   128 bytes; D=128 as two 64-column atoms; D=8 zero-padded to 16 by TMA's
//   out-of-bounds fill), as the forward's bf16 design does. Every product
//   is a wgmma with f32 accumulators in registers:
//   dq kernel, per (128-query tile, head, batch): q and g staged once; for
//     each 64-key tile S = Q.K^T and dP = G.V^T (SS, K and V K-major since
//     D is contiguous), p and ds in registers (keys past S masked by index:
//     TMA's zero rows would score 0, not -1e30), ds to bf16 in registers as
//     the A operand, and dq += ds.K (RS, K as an MN-major B: the forward's
//     P.V with K for V). Key tiles whose bias is all -1e30 are skipped: at
//     such keys p is exactly 0 (in f32, -1e30 + logit - m rounds to -1e30)
//     on every row with a valid key, and ds is zeroed on a fully masked row
//     (with the causal flag too: a row with a visible valid key gives p = 0
//     at every padded key, and a row without one has m at -1e30, ds = 0).
//     The live tiles are listed once per block from the bias row before the
//     first load, so the ring streams only those.
//   dk/dv kernel, per (128-key tile, head, batch), in the transposed frame so
//     that no tile needs a shared-memory transpose: k and v staged once; for
//     each 64-query tile S^T = K.Q^T and dP^T = V.G^T (SS, Q and G K-major),
//     p^T and ds^T in registers with the query tile's m, 1/l and delta
//     staged in shared memory (they vary along the accumulator's columns;
//     queries past T masked by index, their statistics never read), then
//     dv += p^T.G and dk += ds^T.Q (RS, G and Q as MN-major B). A warpgroup
//     whose 64 keys are all padding computes nothing (dk = dv = 0 there),
//     but only when query row 0 has a valid key (m[b, h, 0] > -0.5e30).
//     Without the causal flag every row of an example sees the same keys;
//     with it row t sees keys <= t + offset, a superset of row 0's, so a
//     valid key of row 0 is one of every row: every row then has p = 0 at
//     the padded keys, and their dk and dv are exactly 0. Otherwise (a fully
//     masked example, or a causal one whose first rows see only padding) the
//     warpgroup runs the full path, where those rows' p is uniform over the
//     keys masked exactly once and dv keeps that share of g. A block with no
//     computing warpgroup writes its zeros and loads nothing.
//   Registers: at D=128 a dk/dv thread holds two 64x128 f32 accumulators
//   (128 registers) beside S^T and dP^T (64), hence 64-row streamed tiles.

#include "attention_deep.cuh"
#include "attention_tiles.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using namespace attn_tiles;

constexpr float kMaskValue = -1e30f;  // pallas_attention.MASK_VALUE

struct Strides {  // (batch, row, head) strides in elements of q, k, v, g
  int64_t qb, qt, qh, kb, ks, kh, vb, vs, vh, gb, gt, gh;
};

// ---------------------------------------------------------------------------
// float32: the exact scalar design
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                 // rows (queries or keys) a block owns
constexpr int kTile = 64;                 // rows of the tile the block loops over
constexpr int kLanes = 4;                 // threads per owned row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kPerLane = kTile / kLanes;  // tile rows each thread scores

// rows [r0, r0 + kRows) of a (.., n, ., D) operand with row stride `rs` into
// an f32 [kRows][D + 1] tile; rows at or past n become zeros
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* src, int64_t rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * (D + 1) + d] = r0 + r < n ? src[(r0 + r) * rs + d] : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {  // q, g, k, v tiles + ds strip + bias
  return sizeof(float) * (4 * size_t(kRows) * (D + 1) + size_t(kRows) * (kTile + 1) + kTile);
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // k, v, q, g tiles + p and ds strips + m, l, delta
  return sizeof(float) * (4 * size_t(kRows) * (D + 1) + 2 * size_t(kRows) * (kTile + 1) +
                          3 * kTile);
}

// kCausal: the causal bias is compiled in only where it is asked for, so a
// call without it runs the exact code it ran before the causal offset
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ m,
                        const float* __restrict__ l, const float* __restrict__ delta,
                        float* __restrict__ dq, int t_len, int s_len, int heads,
                        int causal_offset, Strides st, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  constexpr int kCols = D / kLanes;
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][DP]
  float* gs = qs + kRows * DP;   // [kRows][DP]
  float* ks = gs + kRows * DP;   // [kTile][DP]
  float* vs = ks + kTile * DP;   // [kTile][DP]
  float* dss = vs + kTile * DP;  // [kRows][PP]
  float* bs = dss + kRows * PP;  // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = t0 + row;

  stage<D>(qs, q + b * st.qb + h * st.qh, st.qt, t0, t_len);
  stage<D>(gs, g + b * st.gb + h * st.gh, st.gt, t0, t_len);
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const float* biasb = bias + int64_t(b) * s_len;

  const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
  const bool live = t < t_len;
  const float m_t = live ? m[stat] : 0.f;
  const float l_t = live ? l[stat] : 1.f;
  const float delta_t = live ? delta[stat] : 0.f;
  const bool masked_row = !live || m_t <= 0.5f * kMaskValue;
  const int key_limit = t + causal_offset;  // the last key the row sees unmasked by causality

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage<D>(ks, kb, st.ks, s0, s_len);
    stage<D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * DP + d];
      const float gd = gs[row * DP + d];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + i * kLanes;
        s[i] = fmaf(qd, ks[j * DP + d], s[i]);
        dp[i] = fmaf(gd, vs[j * DP + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      float x = s[i] * scale + bs[j];
      if (kCausal && s0 + j > key_limit) x += kMaskValue;
      const float p = expf(x - m_t) / l_t;
      dss[row * PP + j] = (masked_row || j >= n) ? 0.f : p * (dp[i] - delta_t);
    }
    __syncwarp();  // the row's four threads see each other's ds

    for (int j = 0; j < n; ++j) {
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(ds, ks[j * DP + lane + i * kLanes], acc[i]);
    }
  }

  if (live) {
    float* o = dq + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[lane + i * kLanes] = acc[i] * scale;
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ m,
                         const float* __restrict__ l, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
                         int heads, int causal_offset, Strides st, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  constexpr int kCols = D / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;              // [kRows][DP]
  float* vs = ks + kRows * DP;   // [kRows][DP]
  float* qs = vs + kRows * DP;   // [kTile][DP]
  float* gs = qs + kTile * DP;   // [kTile][DP]
  float* ps = gs + kTile * DP;   // [kRows][PP]
  float* dss = ps + kRows * PP;  // [kRows][PP]
  float* ms = dss + kRows * PP;  // [kTile]
  float* ls = ms + kTile;        // [kTile]
  float* des = ls + kTile;       // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int s0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s_idx = s0 + row;

  stage<D>(ks, k + b * st.kb + h * st.kh, st.ks, s0, s_len);
  stage<D>(vs, v + b * st.vb + h * st.vh, st.vs, s0, s_len);
  const float* qb = q + b * st.qb + h * st.qh;
  const float* gb = g + b * st.gb + h * st.gh;
  const int64_t stat0 = (int64_t(b) * heads + h) * t_len;
  const float bias_s = s_idx < s_len ? bias[int64_t(b) * s_len + s_idx] : 0.f;

  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int n = min(kTile, t_len - t0);
    __syncthreads();  // the previous tile is consumed (and the k, v tiles stored)
    stage<D>(qs, qb, st.qt, t0, t_len);
    stage<D>(gs, gb, st.gt, t0, t_len);
    if (tid < kTile) {
      const bool live = tid < n;
      ms[tid] = live ? m[stat0 + t0 + tid] : 0.f;
      ls[tid] = live ? l[stat0 + t0 + tid] : 1.f;
      des[tid] = live ? delta[stat0 + t0 + tid] : 0.f;
    }
    __syncthreads();

    float s[kPerLane], dp[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[row * DP + d];
      const float vd = vs[row * DP + d];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int j = lane + i * kLanes;
        s[i] = fmaf(qs[j * DP + d], kd, s[i]);
        dp[i] = fmaf(gs[j * DP + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      const float m_j = ms[j];
      float x = s[i] * scale + bias_s;
      if (kCausal && s_idx > t0 + j + causal_offset) x += kMaskValue;  // key past the row's limit
      const float p = j < n ? expf(x - m_j) / ls[j] : 0.f;
      ps[row * PP + j] = p;
      dss[row * PP + j] = m_j <= 0.5f * kMaskValue ? 0.f : p * (dp[i] - des[j]);
    }
    __syncwarp();  // the row's four threads see each other's p and ds

    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = lane + i * kLanes;
        dv_acc[i] = fmaf(p, gs[j * DP + c], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[j * DP + c], dk_acc[i]);
      }
    }
  }

  if (s_idx < s_len) {
    const int64_t o = ((int64_t(b) * s_len + s_idx) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      dk[o + lane + i * kLanes] = dk_acc[i] * scale;
      dv[o + lane + i * kLanes] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma design
// ---------------------------------------------------------------------------

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap g_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ bias, const float* __restrict__ m,
                              const float* __restrict__ l, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int t_len, int s_len, int heads,
                              int causal_offset, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qs = smem;                                  // [atom][kOwnRows rows]
  uint8_t* gs = qs + G::kOwnBytes;
  uint8_t* ks = gs + G::kOwnBytes;                     // [stage][atom][kStreamRows rows]
  uint8_t* vs = ks + kStages * G::kStreamBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(vs + kStages * G::kStreamBytes);
  uint64_t* own_bar = ring_bar + kStages;
  int* live = reinterpret_cast<int*>(own_bar + 1);     // [n_tiles + 1]: live key tiles, count

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * kOwnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (s_len + kStreamRows - 1) / kStreamRows;
  const float* bias_b = bias + int64_t(b) * s_len;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&ring_bar[st], 1);
    hopper::mbar_init(own_bar, 1);
    hopper::fence_barrier_init();
  }
  const int n_live = list_live_tiles(bias_b, s_len, n_tiles, live, false);
  if (tid == 0 && n_live > 0) {
    load_own<D>(&q_map, &g_map, qs, gs, own_bar, t0, h, b);
    for (int st = 0; st < kStages && st < n_live; ++st)
      load_stream<D>(&k_map, &v_map, ks, vs, ring_bar, live[st], st, h, b);
  }

  // this thread's accumulator rows: r = 0 and r = 1 (eight apart)
  const int row0 = t0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + wg * kWgRows < t_len;
  // the last key each of this thread's two rows sees unmasked by the causal bias
  const int key_limit[2] = {row0 + causal_offset, row0 + 8 + causal_offset};
  float m_r[2], inv_l[2], delta_r[2];
  bool zero_ds[2];  // a row past T, or one whose keys are all masked
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const bool valid = t < t_len;
    const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
    m_r[r] = valid ? m[stat] : 0.f;
    inv_l[r] = valid ? 1.f / l[stat] : 0.f;
    delta_r[r] = valid ? delta[stat] : 0.f;
    zero_ds[r] = !valid || m_r[r] <= 0.5f * kMaskValue;
  }

  float acc[G::kAtoms][G::kRegs];
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) acc[a][i] = 0.f;

  if (active && n_live > 0) hopper::mbar_wait(own_bar, 0);
  for (int j = 0; j < n_live; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
      const uint8_t* k_tile = ks + stage * G::kStreamBytes;
      const uint8_t* v_tile = vs + stage * G::kStreamBytes;
      float s[32], dp[32];
      hopper::wgmma_fence();
      tile_product<D>(s, qs, wg, k_tile);  // S = Q . K^T
      tile_product<D>(dp, gs, wg, v_tile);  // dP = G . V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // ds in place of s; keys past S masked by index, the causal bias by
      // index after the pad bias
      const int s0 = live[j] * kStreamRows;
#pragma unroll
      for (int c = 0; c < kStreamRows / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = s0 + 8 * c + col_in_chunk + e;
          const bool valid = key < s_len;
          const float bj = valid ? bias_b[key] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * c + 2 * r + e;
            float x = s[i] * scale + bj;
            if (kCausal && key > key_limit[r]) x += kMaskValue;
            const float p = valid ? exp2f((x - m_r[r]) * kLog2e) * inv_l[r] : 0.f;
            s[i] = zero_ds[r] ? 0.f : p * (dp[i] - delta_r[r]);
          }
        }
      }
      uint32_t ds_a[4][4];
      to_fragments(s, ds_a);
      hopper::wgmma_fence();
      accumulate<D>(acc, ds_a, k_tile);  // dq += ds . K
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      wait_acc<D>(acc);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_live)
      load_stream<D>(&k_map, &v_map, ks, vs, ring_bar, live[j + kStages], stage, h, b);
  }

  if (active) store_rows<D>(acc, dq, row0, t_len, heads, h, b, scale);
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap g_map,
                               const float* __restrict__ bias, const float* __restrict__ m,
                               const float* __restrict__ l, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int t_len, int s_len, int heads, int causal_offset,
                               float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ks = smem;                                  // [atom][kOwnRows rows]
  uint8_t* vs = ks + G::kOwnBytes;
  uint8_t* qs = vs + G::kOwnBytes;                     // [stage][atom][kStreamRows rows]
  uint8_t* gs = qs + kStages * G::kStreamBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(gs + kStages * G::kStreamBytes);
  uint64_t* own_bar = ring_bar + kStages;
  float* stats = reinterpret_cast<float*>(own_bar + 1);  // [stage][m, 1/l, delta][kStreamRows]
  int* wg_live = reinterpret_cast<int*>(stats + kStages * 3 * kStreamRows);  // [2]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int s0 = blockIdx.x * kOwnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_len + kStreamRows - 1) / kStreamRows;
  const int64_t stat0 = (int64_t(b) * heads + h) * t_len;
  const float* bias_b = bias + int64_t(b) * s_len;

  // the statistics of query tile `tile` into ring stage `stage`; queries
  // past T are never read
  auto stage_stats = [&](int tile, int stage) {
    if (tid < kStreamRows) {
      const int t = tile * kStreamRows + tid;
      const bool valid = t < t_len;
      float* slot = stats + stage * 3 * kStreamRows;
      slot[tid] = valid ? m[stat0 + t] : 0.f;
      slot[kStreamRows + tid] = valid ? 1.f / l[stat0 + t] : 0.f;
      slot[2 * kStreamRows + tid] = valid ? delta[stat0 + t] : 0.f;
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&ring_bar[st], 1);
    hopper::mbar_init(own_bar, 1);
    hopper::fence_barrier_init();
  }
  if (tid < 2) wg_live[tid] = 0;
  for (int st = 0; st < kStages && st < n_tiles; ++st) stage_stats(st, st);
  __syncthreads();
  {  // does the warpgroup own a key that is not padding? (two threads a key)
    const int key = s0 + wg * kWgRows + tid % kWgRows;
    if (key < s_len && bias_b[key] > 0.5f * kMaskValue) wg_live[wg] = 1;
  }
  __syncthreads();
  // all-padding keys give dk = dv = 0 exactly where query row 0 has a valid
  // key (then every row has one: a causal row sees a superset of row 0's
  // keys); otherwise the full path runs (p uniform over the keys masked once)
  const bool example_live = t_len > 0 && m[stat0] > 0.5f * kMaskValue;
  const bool computes0 = s0 < s_len && (wg_live[0] || !example_live);
  const bool computes1 = s0 + kWgRows < s_len && (wg_live[1] || !example_live);
  const bool active = wg == 0 ? computes0 : computes1;
  const bool block_active = computes0 || computes1;
  if (tid == 0 && block_active) {
    load_own<D>(&k_map, &v_map, ks, vs, own_bar, s0, h, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      load_stream<D>(&q_map, &g_map, qs, gs, ring_bar, st, st, h, b);
  }

  // this thread's accumulator rows (keys): r = 0 and r = 1 (eight apart)
  const int row0 = s0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);
  float bias_r[2];
  bool key_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_valid[r] = row0 + 8 * r < s_len;
    bias_r[r] = key_valid[r] ? bias_b[row0 + 8 * r] : 0.f;
  }

  float dk_acc[G::kAtoms][G::kRegs], dv_acc[G::kAtoms][G::kRegs];
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;

  if (block_active) {
    if (active) hopper::mbar_wait(own_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      if (active) {
        hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
        const uint8_t* q_tile = qs + stage * G::kStreamBytes;
        const uint8_t* g_tile = gs + stage * G::kStreamBytes;
        const float* st_m = stats + stage * 3 * kStreamRows;
        const float* st_inv_l = st_m + kStreamRows;
        const float* st_delta = st_inv_l + kStreamRows;
        float x[32], dp[32];
        hopper::wgmma_fence();
        tile_product<D>(x, ks, wg, q_tile);   // S^T = K . Q^T
        tile_product<D>(dp, vs, wg, g_tile);  // dP^T = V . G^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(x);
        hopper::fence_regs(dp);

        // p^T in place of x, ds^T in place of dp; queries past T masked by
        // index, the causal bias by index after the pad bias
        const int q0 = j * kStreamRows;
#pragma unroll
        for (int c = 0; c < kStreamRows / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * c + col_in_chunk + e;
            const bool valid = q0 + col < t_len;
            const float m_c = st_m[col];
            const bool zero_ds = !valid || m_c <= 0.5f * kMaskValue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * c + 2 * r + e;
              float logit = x[i] * scale + bias_r[r];
              if (kCausal && row0 + 8 * r > q0 + col + causal_offset) logit += kMaskValue;
              const float p = valid && key_valid[r]
                                  ? exp2f((logit - m_c) * kLog2e) * st_inv_l[col]
                                  : 0.f;
              dp[i] = zero_ds ? 0.f : p * (dp[i] - st_delta[col]);
              x[i] = p;
            }
          }
        }
        uint32_t p_a[4][4], ds_a[4][4];
        to_fragments(x, p_a);
        to_fragments(dp, ds_a);
        hopper::wgmma_fence();
        accumulate<D>(dv_acc, p_a, g_tile);   // dv += p^T . G
        accumulate<D>(dk_acc, ds_a, q_tile);  // dk += ds^T . Q
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        wait_acc<D>(dv_acc);
        wait_acc<D>(dk_acc);
      }
      __syncthreads();  // both warpgroups are done with this stage
      if (j + kStages < n_tiles) {
        stage_stats(j + kStages, stage);  // read after the next iteration's barrier
        if (tid == 0)
          load_stream<D>(&q_map, &g_map, qs, gs, ring_bar, j + kStages, stage, h, b);
      }
    }
  }

  if (s0 + wg * kWgRows < s_len) {  // a skipped warpgroup writes its zeros
    store_rows<D>(dk_acc, dk, row0, s_len, heads, h, b, scale);
    store_rows<D>(dv_acc, dv, row0, s_len, heads, h, b, 1.f);
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *bias, *m, *l, *delta;
  void *dq, *dk, *dv;
  int batch, t_len, s_len, heads, causal, causal_offset;
  Strides st;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  const auto kernel =
      a.causal ? attention_bwd_dq_kernel<D, true> : attention_bwd_dq_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.bias, a.m, a.l, a.delta,
      static_cast<float*>(a.dq), a.t_len, a.s_len, a.heads, a.causal_offset, a.st,
      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  const auto kernel =
      a.causal ? attention_bwd_dkv_kernel<D, true> : attention_bwd_dkv_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + kRows - 1) / kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.bias, a.m, a.l, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.t_len, a.s_len, a.heads,
      a.causal_offset, a.st, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// The four TMA maps of the wgmma design: q and g (T rows), k and v (S rows),
// boxes of one swizzle atom of columns and `q_rows` or `k_rows` rows
template <int D>
bool encode_maps(const Args& a, int q_rows, int k_rows, CUtensorMap* q_map, CUtensorMap* g_map,
                 CUtensorMap* k_map, CUtensorMap* v_map) {
  constexpr int cols = Geometry<D>::kAtomCols;
  const Strides& st = a.st;
  const int64_t sq[3] = {st.qb, st.qt, st.qh}, sg[3] = {st.gb, st.gt, st.gh};
  const int64_t sk[3] = {st.kb, st.ks, st.kh}, sv[3] = {st.vb, st.vs, st.vh};
  return hopper::encode_head_map(q_map, a.q, a.batch, a.t_len, a.heads, D, sq, cols, q_rows) &&
         hopper::encode_head_map(g_map, a.g, a.batch, a.t_len, a.heads, D, sg, cols, q_rows) &&
         hopper::encode_head_map(k_map, a.k, a.batch, a.s_len, a.heads, D, sk, cols, k_rows) &&
         hopper::encode_head_map(v_map, a.v, a.batch, a.s_len, a.heads, D, sv, cols, k_rows);
}

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode_maps<D>(a, kOwnRows, kStreamRows, &q_map, &g_map, &k_map, &v_map))
    return cudaErrorInvalidValue;
  const int n_tiles = (a.s_len + kStreamRows - 1) / kStreamRows;
  const size_t smem = Geometry<D>::kSmem + sizeof(int) * (n_tiles + 1);  // + the live list
  const auto kernel = a.causal ? attention_bwd_dq_wgmma_kernel<D, true>
                               : attention_bwd_dq_wgmma_kernel<D, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kOwnRows - 1) / kOwnRows, a.heads, a.batch);
  kernel<<<grid, kWgThreads, smem, a.stream>>>(
      q_map, g_map, k_map, v_map, a.bias, a.m, a.l, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.t_len, a.s_len, a.heads, a.causal_offset, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a) {
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode_maps<D>(a, kStreamRows, kOwnRows, &q_map, &g_map, &k_map, &v_map))
    return cudaErrorInvalidValue;
  // + the statistics ring and the two warpgroups' flags
  const size_t smem = Geometry<D>::kSmem + sizeof(float) * kStages * 3 * kStreamRows +
                      2 * sizeof(int);
  const auto kernel = a.causal ? attention_bwd_dkv_wgmma_kernel<D, true>
                               : attention_bwd_dkv_wgmma_kernel<D, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + kOwnRows - 1) / kOwnRows, a.heads, a.batch);
  kernel<<<grid, kWgThreads, smem, a.stream>>>(
      k_map, v_map, q_map, g_map, a.bias, a.m, a.l, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.t_len, a.s_len, a.heads, a.causal_offset,
      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// the arguments as the deep designs (attention_deep.cu) take them
attn_deep::BwdArgs deep_args(const Args& a) {
  const Strides& s = a.st;
  return attn_deep::BwdArgs{a.q, a.k, a.v, a.g, a.bias, a.m, a.l, a.delta, a.dq, a.dk, a.dv,
                            a.batch, a.t_len, a.s_len, a.heads, a.causal, a.causal_offset,
                            {s.qb, s.qt, s.qh, s.kb, s.ks, s.kh, s.vb, s.vs, s.vh, s.gb, s.gt,
                             s.gh},
                            a.stream};
}

// dtype 0 (float32) runs the scalar design, 1 (bfloat16) the wgmma design;
// head dims 256 and 512 go to the deep designs
template <bool kDq>
int dispatch(int dtype, int head_dim, const Args& a) {
  if ((dtype != 0 && dtype != 1) || (a.causal != 0 && a.causal != 1))
    return cudaErrorInvalidValue;
  if (attn_deep::takes(head_dim))
    return kDq ? attn_deep::bwd_dq(dtype, head_dim, deep_args(a))
               : attn_deep::bwd_dkv(dtype, head_dim, deep_args(a));
#define PIT_LAUNCH(D)                                                      \
  (dtype == 0 ? (kDq ? launch_dq<D>(a) : launch_dkv<D>(a))                 \
              : (kDq ? launch_dq_wgmma<D>(a) : launch_dkv_wgmma<D>(a)))
  switch (head_dim) {
    case 8: return PIT_LAUNCH(8);
    case 16: return PIT_LAUNCH(16);
    case 32: return PIT_LAUNCH(32);
    case 64: return PIT_LAUNCH(64);
    case 128: return PIT_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef PIT_LAUNCH
}

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* bias,
               const void* m, const void* l, const void* delta, void* dq, void* dk, void* dv,
               int batch, int t_len, int s_len, int heads, int causal, int causal_offset,
               const int64_t* strides, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.bias = static_cast<const float*>(bias);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.batch = batch; a.t_len = t_len; a.s_len = s_len; a.heads = heads;
  a.causal = causal; a.causal_offset = causal_offset;
  a.st = Strides{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design).
// q and g are (B, T, H, D), k and v are (B, S, H, D), each with unit stride
// along D and the given (batch, row, head) strides in elements (bf16:
// 16-byte aligned bases and strides that are nonzero multiples of 8, for
// TMA); bias is (B, S) f32 contiguous; m, l and delta are
// (B, H, T) f32 contiguous; dq is (B, T, H, D) and dk, dv are (B, S, H, D),
// contiguous. causal (0 or 1) adds the forward's causal bias: -1e30 where
// key s > t + causal_offset. Each returns the cudaError_t of its launch (0 on
// success; cudaErrorInvalidValue if a tensor map cannot be encoded).
extern "C" int attention_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* g, const void* bias,
                                const void* m, const void* l, const void* delta, void* dq,
                                int batch, int t_len, int s_len, int heads, int causal,
                                int causal_offset,
                                int64_t sqb, int64_t sqt, int64_t sqh,
                                int64_t skb, int64_t sks, int64_t skh,
                                int64_t svb, int64_t svs, int64_t svh,
                                int64_t sgb, int64_t sgt, int64_t sgh, void* stream) {
  const int64_t strides[12] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sgb, sgt, sgh};
  return dispatch<true>(dtype, head_dim,
                        make_args(q, k, v, g, bias, m, l, delta, dq, nullptr, nullptr,
                                  batch, t_len, s_len, heads, causal, causal_offset,
                                  strides, stream));
}

extern "C" int attention_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* g, const void* bias,
                                 const void* m, const void* l, const void* delta, void* dk,
                                 void* dv, int batch, int t_len, int s_len, int heads,
                                 int causal, int causal_offset,
                                 int64_t sqb, int64_t sqt, int64_t sqh,
                                 int64_t skb, int64_t sks, int64_t skh,
                                 int64_t svb, int64_t svs, int64_t svh,
                                 int64_t sgb, int64_t sgt, int64_t sgh, void* stream) {
  const int64_t strides[12] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sgb, sgt, sgh};
  return dispatch<false>(dtype, head_dim,
                         make_args(q, k, v, g, bias, m, l, delta, nullptr, dk, dv,
                                   batch, t_len, s_len, heads, causal, causal_offset,
                                   strides, stream));
}
