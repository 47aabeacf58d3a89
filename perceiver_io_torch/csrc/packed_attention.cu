// Packed-heads multi-head attention for the Perceiver latent attention,
// written by hand for Hopper (sm_90a): a forward kernel, and the backward as
// two kernels (dq, then dk/dv).
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_packed_fwd_impl (Pallas
// kernel _packed_fwd_kernel) and ::_packed_bwd_impl (_packed_bwd_kernel): the
// attn_impl='packed' path.
//
// Layout: q (B, T, E), k and v (B, S, E) with the H heads packed along E
// (head h owns channels [h*D, (h+1)*D)); bias (B, S) f32, 0 or -1e30.
// Per (b, h, query row t):
//   logit[s] = q_h[t] . k_h[s] * D^-0.5 + bias[b,s]            (f32)
//   m        = max_s logit[s]                                  (not clamped)
//   p[s]     = exp(logit[s] - m) / sum_s exp(logit[s] - m)     (normalised in f32)
//   out_h[t] = sum_s round_v(p[s]) * v_h[s]       (f32 sum, written in q's dtype)
// and the backward in the TPU kernel's order:
//   dp[s]   = g_h[t] . v_h[s],  delta = sum_s p[s] * dp[s]     (f32)
//   ds[s]   = round_q(p[s] * (dp[s] - delta) * D^-0.5), 0 on a row whose
//             m <= -0.5e30 (every key masked)
//   dq_h[t] = sum_s ds[s] * k_h[s],  dk_h[s] = sum_t ds * q_h[t],
//   dv_h[s] = sum_t round_q(p) * g_h[t]
// The probabilities are normalised BEFORE they are rounded to v's dtype, so
// the forward takes two passes over the keys: kernel #1's one-pass online
// softmax rounds the unnormalised probabilities, which in bf16 is another
// function. ds carries the scale before it is rounded, so dq and dk take no
// further scale (kernels #2/#3 scale at the end: another rounding order). A
// fully masked row attends uniformly (the mean of v); its dq and dk are
// exactly 0, its dv contribution stays.
//
// The TPU kernel separates the heads by multiplying k, v, g and q by a 0/1
// channel mask, H times the products the function needs; here each head's
// products contract only its own D channels, read in place from the packed
// rows (row stride E, head offset h*D): the head-split layout is never
// written.
//
// What bounds it on the H100: at the C=64 path's encoder cross-attention
// (B=64, T=256, S=512, E=64, H=4, D=16, bf16) the forward moves 12.7 MB
// (3.8 us at 3.35 TB/s) and needs 2.1 GFLOP of products (2.2 us at
// 989 TF/s), but B.H.T.S = 33.6 M exponentials take 8.0 us at 16 a clock per
// SM on 132 SMs at 1980 MHz: the exponentials bound it, and the forward and
// dq kernels take two per (head, query, key). Where keys are padding (~75%
// of the encoder's keys on the training rows), the bf16 design skips them a
// whole tile at a time, so the work follows the valid keys.
//
// Two designs, chosen by dtype (not a fallback). Each is three launches,
// deterministic (no atomics), every block owning its outputs outright.
//
// - float32: exact f32, scalar FMAs (wgmma has no full-f32 mode; the f32
//   parity bar, packed = pallas within 1e-4, needs exact products). One
//   block per (64-row tile, head, b), 256 threads, four lanes per row; the
//   looped tile is 64 rows, staged through shared memory as f32 with row
//   stride D+1 (column reads hit distinct banks). The forward's pass 1 takes
//   each row's running max and denominator (per lane, then combined across
//   the four lanes by shuffles); pass 2 recomputes the logits, normalises
//   (divides by l), rounds p into a per-row shared strip and accumulates
//   P.V, D/4 columns a lane. The dq kernel's pass 1 takes m, l and
//   u = sum exp(logit - m) * dp online (delta = u / l), pass 2 forms ds and
//   accumulates dq; the dk/dv kernel owns a key tile and loops over the query
//   tiles. Rows past T and keys past S are staged as zeros and contribute
//   nothing.
//
// - bfloat16: tensor cores (attention_tiles.cuh: 128 owned rows on two
//   consumer warpgroups, 64-row streamed tiles through a two-stage TMA ring,
//   swizzled shared memory). Each packed tensor is read through a 4-D
//   (B, rows, H, D) tensor map of its (B, T, H, D) view, head stride D, so
//   at D=8 the 16-column box zero-fills past the head instead of loading
//   the next head's channels. Every product is a wgmma with f32
//   accumulators in registers. p is exp(logit - m) times 1/l (a multiply by
//   the reciprocal, not a division: one f32 ulp from the plain version's
//   division, inside the bf16 bar).
//   forward, per (128-query tile, head, b): q staged once. Pass 1 streams K
//     tiles, S = Q.K^T (SS), each row's m and l online in registers (m
//     shared across the row's quad by shuffles, l summed across it at the
//     end). Pass 2 streams K and V, recomputes S, forms p in f32, rounds it
//     to bf16 in registers and accumulates O += P.V (RS, V MN-major).
//   dq, per (128-query tile, head, b): q and g staged once. Pass 1 streams
//     K and V, S = Q.K^T and dP = G.V^T (SS), m, l and u online; delta = u /
//     l; (m, l, delta) go to the (B, T, H, 3) f32 scratch. Pass 2 recomputes
//     S and dP, forms ds = round(p (dP - delta) scale) (0 on a fully masked
//     row) and accumulates dq += ds.K (RS, K MN-major).
//   dk/dv, per (128-key tile, head, b), in the transposed frame (no
//     transpose in shared memory): k and v staged once; for each 64-query
//     tile S^T = K.Q^T and dP^T = V.G^T (SS), p^T and ds^T formed in
//     registers from the query tile's (m, 1/l, delta), staged in shared
//     memory by plain loads (the scratch's row stride, 3H floats, is no
//     TMA stride), then dv += round(p^T).G and dk += ds^T.Q (RS, G and Q
//     MN-major).
//   Keys past S and queries past T are masked by index (TMA fills them with
//   zeros, which would score 0, not -1e30); the scratch is never read past
//   T. Key tiles that are all padding are skipped, exactly: in f32 -1e30 +
//   logit - m rounds to -1e30, so p is 0 there on every row with a valid
//   key, and such a tile cannot raise m. The forward and dq kernels list
//   the live key tiles once per block from the bias row and stream only
//   those; a dk/dv warpgroup whose 64 keys are all padding computes
//   nothing (dk = dv = 0). A fully masked example (m = -1e30, p = 1/S) runs
//   the full path in all three.

#include "attention_tiles.cuh"

#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace attn_tiles;

constexpr float kMaskValue = -1e30f;  // pallas_attention.MASK_VALUE

struct Strides {  // (batch, row) strides in elements of q, k, v, g
  int64_t qb, qt, kb, ks, vb, vs, gb, gt;
};

// ---------------------------------------------------------------------------
// float32: the exact scalar design
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                 // rows (queries or keys) a block owns
constexpr int kTile = 64;                 // rows of the tile the block loops over
constexpr int kLanes = 4;                 // threads per owned row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kPerLane = kTile / kLanes;  // tile rows each thread scores

// rows [r0, r0 + 64) of one head's D channels (row stride rs) into an f32
// [64][D + 1] tile; rows at or past n become zeros
template <int D>
__device__ __forceinline__ void stage(float* tile, const float* src, int64_t rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * (D + 1) + d] = r0 + r < n ? src[(r0 + r) * rs + d] : 0.f;
  }
}

// s[i] = a . b[lane + i * kLanes] over D channels (b: a staged [64][D + 1] tile)
template <int D>
__device__ __forceinline__ void dots(float (&s)[kPerLane], const float* a, const float* b,
                                     int lane) {
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) s[i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float ad = a[d];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      s[i] = fmaf(ad, b[(lane + i * kLanes) * (D + 1) + d], s[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ out, int t_len, int s_len, int heads, Strides st,
                  float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][DP]
  float* ks = qs + kRows * DP;   // [kTile][DP]
  float* vs = ks + kTile * DP;   // [kTile][DP]
  float* ps = vs + kTile * DP;   // [kRows][PP]
  float* bs = ps + kRows * PP;   // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = t0 + row;
  const float* kb = k + b * st.kb + h * D;
  const float* vb = v + b * st.vb + h * D;
  const float* biasb = bias + int64_t(b) * s_len;

  stage<D>(qs, q + b * st.qb + h * D, st.qt, t0, t_len);
  const float* qrow = qs + row * DP;

  // pass 1: the row max and the denominator
  float m = -FLT_MAX, l = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    stage<D>(ks, kb, st.ks, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane];
    dots<D>(s, qrow, ks, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      if (j >= n) continue;
      const float x = s[i] * scale + bs[j];
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {  // combine the row's four lanes
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
    m = m_new;
  }

  // pass 2: normalised probabilities times v
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();
    stage<D>(ks, kb, st.ks, s0, s_len);
    stage<D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane];
    dots<D>(s, qrow, ks, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      ps[row * PP + j] = j < n ? expf(s[i] * scale + bs[j] - m) / l : 0.f;
    }
    __syncwarp();  // the row's four threads see each other's p
    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i)
        acc[i] = fmaf(p, vs[j * DP + lane + i * kLanes], acc[i]);
    }
  }

  if (t < t_len) {
    float* o = out + (int64_t(b) * t_len + t) * (int64_t(heads) * D) + h * D + lane;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) o[i * kLanes] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ bias, float* __restrict__ dq,
                     float* __restrict__ stats, int t_len, int s_len, int heads, Strides st,
                     float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
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
  const float* kb = k + b * st.kb + h * D;
  const float* vb = v + b * st.vb + h * D;
  const float* biasb = bias + int64_t(b) * s_len;

  stage<D>(qs, q + b * st.qb + h * D, st.qt, t0, t_len);
  stage<D>(gs, g + b * st.gb + h * D, st.gt, t0, t_len);
  const float* qrow = qs + row * DP;
  const float* grow = gs + row * DP;

  // pass 1: m, l and u = sum exp(logit - m) * dp, online; delta = u / l
  float m = -FLT_MAX, l = 0.f, u = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage<D>(ks, kb, st.ks, s0, s_len);
    stage<D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots<D>(s, qrow, ks, lane);
    dots<D>(dp, grow, vs, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      if (j >= n) continue;
      const float x = s[i] * scale + bs[j];
      if (x > m) {
        const float c = expf(m - x);
        l = l * c + 1.f;
        u = u * c + dp[i];
        m = x;
      } else {
        const float e = expf(x - m);
        l += e;
        u = fmaf(e, dp[i], u);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {  // combine the row's four lanes
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float u_o = __shfl_xor_sync(0xffffffffu, u, off);
    const float m_new = fmaxf(m, m_o);
    const float ca = expf(m - m_new), cb = expf(m_o - m_new);
    l = l * ca + l_o * cb;
    u = u * ca + u_o * cb;
    m = m_new;
  }
  const float delta = u / l;
  if (t < t_len && lane == 0) {
    float* row_stats = stats + ((int64_t(b) * t_len + t) * heads + h) * 3;
    row_stats[0] = m;
    row_stats[1] = l;
    row_stats[2] = delta;
  }
  const bool masked_row = m <= 0.5f * kMaskValue;

  // pass 2: ds times k
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();
    stage<D>(ks, kb, st.ks, s0, s_len);
    stage<D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots<D>(s, qrow, ks, lane);
    dots<D>(dp, grow, vs, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      const float p = expf(s[i] * scale + bs[j] - m) / l;
      dss[row * PP + j] = (masked_row || j >= n) ? 0.f : p * (dp[i] - delta) * scale;
    }
    __syncwarp();  // the row's four threads see each other's ds
    for (int j = 0; j < n; ++j) {
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i)
        acc[i] = fmaf(ds, ks[j * DP + lane + i * kLanes], acc[i]);
    }
  }

  if (t < t_len) {
    float* o = dq + (int64_t(b) * t_len + t) * (int64_t(heads) * D) + h * D + lane;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) o[i * kLanes] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ bias, const float* __restrict__ stats,
                      float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
                      int heads, Strides st, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kTile + 1;
  extern __shared__ float smem[];
  float* ks = smem;              // [kRows][DP]
  float* vs = ks + kRows * DP;   // [kRows][DP]
  float* qs = vs + kRows * DP;   // [kTile][DP]
  float* gs = qs + kTile * DP;   // [kTile][DP]
  float* ps = gs + kTile * DP;   // [kRows][PP]
  float* dss = ps + kRows * PP;  // [kRows][PP]
  float* sts = dss + kRows * PP;  // [kTile][3]: m, l, delta

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int s0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s_idx = s0 + row;
  const float* qb = q + b * st.qb + h * D;
  const float* gb = g + b * st.gb + h * D;

  stage<D>(ks, k + b * st.kb + h * D, st.ks, s0, s_len);
  stage<D>(vs, v + b * st.vb + h * D, st.vs, s0, s_len);
  const float* krow = ks + row * DP;
  const float* vrow = vs + row * DP;
  const float bias_s = s_idx < s_len ? bias[int64_t(b) * s_len + s_idx] : 0.f;

  float dk_acc[D / kLanes], dv_acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int n = min(kTile, t_len - t0);
    __syncthreads();  // the previous tile is consumed (and the k, v tiles stored)
    stage<D>(qs, qb, st.qt, t0, t_len);
    stage<D>(gs, gb, st.gt, t0, t_len);
    if (tid < kTile * 3) {
      const int j = tid / 3, c = tid % 3;
      sts[tid] = j < n ? stats[((int64_t(b) * t_len + t0 + j) * heads + h) * 3 + c]
                       : (c == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots<D>(s, krow, qs, lane);
    dots<D>(dp, vrow, gs, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      const float m_j = sts[j * 3];
      const float p = j < n ? expf(s[i] * scale + bias_s - m_j) / sts[j * 3 + 1] : 0.f;
      ps[row * PP + j] = p;
      dss[row * PP + j] = m_j <= 0.5f * kMaskValue ? 0.f : p * (dp[i] - sts[j * 3 + 2]) * scale;
    }
    __syncwarp();  // the row's four threads see each other's p and ds
    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < D / kLanes; ++i) {
        const int c = lane + i * kLanes;
        dv_acc[i] = fmaf(p, gs[j * DP + c], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[j * DP + c], dk_acc[i]);
      }
    }
  }

  if (s_idx < s_len) {
    const int64_t o = (int64_t(b) * s_len + s_idx) * (int64_t(heads) * D) + h * D + lane;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) {
      dk[o + i * kLanes] = dk_acc[i];
      dv[o + i * kLanes] = dv_acc[i];
    }
  }
}

template <int D>
constexpr size_t smem_floats(int staged_tiles, int strips, int extra) {
  return size_t(staged_tiles) * kTile * (D + 1) + size_t(strips) * kRows * (kTile + 1) + extra;
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma design
// ---------------------------------------------------------------------------

// this thread's rows of its warpgroup's accumulator: r = 0 and r = 1, eight apart
__device__ __forceinline__ int first_row(int r0) {
  const int tid = threadIdx.x;
  return r0 + (tid / 128) * kWgRows + (tid % 128) / 32 * 16 + (tid % 32) / 4;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
packed_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        int t_len, int s_len, int heads, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qs = smem;                                  // [atom][kOwnRows rows]
  uint8_t* ks = qs + G::kOwnBytes;                     // [stage][atom][kStreamRows rows]
  uint8_t* vs = ks + kStages * G::kStreamBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(vs + kStages * G::kStreamBytes);
  uint64_t* own_bar = ring_bar + kStages;
  int* live = reinterpret_cast<int*>(own_bar + 1);     // [n_tiles + 1]: live key tiles, count

  const int tid = threadIdx.x;
  const int wg = tid / 128;
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
  const int n_live = list_live_tiles(bias_b, s_len, n_tiles, live, true);
  // job j < n_live: pass 1 over live tile j (K alone); then pass 2 (K and V)
  const int n_jobs = 2 * n_live;
  const CUtensorMap* k_ptr = &k_map;
  const CUtensorMap* v_ptr = &v_map;
  auto load_job = [&](int job, int stage) {
    const bool second = job >= n_live;
    load_stream<D>(k_ptr, second ? v_ptr : nullptr, ks, vs, ring_bar,
                   live[second ? job - n_live : job], stage, h, b);
  };
  if (tid == 0) {
    load_own<D>(&q_map, nullptr, qs, nullptr, own_bar, t0, h, b);
    for (int j = 0; j < kStages && j < n_jobs; ++j) load_job(j, j);
  }

  const int row0 = first_row(t0);
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + wg * kWgRows < t_len;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row's sum until pass 1 ends
  float inv_l[2] = {0.f, 0.f};
  float o[G::kAtoms][G::kRegs];
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) o[a][i] = 0.f;

  if (active) hopper::mbar_wait(own_bar, 0);
  for (int j = 0; j < n_jobs; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
      const bool second = j >= n_live;
      const uint8_t* k_tile = ks + stage * G::kStreamBytes;
      float s[32];
      hopper::wgmma_fence();
      tile_product<D>(s, qs, wg, k_tile);  // S = Q . K^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // logits in place of s; keys past S masked by index
      const int s0 = live[second ? j - n_live : j] * kStreamRows;
      float tile_max[2] = {-INFINITY, -INFINITY};
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
            s[i] = valid ? s[i] * scale + bj : -INFINITY;
            tile_max[r] = fmaxf(tile_max[r], s[i]);
          }
        }
      }
      if (!second) {  // pass 1: the running max and this thread's share of l
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
          tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
          const float m_new = fmaxf(m_run[r], tile_max[r]);
          l_run[r] *= exp2f((m_run[r] - m_new) * kLog2e);
          m_run[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)  // 0 at keys masked by index
          l_run[(i / 2) % 2] += exp2f((s[i] - m_run[(i / 2) % 2]) * kLog2e);
        if (j == n_live - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
            l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
            inv_l[r] = 1.f / l_run[r];
          }
        }
      } else {  // pass 2: p normalised in f32, rounded to bf16, times V
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2f((s[i] - m_run[(i / 2) % 2]) * kLog2e) * inv_l[(i / 2) % 2];
        uint32_t p_a[4][4];
        to_fragments(s, p_a);
        hopper::wgmma_fence();
        accumulate<D>(o, p_a, vs + stage * G::kStreamBytes);  // O += P . V
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        wait_acc<D>(o);
      }
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_jobs) load_job(j + kStages, stage);
  }

  if (active) store_rows<D>(o, out, row0, t_len, heads, h, b, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
packed_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap g_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ stats, int t_len, int s_len, int heads,
                       float scale) {
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
  const int n_live = list_live_tiles(bias_b, s_len, n_tiles, live, true);
  const int n_jobs = 2 * n_live;  // pass 1, then pass 2, over the live key tiles
  if (tid == 0) {
    load_own<D>(&q_map, &g_map, qs, gs, own_bar, t0, h, b);
    for (int j = 0; j < kStages && j < n_jobs; ++j)
      load_stream<D>(&k_map, &v_map, ks, vs, ring_bar, live[j % n_live], j, h, b);
  }

  const int row0 = first_row(t0);
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + wg * kWgRows < t_len;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f}, u_run[2] = {0.f, 0.f};  // this thread's shares until pass 1 ends
  float inv_l[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  bool zero_ds[2] = {true, true};  // a row whose keys are all masked
  float acc[G::kAtoms][G::kRegs];
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kRegs; ++i) acc[a][i] = 0.f;

  if (active) hopper::mbar_wait(own_bar, 0);
  for (int j = 0; j < n_jobs; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
      const bool second = j >= n_live;
      const uint8_t* k_tile = ks + stage * G::kStreamBytes;
      float s[32], dp[32];
      hopper::wgmma_fence();
      tile_product<D>(s, qs, wg, k_tile);                       // S = Q . K^T
      tile_product<D>(dp, gs, wg, vs + stage * G::kStreamBytes);  // dP = G . V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // logits in place of s; keys past S masked by index
      const int s0 = live[second ? j - n_live : j] * kStreamRows;
      float tile_max[2] = {-INFINITY, -INFINITY};
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
            s[i] = valid ? s[i] * scale + bj : -INFINITY;
            tile_max[r] = fmaxf(tile_max[r], s[i]);
          }
        }
      }
      if (!second) {  // pass 1: m, and this thread's shares of l and u, online
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
          tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
          const float m_new = fmaxf(m_run[r], tile_max[r]);
          const float c = exp2f((m_run[r] - m_new) * kLog2e);
          l_run[r] *= c;
          u_run[r] *= c;
          m_run[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          const float e = exp2f((s[i] - m_run[r]) * kLog2e);  // 0 at masked-by-index keys
          l_run[r] += e;
          u_run[r] = fmaf(e, dp[i], u_run[r]);
        }
        if (j == n_live - 1) {  // the row's quad sums; the statistics to the scratch
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], off);
              u_run[r] += __shfl_xor_sync(0xffffffffu, u_run[r], off);
            }
            inv_l[r] = 1.f / l_run[r];
            delta[r] = u_run[r] / l_run[r];
            zero_ds[r] = m_run[r] <= kPadded;
            const int t = row0 + 8 * r;
            if (t < t_len && lane % 4 == 0) {
              float* row_stats = stats + ((int64_t(b) * t_len + t) * heads + h) * 3;
              row_stats[0] = m_run[r];
              row_stats[1] = l_run[r];
              row_stats[2] = delta[r];
            }
          }
        }
      } else {  // pass 2: ds, scaled, rounded to bf16, times K
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i / 2) % 2;
          const float p = exp2f((s[i] - m_run[r]) * kLog2e) * inv_l[r];
          s[i] = zero_ds[r] ? 0.f : p * (dp[i] - delta[r]) * scale;
        }
        uint32_t ds_a[4][4];
        to_fragments(s, ds_a);
        hopper::wgmma_fence();
        accumulate<D>(acc, ds_a, k_tile);  // dq += ds . K
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        wait_acc<D>(acc);
      }
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_jobs)
      load_stream<D>(&k_map, &v_map, ks, vs, ring_bar, live[(j + kStages) % n_live], stage, h,
                     b);
  }

  if (active) store_rows<D>(acc, dq, row0, t_len, heads, h, b, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
packed_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const float* __restrict__ bias, const float* __restrict__ stats,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int t_len, int s_len, int heads, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ks = smem;                                  // [atom][kOwnRows rows]
  uint8_t* vs = ks + G::kOwnBytes;
  uint8_t* qs = vs + G::kOwnBytes;                     // [stage][atom][kStreamRows rows]
  uint8_t* gs = qs + kStages * G::kStreamBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(gs + kStages * G::kStreamBytes);
  uint64_t* own_bar = ring_bar + kStages;
  float* st_ring = reinterpret_cast<float*>(own_bar + 1);  // [stage][m, 1/l, delta][kStreamRows]
  int* wg_live = reinterpret_cast<int*>(st_ring + kStages * 3 * kStreamRows);  // [2]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int s0 = blockIdx.x * kOwnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_len + kStreamRows - 1) / kStreamRows;
  const float* bias_b = bias + int64_t(b) * s_len;

  // the statistics of query tile `tile` (row stride 3H floats in the
  // scratch) into ring stage `stage`; queries past T are never read
  auto stage_stats = [&](int tile, int stage) {
    if (tid < kStreamRows) {
      const int t = tile * kStreamRows + tid;
      const bool valid = t < t_len;
      const float* row = stats + ((int64_t(b) * t_len + t) * heads + h) * 3;
      float* slot = st_ring + stage * 3 * kStreamRows;
      slot[tid] = valid ? row[0] : 0.f;
      slot[kStreamRows + tid] = valid ? 1.f / row[1] : 0.f;
      slot[2 * kStreamRows + tid] = valid ? row[2] : 0.f;
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
    if (key < s_len && bias_b[key] > kPadded) wg_live[wg] = 1;
  }
  __syncthreads();
  // all-padding keys give dk = dv = 0 exactly where the example has a valid
  // key (every row of an example sees the same keys); a fully masked example
  // runs the full path (p = 1/S there)
  const bool example_live = t_len > 0 && stats[(int64_t(b) * t_len * heads + h) * 3] > kPadded;
  const bool computes0 = s0 < s_len && (wg_live[0] || !example_live);
  const bool computes1 = s0 + kWgRows < s_len && (wg_live[1] || !example_live);
  const bool active = wg == 0 ? computes0 : computes1;
  const bool block_active = computes0 || computes1;
  if (tid == 0 && block_active) {
    load_own<D>(&k_map, &v_map, ks, vs, own_bar, s0, h, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      load_stream<D>(&q_map, &g_map, qs, gs, ring_bar, st, st, h, b);
  }

  // this thread's accumulator rows (keys)
  const int row0 = first_row(s0);
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
        const float* st_m = st_ring + stage * 3 * kStreamRows;
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

        // p^T in place of x, ds^T (scaled) in place of dp; queries past T
        // masked by index
        const int q0 = j * kStreamRows;
#pragma unroll
        for (int c = 0; c < kStreamRows / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * c + col_in_chunk + e;
            const bool valid = q0 + col < t_len;
            const float m_c = st_m[col];
            const bool zero_ds = !valid || m_c <= kPadded;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = 4 * c + 2 * r + e;
              const float p = valid && key_valid[r]
                                  ? exp2f((x[i] * scale + bias_r[r] - m_c) * kLog2e) *
                                        st_inv_l[col]
                                  : 0.f;
              dp[i] = zero_ds ? 0.f : p * (dp[i] - st_delta[col]) * scale;
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
    store_rows<D>(dk_acc, dk, row0, s_len, heads, h, b, 1.f);
    store_rows<D>(dv_acc, dv, row0, s_len, heads, h, b, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *g;
  const float* bias;
  float* stats;
  void *out, *dk, *dv;  // out: the forward's output or dq
  int batch, t_len, s_len, heads;
  Strides st;
  cudaStream_t stream;
};

enum class Kind { kFwd, kDq, kDkv };

template <int D>
cudaError_t launch_scalar(Kind kind, const Args& a) {
  const int owned = kind == Kind::kDkv ? a.s_len : a.t_len;  // rows the blocks own
  const dim3 grid((owned + kRows - 1) / kRows, a.heads, a.batch);
  const float scale = float(1.0 / sqrt(double(D)));
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* g = static_cast<const float*>(a.g);
  cudaError_t err;
  if (kind == Kind::kFwd) {  // q, k, v tiles, the p strip, the bias tile
    const size_t smem = sizeof(float) * smem_floats<D>(3, 1, kTile);
    if ((err = set_smem(packed_fwd_kernel<D>, smem)) != cudaSuccess) return err;
    packed_fwd_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, a.bias, static_cast<float*>(a.out), a.t_len, a.s_len, a.heads, a.st, scale);
  } else if (kind == Kind::kDq) {  // q, g, k, v tiles, the ds strip, the bias tile
    const size_t smem = sizeof(float) * smem_floats<D>(4, 1, kTile);
    if ((err = set_smem(packed_bwd_dq_kernel<D>, smem)) != cudaSuccess) return err;
    packed_bwd_dq_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.bias, static_cast<float*>(a.out), a.stats, a.t_len, a.s_len, a.heads,
        a.st, scale);
  } else {  // k, v, q, g tiles, the p and ds strips, the (m, l, delta) tile
    const size_t smem = sizeof(float) * smem_floats<D>(4, 2, 3 * kTile);
    if ((err = set_smem(packed_bwd_dkv_kernel<D>, smem)) != cudaSuccess) return err;
    packed_bwd_dkv_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.bias, a.stats, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.t_len, a.s_len, a.heads, a.st, scale);
  }
  return cudaGetLastError();
}

// a 4-D map over the (B, rows, H, D) view of a packed (B, rows, E) tensor
// with (batch, row) strides sb, sr: head stride D, boxes of one swizzle atom
// of columns and `box_rows` rows
template <int D>
bool encode(CUtensorMap* map, const void* base, const Args& a, int rows, int64_t sb, int64_t sr,
            int box_rows) {
  const int64_t strides[3] = {sb, sr, D};
  return hopper::encode_head_map(map, base, a.batch, rows, a.heads, D, strides,
                                 Geometry<D>::kAtomCols, box_rows);
}

template <int D>
cudaError_t launch_wgmma(Kind kind, const Args& a) {
  using G = Geometry<D>;
  const float scale = float(1.0 / sqrt(double(D)));
  const Strides& st = a.st;
  const int own_t = kind == Kind::kDkv ? kStreamRows : kOwnRows;  // q, g box rows
  const int own_s = kind == Kind::kDkv ? kOwnRows : kStreamRows;  // k, v box rows
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode<D>(&q_map, a.q, a, a.t_len, st.qb, st.qt, own_t) ||
      !encode<D>(&k_map, a.k, a, a.s_len, st.kb, st.ks, own_s) ||
      !encode<D>(&v_map, a.v, a, a.s_len, st.vb, st.vs, own_s) ||
      (kind != Kind::kFwd && !encode<D>(&g_map, a.g, a, a.t_len, st.gb, st.gt, own_t)))
    return cudaErrorInvalidValue;
  const int key_tiles = (a.s_len + kStreamRows - 1) / kStreamRows;
  const size_t live_list = sizeof(int) * (key_tiles + 1);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  cudaError_t err;
  if (kind == Kind::kFwd) {  // one owned tile (q), the K and V rings, the live list
    const size_t smem = G::kSmem - G::kOwnBytes + live_list;
    if ((err = set_smem(packed_fwd_wgmma_kernel<D>, smem)) != cudaSuccess) return err;
    const dim3 grid((a.t_len + kOwnRows - 1) / kOwnRows, a.heads, a.batch);
    packed_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, a.stream>>>(
        q_map, k_map, v_map, a.bias, out, a.t_len, a.s_len, a.heads, scale);
  } else if (kind == Kind::kDq) {  // q and g, the K and V rings, the live list
    const size_t smem = G::kSmem + live_list;
    if ((err = set_smem(packed_bwd_dq_wgmma_kernel<D>, smem)) != cudaSuccess) return err;
    const dim3 grid((a.t_len + kOwnRows - 1) / kOwnRows, a.heads, a.batch);
    packed_bwd_dq_wgmma_kernel<D><<<grid, kWgThreads, smem, a.stream>>>(
        q_map, g_map, k_map, v_map, a.bias, out, a.stats, a.t_len, a.s_len, a.heads, scale);
  } else {  // k and v, the Q and G rings, the statistics ring, two flags
    const size_t smem = G::kSmem + sizeof(float) * kStages * 3 * kStreamRows + 2 * sizeof(int);
    if ((err = set_smem(packed_bwd_dkv_wgmma_kernel<D>, smem)) != cudaSuccess) return err;
    const dim3 grid((a.s_len + kOwnRows - 1) / kOwnRows, a.heads, a.batch);
    packed_bwd_dkv_wgmma_kernel<D><<<grid, kWgThreads, smem, a.stream>>>(
        k_map, v_map, q_map, g_map, a.bias, a.stats, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), a.t_len, a.s_len, a.heads, scale);
  }
  return cudaGetLastError();
}

// dtype 0 (float32) runs the scalar design, 1 (bfloat16) the wgmma design
int dispatch(int dtype, int head_dim, Kind kind, const Args& a) {
  if (a.heads <= 0 || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
#define PIT_LAUNCH(D) (dtype == 0 ? launch_scalar<D>(kind, a) : launch_wgmma<D>(kind, a))
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
               void* stats, void* out, void* dk, void* dv, int batch, int t_len, int s_len,
               int heads, Strides st, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.bias = static_cast<const float*>(bias);
  a.stats = static_cast<float*>(stats);
  a.out = out; a.dk = dk; a.dv = dv;
  a.batch = batch; a.t_len = t_len; a.s_len = s_len; a.heads = heads;
  a.st = st;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design).
// q and g are (B, T, E), k and v (B, S, E), E = heads * head_dim, each with
// unit stride along E and the given (batch, row) strides in elements (bf16:
// 16-byte aligned bases and strides that are nonzero multiples of 8, for
// TMA); bias is (B, S) f32 contiguous; out, dq are (B, T, E) and dk, dv
// (B, S, E), contiguous; stats is the (B, T, H, 3) f32 (m, l, delta) scratch
// the dq kernel writes and the dk/dv kernel reads. Each returns the
// cudaError_t of its launch (0 on success; cudaErrorInvalidValue if a tensor
// map cannot be encoded).
extern "C" int packed_attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                                    const void* v, const void* bias, void* out, int batch,
                                    int t_len, int s_len, int heads, int64_t sqb, int64_t sqt,
                                    int64_t skb, int64_t sks, int64_t svb, int64_t svs,
                                    void* stream) {
  const Strides st{sqb, sqt, skb, sks, svb, svs, 0, 0};
  return dispatch(dtype, head_dim, Kind::kFwd,
                  make_args(q, k, v, nullptr, bias, nullptr, out, nullptr, nullptr, batch,
                            t_len, s_len, heads, st, stream));
}

extern "C" int packed_attention_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                       const void* v, const void* g, const void* bias,
                                       void* dq, void* stats, int batch, int t_len, int s_len,
                                       int heads, int64_t sqb, int64_t sqt, int64_t skb,
                                       int64_t sks, int64_t svb, int64_t svs, int64_t sgb,
                                       int64_t sgt, void* stream) {
  const Strides st{sqb, sqt, skb, sks, svb, svs, sgb, sgt};
  return dispatch(dtype, head_dim, Kind::kDq,
                  make_args(q, k, v, g, bias, stats, dq, nullptr, nullptr, batch, t_len, s_len,
                            heads, st, stream));
}

extern "C" int packed_attention_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                        const void* v, const void* g, const void* bias,
                                        const void* stats, void* dk, void* dv, int batch,
                                        int t_len, int s_len, int heads, int64_t sqb,
                                        int64_t sqt, int64_t skb, int64_t sks, int64_t svb,
                                        int64_t svs, int64_t sgb, int64_t sgt, void* stream) {
  const Strides st{sqb, sqt, skb, sks, svb, svs, sgb, sgt};
  return dispatch(dtype, head_dim, Kind::kDkv,
                  make_args(q, k, v, g, bias, const_cast<void*>(stats), nullptr, dk, dv, batch,
                            t_len, s_len, heads, st, stream));
}
