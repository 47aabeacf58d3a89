// Fused multi-head attention at head depths 256, 512 and 1024, forward (#1)
// and backward (#2 dq, #3 dk/dv), written by hand for Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_fwd_impl
// (Pallas kernel _attention_kernel, with or without causal_offset and the
// with_lse statistics) and ::_fused_attention_bwd_impl (_bwd_dq_kernel,
// _bwd_dkv_kernel) at head depths the TPU kernel takes beyond 128 (any D:
// LONG_KV_MAX_D = 512 only caps its long-KV query block): the optical-flow
// model's one-head crosses (D = 512), the multimodal model's, and
// ImageNet's (D = 1024). It computes what attention_fwd.cu
// and attention_bwd.cu compute, with the same biases, statistics, rounding
// points and masked-row rules (see their headers); only the geometry
// differs, because a head this deep does not fit their tiles.
//
// What bounds it on the H100: the flow crosses (B=8, T=2048 latents against
// S=182,528 pixels, one head of D=512, or the transpose for the decoder) are
// 4.B.T.S.D = 6.1 TFLOP forward against 3.2 GB of q/k/v/out: ~1,900
// FLOP/byte, far above the bf16 ridge, so the tensor cores bound it (6.2 ms
// at 989 TF/s); the backward's dq and dk/dv take 6 and 8 times B.T.S.D
// (9.3 and 12.4 ms). ImageNet's encoder cross (B=8, T=512 latents against
// S=50,176 pixels, D=1024) is 4.B.T.S.D = 0.84 TFLOP forward against 1.6
// GB: the tensor cores again (0.85 ms; dq 1.28, dk/dv 1.70 ms).
//
// Registers: a 64-row f32 accumulator of D columns costs D/2 registers a
// thread of one warpgroup (256 at D=512, over the 255 a thread may hold), so
// a bf16 block holds 256 head columns: all of them at D=256, one half at
// D=512, where the two blocks of a cluster split the columns and add their
// halves of each logit tile through distributed shared memory (st.async
// pushes), so no logit tile is computed twice; one quarter at D=1024, where
// the four blocks of a cluster sum their shares by a two-round butterfly
// through the same exchange buffers (round r with block rank ^ 2^r), so
// every block adds them as (s0 + s1) + (s2 + s3) and all four hold the same
// bits (a sum of four in each block's own order would give the four column
// quarters of a row different m, l and P). The shared memory of D=512
// serves D=1024 unchanged: the second round reuses the first's buffer once
// the partner has read it.
//
// The bf16 forward (deep_fwd_wgmma_kernel; its section says how): a block
// owns 128 query rows, 64 a warpgroup, and streams 64-key K and V tiles
// through two rings that a loading warp refills as mbarriers free them; each
// warpgroup issues the next tile's S product before this tile's softmax, so
// the exponentials run under a product, and at D=512 waits for the peer's
// half under its last P.V product. The flow encoder cross at B=8 gets 256
// blocks (two waves of 128 clusters on 132 SMs); at B=2 64, half the card:
// 128-row blocks read each K/V tile once for twice the rows of 64-row ones
// (shared-memory bandwidth, not the tensor cores, is what binds a 64-key
// tile: its SS logit product alone reads 128 bytes a clock at the tensor
// cores' peak), and the batch-8 training step is the path this design
// serves. ImageNet's encoder cross at B=8 gets 128 blocks (32 four-block
// clusters), one wave.
//
// float32 (exact scalar FMAs, as attention_fwd.cu / attention_bwd.cu): the
// forward keeps 64 rows and 4 threads a row with 64-key (D=256) or 16-key
// (D=512) tiles, 16 rows and 16 threads a row with 16-key tiles at D=1024;
// the backward owns 32 rows with 8 threads a row and streams 32-row (D=256)
// or 16-row (D=512) tiles, at D=1024 16 rows with 16 threads a row, 16-row
// tiles, and the owned rows read from device memory. All staged tiles are
// f32 with row stride D+1.
//
// The bf16 backward (deep_bwd_kernel; the section below says how): one
// kernel template for dq and for dk/dv, one launch each, no atomics. A
// block owns 64 rows and 256 head columns; at D=512 and 1024 a cluster of
// two or four blocks splits the columns, and its blocks add their shares of
// each logit tile through distributed shared memory. Its bound at the flow crosses is the
// tensor cores (above); what holds it back is the work between the
// products: the exchange of the logit tiles (at D=512 across the cluster),
// p and ds, and the bf16 fragments, each tile in turn (two ring stages
// leave no room to run the next tile's products meanwhile). No tile is
// split across blocks: the grids fill the card at B=8 (512 blocks at the
// flow crosses' 2048-row sides), and at B=1 the 2048-row sides leave half
// of it idle.
//
// No key or query tile is skipped for padding (the D <= 128 bf16 backward
// skips tiles that are all padding): the full path gives padded keys p = 0
// exactly where a row has a valid key, and a fully masked row the uniform p
// and zero ds of the other designs, so the results are the same.

#include "attention_deep.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kMaskValue = -1e30f;  // pallas_attention.MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: the exact scalar designs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// At D=1024 the sums are kept at least as accurate as the plain version's
// cuBLAS products (a sequential f32 chain of n terms errs ~sqrt(n) ulps of
// its sum: single chains left ImageNet's out and dq 5-10x further from
// float64 than the plain version's, and its f32 parity step, whose
// one-query decoder over near-equal latents amplifies any logit error, a
// step outside its bar): each dot product over the head dim in float64
// (Dot; f32 products are exact there), kSplit interleaved partial sums
// added pairwise, and the forward's P.V and row-sum and dq's ds.K sums over
// the keys compensated (Kahan), which needs the 64 accumulator columns a
// thread of 16 lanes a row holds; the logits, p and the backward's ds are
// formed in float64 too and rounded to f32 once, and the wrapper sums delta in
// float64 (the decoder's ds = p (dp - delta) cancels to ~1e-3 of its terms).
// D <= 512 keeps its single f32 chains.
template <int D>
struct ScalarFwd {
  static constexpr int kRows = D <= 512 ? 64 : 16;  // query rows a block owns
  static constexpr int kLanes = D <= 512 ? 4 : 16;  // threads a query row
  static constexpr int kKeys = D == 256 ? 64 : 16;  // keys a K/V tile
  static constexpr int kKeysPerLane = kKeys / kLanes;
  static constexpr int kCols = D / kLanes;        // accumulator columns a thread
  static constexpr int kSplit = D <= 512 ? 1 : 4;   // partial sums of a dot product
  using Dot = std::conditional_t<(D <= 512), float, double>;  // their type
  static constexpr bool kKahan = D > 512;          // compensated sums over the keys
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kRows) * (D + 1) + 2 * size_t(kKeys) * (D + 1) +
                       size_t(kRows) * (kKeys + 1) + kKeys);
};

template <int D>
struct ScalarBwd {
  static constexpr int kRows = D <= 512 ? 32 : 16;   // rows (queries or keys) a block owns
  static constexpr int kLanes = D <= 512 ? 8 : 16;   // threads an owned row
  static constexpr int kTile = D == 256 ? 32 : 16;   // rows of a streamed tile
  static constexpr int kPerLane = kTile / kLanes;
  static constexpr int kCols = D / kLanes;
  static constexpr int kSplit = D <= 512 ? 1 : 4;   // partial sums of a dot product
  using Dot = std::conditional_t<(D <= 512), float, double>;  // their type
  static constexpr bool kKahan = D > 512;          // compensated dq sum over the keys
  // at D=1024 the owned pair is read from device memory (its lanes read one
  // address at a time, a broadcast): staged, it and the streamed pair would
  // take 262 KB
  static constexpr bool kStageOwned = D <= 512;
  static constexpr size_t kOwnFloats = kStageOwned ? size_t(kRows) * (D + 1) : 0;
  // owned pair + streamed pair + ds strip + bias
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * kOwnFloats + 2 * size_t(kTile) * (D + 1) +
                       size_t(kRows) * (kTile + 1) + kTile);
  // owned pair + streamed pair + p and ds strips + m, l, delta
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * kOwnFloats + 2 * size_t(kTile) * (D + 1) +
                       2 * size_t(kRows) * (kTile + 1) + 3 * kTile);
};

// the sum of N partial sums, added pairwise in a fixed order
template <typename T, int N>
__device__ __forceinline__ T pairwise_sum(T (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] += x[i + w];
  return x[0];
}

// one step of a dot product's partial sum, in its type (Dot)
__device__ __forceinline__ float dot_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dot_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float dot_exp(float x) { return expf(x); }
__device__ __forceinline__ double dot_exp(double x) { return exp(x); }

// sum += x, compensated (Kahan): c carries the sum's lost low-order bits
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = x - c;
  const float t = sum + y;
  c = (t - sum) - y;
  sum = t;
}

// rows [r0, r0 + rows) of a (.., n, ., D) operand with row stride `rs` into
// an f32 [rows][D + 1] tile; rows at or past n become zeros
template <int D>
__device__ __forceinline__ void stage_f32(float* tile, const float* src, int64_t rs, int r0,
                                          int n, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * (D + 1) + d] = r0 + r < n ? src[(r0 + r) * rs + d] : 0.f;
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
deep_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                int t_len, int s_len, int heads, int causal_offset, int64_t sqb, int64_t sqt,
                int64_t sqh, int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
                int64_t svh, float scale) {
  using G = ScalarFwd<D>;
  constexpr int DP = D + 1;
  constexpr int PP = G::kKeys + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][DP]
  float* ks = qs + G::kRows * DP;     // [kKeys][DP]
  float* vs = ks + G::kKeys * DP;     // [kKeys][DP]
  float* ps = vs + G::kKeys * DP;     // [kRows][PP]
  float* bs = ps + G::kRows * PP;     // [kKeys]

  const int tid = threadIdx.x;
  const int row = tid / G::kLanes;
  const int lane = tid % G::kLanes;
  const int t0 = blockIdx.x * G::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* biasb = bias + int64_t(b) * s_len;

  stage_f32<D>(qs, q + b * sqb + h * sqh, sqt, t0, t_len, G::kRows);
  float acc[G::kCols], comp[G::kKahan ? G::kCols : 1];
#pragma unroll
  for (int i = 0; i < G::kCols; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (G::kKahan ? G::kCols : 1); ++i) comp[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f, l_comp = 0.f;
  const int key_limit = t0 + row + causal_offset;  // the last key the row sees unmasked

  for (int s0 = 0; s0 < s_len; s0 += G::kKeys) {
    const int n = min(G::kKeys, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    stage_f32<D>(ks, kb, sks, s0, s_len, G::kKeys);
    stage_f32<D>(vs, vb, svs, s0, s_len, G::kKeys);
    if (tid < G::kKeys) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    using Dot = typename G::Dot;
    Dot s[G::kKeysPerLane], part[G::kKeysPerLane][G::kSplit];
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i)
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) part[i][u] = 0;
#pragma unroll 4
    for (int d = 0; d < D; d += G::kSplit) {
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) {
        const Dot qd = qs[row * DP + d + u];
#pragma unroll
        for (int i = 0; i < G::kKeysPerLane; ++i)
          part[i][u] = dot_fma(qd, Dot(ks[(lane + i * G::kLanes) * DP + d + u]), part[i][u]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) s[i] = pairwise_sum(part[i]);
    float tile_max = -INFINITY;  // the logits in the dot products' type; the max in f32
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      s[i] = s[i] * Dot(scale) + Dot(bs[j]);
      if (kCausal && s0 + j > key_limit) s[i] += Dot(kMaskValue);
      if (j < n) tile_max = fmaxf(tile_max, float(s[i]));
    }
#pragma unroll
    for (int o = 1; o < G::kLanes; o *= 2)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, o));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      const float p = j < n ? float(dot_exp(s[i] - Dot(m_new))) : 0.f;
      p_sum += p;
      ps[row * PP + j] = p;
    }
#pragma unroll
    for (int o = 1; o < G::kLanes; o *= 2) p_sum += __shfl_xor_sync(0xffffffffu, p_sum, o);
    if constexpr (G::kKahan) {
      l *= alpha;
      l_comp *= alpha;
      kahan_add(l, l_comp, p_sum);
    } else {
      l = alpha * l + p_sum;
    }
    m = m_new;
    __syncwarp();  // the row's threads see each other's probabilities

#pragma unroll
    for (int i = 0; i < G::kCols; ++i) acc[i] *= alpha;
    if constexpr (G::kKahan) {
#pragma unroll
      for (int i = 0; i < G::kCols; ++i) comp[i] *= alpha;
      for (int j = 0; j < n; ++j) {
        const float p = ps[row * PP + j];
#pragma unroll
        for (int i = 0; i < G::kCols; ++i)
          kahan_add(acc[i], comp[i], p * vs[j * DP + lane + i * G::kLanes]);
      }
    } else {
      for (int j = 0; j < n; ++j) {
        const float p = ps[row * PP + j];
#pragma unroll
        for (int i = 0; i < G::kCols; ++i)
          acc[i] = fmaf(p, vs[j * DP + lane + i * G::kLanes], acc[i]);
      }
    }
  }

  const int t = t0 + row;
  if (t < t_len) {
    float* o = out + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < G::kCols; ++i) o[lane + i * G::kLanes] = acc[i] / l;
    if (m_out != nullptr && lane == 0) {  // the row's threads hold equal m, l
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m;
      l_out[stat] = l;
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
deep_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ bias, const float* __restrict__ m,
               const float* __restrict__ l, const float* __restrict__ delta,
               float* __restrict__ dq, int t_len, int s_len, int heads, int causal_offset,
               attn_deep::BwdArgs a, float scale) {
  using G = ScalarBwd<D>;
  constexpr int DP = D + 1;
  constexpr int PP = G::kTile + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][DP] (staged at D <= 512)
  float* gs = qs + G::kOwnFloats;     // [kRows][DP] (staged at D <= 512)
  float* ks = gs + G::kOwnFloats;     // [kTile][DP]
  float* vs = ks + G::kTile * DP;     // [kTile][DP]
  float* dss = vs + G::kTile * DP;    // [kRows][PP]
  float* bs = dss + G::kRows * PP;    // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / G::kLanes;
  const int lane = tid % G::kLanes;
  const int t0 = blockIdx.x * G::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = t0 + row;
  const int64_t* st = a.st;

  if constexpr (G::kStageOwned) {
    stage_f32<D>(qs, q + b * st[0] + h * st[2], st[1], t0, t_len, G::kRows);
    stage_f32<D>(gs, g + b * st[9] + h * st[11], st[10], t0, t_len, G::kRows);
  }
  // the row in device memory (unstaged; a row past T reads the last one,
  // whose ds is zeroed below)
  const int t_own = min(t, t_len - 1);
  const float* q_own = q + b * st[0] + t_own * st[1] + h * st[2];
  const float* g_own = g + b * st[9] + t_own * st[10] + h * st[11];
  const float* kb = k + b * st[3] + h * st[5];
  const float* vb = v + b * st[6] + h * st[8];
  const float* biasb = bias + int64_t(b) * s_len;

  const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
  const bool live = t < t_len;
  const float m_t = live ? m[stat] : 0.f;
  const float l_t = live ? l[stat] : 1.f;
  const float delta_t = live ? delta[stat] : 0.f;
  const bool masked_row = !live || m_t <= 0.5f * kMaskValue;
  const int key_limit = t + causal_offset;

  float acc[G::kCols], comp[G::kKahan ? G::kCols : 1];
#pragma unroll
  for (int i = 0; i < G::kCols; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (G::kKahan ? G::kCols : 1); ++i) comp[i] = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += G::kTile) {
    const int n = min(G::kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage_f32<D>(ks, kb, st[4], s0, s_len, G::kTile);
    stage_f32<D>(vs, vb, st[7], s0, s_len, G::kTile);
    if (tid < G::kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    using Dot = typename G::Dot;
    Dot s[G::kPerLane], dp[G::kPerLane];
    Dot s_part[G::kPerLane][G::kSplit], dp_part[G::kPerLane][G::kSplit];
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i)
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) s_part[i][u] = dp_part[i][u] = 0;
#pragma unroll 4
    for (int d = 0; d < D; d += G::kSplit) {
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) {
        const Dot qd = G::kStageOwned ? qs[row * DP + d + u] : q_own[d + u];
        const Dot gd = G::kStageOwned ? gs[row * DP + d + u] : g_own[d + u];
#pragma unroll
        for (int i = 0; i < G::kPerLane; ++i) {
          const int j = lane + i * G::kLanes;
          s_part[i][u] = dot_fma(qd, Dot(ks[j * DP + d + u]), s_part[i][u]);
          dp_part[i][u] = dot_fma(gd, Dot(vs[j * DP + d + u]), dp_part[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      s[i] = pairwise_sum(s_part[i]);
      dp[i] = pairwise_sum(dp_part[i]);
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      // logit, p and ds in the dot products' type, rounded to f32 once
      Dot x = s[i] * Dot(scale) + Dot(bs[j]);
      if (kCausal && s0 + j > key_limit) x += Dot(kMaskValue);
      const Dot p = dot_exp(x - Dot(m_t)) / Dot(l_t);
      dss[row * PP + j] = (masked_row || j >= n) ? 0.f : float(p * (dp[i] - Dot(delta_t)));
    }
    __syncwarp();  // the row's threads see each other's ds

    for (int j = 0; j < n; ++j) {
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < G::kCols; ++i) {
        if constexpr (G::kKahan)
          kahan_add(acc[i], comp[i], ds * ks[j * DP + lane + i * G::kLanes]);
        else
          acc[i] = fmaf(ds, ks[j * DP + lane + i * G::kLanes], acc[i]);
      }
    }
  }

  if (live) {
    float* o = dq + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < G::kCols; ++i) o[lane + i * G::kLanes] = acc[i] * scale;
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
deep_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ bias, const float* __restrict__ m,
                const float* __restrict__ l, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int t_len, int s_len,
                int heads, int causal_offset, attn_deep::BwdArgs a, float scale) {
  using G = ScalarBwd<D>;
  constexpr int DP = D + 1;
  constexpr int PP = G::kTile + 1;
  extern __shared__ float smem[];
  float* ks = smem;                   // [kRows][DP] (staged at D <= 512)
  float* vs = ks + G::kOwnFloats;     // [kRows][DP] (staged at D <= 512)
  float* qs = vs + G::kOwnFloats;     // [kTile][DP]
  float* gs = qs + G::kTile * DP;     // [kTile][DP]
  float* ps = gs + G::kTile * DP;     // [kRows][PP]
  float* dss = ps + G::kRows * PP;    // [kRows][PP]
  float* ms = dss + G::kRows * PP;    // [kTile]
  float* ls = ms + G::kTile;          // [kTile]
  float* des = ls + G::kTile;         // [kTile]

  const int tid = threadIdx.x;
  const int row = tid / G::kLanes;
  const int lane = tid % G::kLanes;
  const int s0 = blockIdx.x * G::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s_idx = s0 + row;
  const int64_t* st = a.st;

  if constexpr (G::kStageOwned) {
    stage_f32<D>(ks, k + b * st[3] + h * st[5], st[4], s0, s_len, G::kRows);
    stage_f32<D>(vs, v + b * st[6] + h * st[8], st[7], s0, s_len, G::kRows);
  }
  // the key in device memory (unstaged; a key past S reads the last one,
  // whose dk and dv are not written)
  const int s_own = min(s_idx, s_len - 1);
  const float* k_own = k + b * st[3] + s_own * st[4] + h * st[5];
  const float* v_own = v + b * st[6] + s_own * st[7] + h * st[8];
  const float* qb = q + b * st[0] + h * st[2];
  const float* gb = g + b * st[9] + h * st[11];
  const int64_t stat0 = (int64_t(b) * heads + h) * t_len;
  const float bias_s = s_idx < s_len ? bias[int64_t(b) * s_len + s_idx] : 0.f;

  float dk_acc[G::kCols], dv_acc[G::kCols];
#pragma unroll
  for (int i = 0; i < G::kCols; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += G::kTile) {
    const int n = min(G::kTile, t_len - t0);
    __syncthreads();  // the previous tile is consumed (and the k, v tiles stored)
    stage_f32<D>(qs, qb, st[1], t0, t_len, G::kTile);
    stage_f32<D>(gs, gb, st[10], t0, t_len, G::kTile);
    if (tid < G::kTile) {
      const bool live = tid < n;
      ms[tid] = live ? m[stat0 + t0 + tid] : 0.f;
      ls[tid] = live ? l[stat0 + t0 + tid] : 1.f;
      des[tid] = live ? delta[stat0 + t0 + tid] : 0.f;
    }
    __syncthreads();

    using Dot = typename G::Dot;
    Dot s[G::kPerLane], dp[G::kPerLane];
    Dot s_part[G::kPerLane][G::kSplit], dp_part[G::kPerLane][G::kSplit];
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i)
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) s_part[i][u] = dp_part[i][u] = 0;
#pragma unroll 4
    for (int d = 0; d < D; d += G::kSplit) {
#pragma unroll
      for (int u = 0; u < G::kSplit; ++u) {
        const Dot kd = G::kStageOwned ? ks[row * DP + d + u] : k_own[d + u];
        const Dot vd = G::kStageOwned ? vs[row * DP + d + u] : v_own[d + u];
#pragma unroll
        for (int i = 0; i < G::kPerLane; ++i) {
          const int j = lane + i * G::kLanes;
          s_part[i][u] = dot_fma(Dot(qs[j * DP + d + u]), kd, s_part[i][u]);
          dp_part[i][u] = dot_fma(Dot(gs[j * DP + d + u]), vd, dp_part[i][u]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      s[i] = pairwise_sum(s_part[i]);
      dp[i] = pairwise_sum(dp_part[i]);
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      const float m_j = ms[j];
      Dot x = s[i] * Dot(scale) + Dot(bias_s);
      if (kCausal && s_idx > t0 + j + causal_offset) x += Dot(kMaskValue);  // past the row's limit
      const Dot p = j < n ? dot_exp(x - Dot(m_j)) / Dot(ls[j]) : Dot(0);
      ps[row * PP + j] = float(p);
      dss[row * PP + j] = m_j <= 0.5f * kMaskValue ? 0.f : float(p * (dp[i] - Dot(des[j])));
    }
    __syncwarp();  // the row's threads see each other's p and ds

    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < G::kCols; ++i) {
        const int c = lane + i * G::kLanes;
        dv_acc[i] = fmaf(p, gs[j * DP + c], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qs[j * DP + c], dk_acc[i]);
      }
    }
  }

  if (s_idx < s_len) {
    const int64_t o = ((int64_t(b) * s_len + s_idx) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < G::kCols; ++i) {
      dk[o + lane + i * G::kLanes] = dk_acc[i] * scale;
      dv[o + lane + i * G::kLanes] = dv_acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma designs
// ---------------------------------------------------------------------------
//
// Tiles are 64-column swizzle atoms (128-byte rows, the 128-byte swizzle),
// D/64 of them side by side (4 in a backward block), each a TMA box of (64
// columns, the tile's rows) read through the 4-D (B, rows, H, D) maps of
// hopper::encode_head_map. x = A.B^T of an owned and a streamed tile is an
// SS wgmma (both K-major), 16 columns a step; acc += X.B an RS wgmma with X
// rounded to bf16 in registers and the streamed tile as an MN-major B, one
// 64-column atom an instruction.

constexpr int kWgRows = 64;       // rows of one consumer warpgroup's accumulator
constexpr int kStages = 2;        // ring depth of the streamed tiles (forward and backward)
constexpr int kAtomCols = 64;     // columns of one swizzle atom / TMA box
constexpr int kRowBytes = 128;
constexpr uint32_t kLayout = hopper::kSwizzle128;
constexpr uint32_t kGroup = 8 * kRowBytes;  // bytes between 8-row groups

// x = A . B^T over the head dim (started, not awaited): A the 64 rows of an
// owned tile at `own` (atoms `own_atom` bytes apart), B a streamed tile of
// 2N rows (atoms `stream_atom` bytes apart); x[4c + 2r + e] is (row r,
// column 8c + 2 (lane % 4) + e) of the 64 x 2N tile
template <int D, int N>
__device__ __forceinline__ void deep_product(float (&x)[N], const uint8_t* own, int own_atom,
                                             const uint8_t* stream, int stream_atom) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int atom = kk / 4;
    const int in_row = (kk % 4) * 32;
    hopper::wgmma_ss<N>(x, hopper::make_desc(own + atom * own_atom + in_row, kGroup, kLayout),
                        hopper::make_desc(stream + atom * stream_atom + in_row, kGroup, kLayout),
                        kk > 0);
  }
}

// a 64 x 2N f32 tile in the accumulator layout, rounded to bf16 as the A
// fragments of its N/8 16-column steps
template <int N>
__device__ __forceinline__ void deep_fragments(const float (&x)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    a[kk][0] = hopper::pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc += A . B (started, not awaited) over K streamed rows: A the fragments
// of a 64 x K tile, B atoms atom0.. of the streamed tile (MN-major)
template <int kHeld, int K>
__device__ __forceinline__ void deep_accumulate(float (&acc)[kHeld][32],
                                                const uint32_t (&a)[K / 16][4],
                                                const uint8_t* stream, int stream_atom,
                                                int atom0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int at = 0; at < kHeld; ++at)
      hopper::wgmma_rs_tb<32>(
          acc[at], a[kk],
          hopper::make_desc(stream + (atom0 + at) * stream_atom + kk * 16 * kRowBytes, kGroup,
                            kLayout));
}

template <int kHeld>
__device__ __forceinline__ void deep_wait_acc(float (&acc)[kHeld][32]) {
#pragma unroll
  for (int at = 0; at < kHeld; ++at) hopper::fence_regs(acc[at]);
}

// rows r of this thread's accumulator (eight apart), atoms atom0.. of the
// (B, n, H, D) `out`, times `mul`, in bf16; rows at or past n are not written
template <int D, int kHeld>
__device__ __forceinline__ void deep_store(const float (&acc)[kHeld][32], __nv_bfloat16* out,
                                           int row0, int n, int heads, int h, int b, int atom0,
                                           float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* o_row = out + ((int64_t(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int at = 0; at < kHeld; ++at)
#pragma unroll
      for (int c = 0; c < kAtomCols / 8; ++c) {
        const int col = (atom0 + at) * kAtomCols + 8 * c + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(
            acc[at][4 * c + 2 * r] * mul, acc[at][4 * c + 2 * r + 1] * mul);
      }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 forward (#1)
// ---------------------------------------------------------------------------
//
// deep_fwd_wgmma_kernel<D, kCausal>: a block owns 128 query rows and 256 head
// columns, all of them at D=256, one half at D=512, where the two blocks of
// a cluster (blockIdx.x = 2 tile + rank) hold the two halves of the same
// rows, one quarter at D=1024 (blockIdx.x = 4 tile + rank). Two
// warpgroups, 64 rows each, share every streamed tile; each holds its rows'
// 64 x 256 f32 output (128 registers a thread) and its own running max and
// sum.
//
// The ring. The block's Q columns (64 KB) are staged once; 64-key tiles of
// K and of V (32 KB each at the block's 256 columns) stream through two
// two-stage rings, the V stage carrying its keys' pad bias (two 64-value
// TMA boxes from the 16-byte boundary at or before the tile's first key,
// on the same barrier). Warp 0 loads: it refills a K stage once both
// warpgroups' products of its tile have read it, and a V stage once both
// have accumulated from it, each a tile ahead of its use; the consumers
// free stages by mbarrier arrivals, one a warp, and no thread waits on a
// block-wide barrier. A call with an odd number of key tiles runs one more
// tile that lies wholly past S (TMA fills it with zeros and its keys are
// masked by index, so it adds nothing), which keeps the loop's two logit
// accumulators in turn.
//
// The pipeline, each warpgroup on its own (tile j; wgmma groups retire in
// order, so waiting for all but the newest retires the older):
//   S_j (Q.K_j^T, 16 SS steps of m64n64k16 over the block's 256 columns)
//   landed -> D=512: its share pushed to the peer block and the peer's
//   share added (own + peer: f32 addition gives both blocks the same bits,
//   so both form the same m, l and P), while PV_{j-1} runs -> S_{j+1}
//   issued -> the softmax of tile j, under S_{j+1}'s product -> PV_{j-1}
//   landed: the output rescaled where a row's max moved -> P_j (bf16,
//   unnormalised) times V_j accumulated (16 RS steps of m64n64k16).
// So each logit tile is computed once, and the exponentials of one tile run
// under the next tile's product. The exchange buffers take the peer's
// share as thread-major float4s written by st.async, whose bytes complete a
// transaction on the receiving warpgroup's barrier; one relaxed arrival a
// warp frees the buffer for the next tile. (Adding the peer's share with
// S_{j+1} already in flight would hide the wait for it behind that product
// too, but holds three logit tiles beside the output and spills: measured
// no faster.)
//
// What the compiler must be kept from (ptxas -v and the SASS): wgmma
// descriptors and shared-memory addresses that never change across the
// loop get hoisted into registers (the base address is made opaque each
// tile, and thread and block indices are read where they are used); the
// bf16 packing of P, or the zeroing of the output, sunk into a product's
// window makes ptxas fence there and serialise every wgmma of the kernel
// (C7519/C7520, C7515): both are pinned by register fences.
//
// Budgets (nvcc -Xptxas -v, sm_90a; D=256 / D=512, without / with kCausal):
// 256 threads, one block an SM; registers 250 / 255 and 238 / 254, zero
// spill bytes; D=1024 237 / 255, zero spill bytes. Shared memory at D=512:
// Q 65,536, the two rings 131,072, two 16 KB exchange buffers 32,768, the
// bias ring 1,024, 13 barriers 104: 230,504 bytes + 1,024 of alignment
// slack; at D=1024 two barriers more (each round's free signal): 230,520 +
// 1,024; at D=256 no exchange buffers: 197,736 + 1,024. A third stage would
// need 64 KB more: it fits none.

constexpr int kFwdCols = 256;                          // head columns a block holds
constexpr int kFwdAtoms = kFwdCols / kAtomCols;        // 4
constexpr int kFwdRows = 2 * kWgRows;                  // query rows a block owns: 64 a warpgroup
constexpr int kFwdKeys = 64;                           // keys a streamed tile
constexpr int kFwdQAtom = kFwdRows * kRowBytes;        // 16 KB: one atom of the Q tile
constexpr int kFwdQBytes = kFwdAtoms * kFwdQAtom;      // 64 KB
constexpr int kFwdKVAtom = kFwdKeys * kRowBytes;       // 8 KB: one atom of a K or V tile
constexpr int kFwdTile = kFwdAtoms * kFwdKVAtom;       // 32 KB
constexpr int kFwdThreads = 256;                       // two warpgroups
constexpr int kFwdXFloats = kWgRows * kFwdKeys;        // one warpgroup's 64 x 64 f32 share: 16 KB
constexpr int kFwdChunk = 128;                         // float4s of one chunk of a share
// a V stage's bias: two 64-value boxes from the 16-byte boundary at or
// before the tile's first key (a TMA box starts on such a boundary)
constexpr int kFwdBiasSlot = 2 * kFwdKeys * 4;

// byte offsets in a forward block's shared memory (kC blocks a cluster);
// the barriers: the Q tile's, then each ring's full and empty [stage], then
// the exchange's full and free [role]
template <int kC>
struct FwdSmem {
  static constexpr int kK = kFwdQBytes;                             // [stage][atom][64 keys]
  static constexpr int kV = kK + kStages * kFwdTile;                // [stage][atom][64 keys]
  static constexpr int kX = kV + kStages * kFwdTile;                // [role][kFwdXFloats]
  static constexpr int kBias = kX + (kC > 1 ? 2 * kFwdXFloats * 4 : 0);  // [stage][128]
  static constexpr int kBars = kBias + kStages * kFwdBiasSlot;
  static constexpr int kQBar = kBars;
  static constexpr int kKFull = kQBar + 8;        // the TMA bytes
  static constexpr int kKEmpty = kKFull + 8 * kStages;   // the 8 warps
  static constexpr int kVFull = kKEmpty + 8 * kStages;   // the TMA bytes (V and its bias)
  static constexpr int kVEmpty = kVFull + 8 * kStages;   // the 8 warps
  static constexpr int kSFull = kVEmpty + 8 * kStages;   // the peer's share is in this block's buffer
  // the peer has read this block's last share: [role] at kC=2, [round][role]
  // at kC=4 (round r's partner is rank ^ 2^r)
  static constexpr int kSFree = kSFull + 16;
  static constexpr int kBytes = kSFree + (kC == 4 ? 32 : 16);
};

// a forward block's constants. Shared memory is named by its 32-bit address
// (`smem`, 1024-aligned) plus FwdSmem's offsets, and a thread's coordinates
// come from its special registers where they are used: each tile makes the
// base opaque to the compiler and reads them anew, so the tile's addresses,
// wgmma descriptors and indices are formed where they are used instead of
// being held in registers across the loop, where the output tile and two
// logit tiles leave little room
struct FwdBlock {
  uint32_t smem;
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  const CUtensorMap* bias_map;  // the (B S) pad bias
  int n_tiles, s_len, causal_offset;
  float scale;
};

// special registers, read at each use (an asm volatile read is neither
// hoisted nor shared between uses)
__device__ __forceinline__ int read_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int read_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int read_ctaid_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}
__device__ __forceinline__ int read_ctaid_z() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(v));
  return v;
}

// the block's rank in its cluster: its column half at D=512, quarter at
// D=1024
template <int kC>
__device__ __forceinline__ int fwd_rank() {
  return kC > 1 ? int(hopper::cluster_rank()) : 0;
}

// a thread's first row (its second is 8 on): its warpgroup's 64 of the
// block's 128, 16 a warp, the accumulator layout's lane / 4
template <int kC>
__device__ __forceinline__ int fwd_row0(int tid) {
  return (read_ctaid_x() / kC) * kFwdRows + (tid / 128) * kWgRows + ((tid % 128) / 32) * 16 +
         (tid % 32) / 4;
}

// the loading warp: key tile `tile` of K into its stage, by TMA
template <int kC>
__device__ __forceinline__ void fill_k(const FwdBlock& c, uint32_t smem, int tile) {
  using L = FwdSmem<kC>;
  if (read_tid() == 0) {
    const int st = tile % kStages;
    const uint32_t bar = smem + L::kKFull + 8 * st;
    hopper::mbar_expect_tx(bar, kFwdTile);
#pragma unroll
    for (int a = 0; a < kFwdAtoms; ++a)
      hopper::tma_load_4d(smem + L::kK + st * kFwdTile + a * kFwdKVAtom, c.k_map, bar,
                          (fwd_rank<kC>() * kFwdAtoms + a) * kAtomCols, read_ctaid_y(),
                          tile * kFwdKeys, read_ctaid_z());
  }
}

// the loading warp: key tile `tile` of V and its keys' pad bias into the V
// stage, by TMA: the bias from the 16-byte boundary at or before the
// tile's first key, (b S) % 4 values early (past S it is another example's
// or zeros: the softmax masks those keys by index)
template <int kC>
__device__ __forceinline__ void fill_v(const FwdBlock& c, uint32_t smem, int tile) {
  using L = FwdSmem<kC>;
  if (read_tid() == 0) {
    const int st = tile % kStages;
    const uint32_t bar = smem + L::kVFull + 8 * st;
    hopper::mbar_expect_tx(bar, kFwdTile + kFwdBiasSlot);
#pragma unroll
    for (int a = 0; a < kFwdAtoms; ++a)
      hopper::tma_load_4d(smem + L::kV + st * kFwdTile + a * kFwdKVAtom, c.v_map, bar,
                          (fwd_rank<kC>() * kFwdAtoms + a) * kAtomCols, read_ctaid_y(),
                          tile * kFwdKeys, read_ctaid_z());
    const int first = (read_ctaid_z() * c.s_len + tile * kFwdKeys) & ~3;
    hopper::tma_load_1d(smem + L::kBias + st * kFwdBiasSlot, c.bias_map, bar, first);
    hopper::tma_load_1d(smem + L::kBias + st * kFwdBiasSlot + kFwdKeys * 4, c.bias_map, bar,
                        first + kFwdKeys);
  }
}

// one warp's arrival on a barrier counting warps
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (read_tid() % 32 == 0) hopper::mbar_arrive(bar);
}

// x = Q.K^T over the block's 256 columns (started, not awaited): 16 SS
// steps of m64n64k16, Q from `q` (the warpgroup's 64 rows of the 128-row
// tile), K from the 64-key tile at `k`, both descriptors of their first atom
__device__ __forceinline__ void fwd_product(float (&x)[32], uint64_t q, uint64_t k) {
#pragma unroll
  for (int kk = 0; kk < kFwdCols / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // 16 columns into the atom's 128-byte rows
    hopper::wgmma_ss<32>(x, hopper::desc_add(q, (kk / 4) * kFwdQAtom + step),
                         hopper::desc_add(k, (kk / 4) * kFwdKVAtom + step), kk > 0);
  }
}

// o += P.V (started, not awaited): 16 RS steps of m64n64k16, P as the A
// fragments of a 64 x 64 tile, V the 64-key tile at `v` (MN-major)
__device__ __forceinline__ void fwd_accumulate(float (&o)[kFwdAtoms][32],
                                               const uint32_t (&pa)[4][4], uint64_t v) {
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk)
#pragma unroll
    for (int at = 0; at < kFwdAtoms; ++at)
      hopper::wgmma_rs_tb<32>(o[at], pa[kk],
                              hopper::desc_add(v, at * kFwdKVAtom + kk * 16 * kRowBytes));
}

// key tile j (in ring stage kStage = j % 2) of one warpgroup. On entry S_j
// is in flight into `cur` (or landed) and PV_{j-1} into `o`; on return
// S_{j+1} into `nxt` and PV_j. The wgmma groups retire in order, so wait<1>
// retires all but the newer of the two in flight.
template <int kC, bool kCausal, int kStage>
__device__ __forceinline__ void fwd_tile(const FwdBlock& c, int j, float (&cur)[32],
                                         float (&nxt)[32], float (&o)[kFwdAtoms][32],
                                         float (&m_run)[2], float (&l_run)[2]) {
  static_assert(kStages == 2, "the loop takes the ring's two stages in turn");
  using L = FwdSmem<kC>;
  constexpr int stage = kStage;
  constexpr int other = kStage ^ 1;  // the stage of tiles j - 1 and j + 1
  uint32_t smem = c.smem;
  asm volatile("" : "+r"(smem));  // formed again each tile, not held across the loop
  const int tid = read_tid();
  const int role = tid / 128;  // the warpgroup: rows 64 role .. of the block

  // S_j has landed (PV_{j-1} may still run): its K stage is read
  hopper::wgmma_wait<1>();
  hopper::fence_regs(cur);
  warp_arrive(smem + L::kKEmpty + 8 * stage);
  // this thread's float4 of each 128-float4 chunk of its warpgroup's share
  const uint32_t share = L::kX + role * kFwdXFloats * 4 + 16 * (tid % 128);
  if constexpr (kC == 2) {
    // this block's share to the peer, once the peer has read the last; then
    // the peer's share added to it (and the buffer armed for the next), while
    // PV_{j-1} runs: no second logit tile is in flight beside the sum
    const uint32_t peer = hopper::map_peer(smem, uint32_t(fwd_rank<kC>() ^ 1));
    if (j > 0) hopper::mbar_wait_cluster(smem + L::kSFree + 8 * role, (j - 1) & 1);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      hopper::store_async_f32x4(peer + share + q * kFwdChunk * 16, peer + L::kSFull + 8 * role,
                                make_float4(cur[4 * q], cur[4 * q + 1], cur[4 * q + 2],
                                            cur[4 * q + 3]));
    hopper::mbar_wait_cluster(smem + L::kSFull + 8 * role, j & 1);
    if (tid % 128 == 0 && j + 1 < c.n_tiles)
      hopper::mbar_expect_tx(smem + L::kSFull + 8 * role, kFwdXFloats * 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 v = hopper::ld_shared_f32x4(smem + share + q * kFwdChunk * 16);
      cur[4 * q] += v.x, cur[4 * q + 1] += v.y, cur[4 * q + 2] += v.z, cur[4 * q + 3] += v.w;
    }
    __syncwarp();
    if (tid % 32 == 0)
      hopper::mbar_arrive_cluster_relaxed(
          hopper::map_peer(smem + L::kSFree + 8 * role, uint32_t(fwd_rank<kC>() ^ 1)));
  } else if constexpr (kC == 4) {
    // a butterfly in two rounds through the same buffer: round r trades the
    // running sum with block rank ^ 2^r, so every block ends with
    // (s0 + s1) + (s2 + s3) (each round's own + partner is the same f32 sum
    // in both blocks): the same bits in all four, so the same m, l and P
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      const uint32_t rank = uint32_t(fwd_rank<kC>());
      const uint32_t peer = hopper::map_peer(smem, rank ^ (1u << round));
      // the partner has read what its other partner last pushed to it
      if (round == 1 || j > 0)
        hopper::mbar_wait_cluster(smem + L::kSFree + 8 * (2 * round + role),
                                  (round == 0 ? j - 1 : j) & 1);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        hopper::store_async_f32x4(peer + share + q * kFwdChunk * 16, peer + L::kSFull + 8 * role,
                                  make_float4(cur[4 * q], cur[4 * q + 1], cur[4 * q + 2],
                                              cur[4 * q + 3]));
      hopper::mbar_wait_cluster(smem + L::kSFull + 8 * role, round);
      if (tid % 128 == 0 && (round == 0 || j + 1 < c.n_tiles))
        hopper::mbar_expect_tx(smem + L::kSFull + 8 * role, kFwdXFloats * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = hopper::ld_shared_f32x4(smem + share + q * kFwdChunk * 16);
        cur[4 * q] += v.x, cur[4 * q + 1] += v.y, cur[4 * q + 2] += v.z, cur[4 * q + 3] += v.w;
      }
      // the buffer is free for the other round's partner (the reads' values
      // used first)
      hopper::fence_regs(cur);
      __syncwarp();
      if (tid % 32 == 0)
        hopper::mbar_arrive_cluster_relaxed(hopper::map_peer(
            smem + L::kSFree + 8 * (2 * (round ^ 1) + role), rank ^ (2u >> round)));
    }
  }

  // S_{j+1}, under this tile's softmax (past the last tile it repeats a
  // landed stage's product into nxt, which nothing reads)
  if (j + 1 < c.n_tiles) hopper::mbar_wait(smem + L::kKFull + 8 * other, ((j + 1) / kStages) & 1);
  hopper::wgmma_fence();
  const uint64_t desc = hopper::make_desc(smem, kGroup, kLayout);
  fwd_product(nxt, hopper::desc_add(desc, role * kWgRows * kRowBytes),
              hopper::desc_add(desc, L::kK + other * kFwdTile));
  hopper::wgmma_commit();
  if (tid < 32 && j + 2 < c.n_tiles) {  // warp 0: K_{j+2} into the stage S_j freed
    hopper::mbar_wait(smem + L::kKEmpty + 8 * stage, (j / kStages) & 1);
    fill_k<kC>(c, smem, j + 2);
  }

  // logits: scale, pad bias, then the causal bias by index; keys past S
  // masked by index (-inf: no weight, and no say in the max); every value
  // computed, then selected (no branch an element)
  hopper::mbar_wait(smem + L::kVFull + 8 * stage, (j / kStages) & 1);
  const int col = 2 * (tid % 4);  // this thread's first column of each 8-column chunk
  const uint32_t bias_t = smem + L::kBias + stage * kFwdBiasSlot +
                          4 * ((read_ctaid_z() * c.s_len) % 4 + col);
  const int s0 = j * kFwdKeys + col;  // this thread's first key of the tile
  const int key_limit = kCausal ? fwd_row0<kC>(tid) + c.causal_offset : 0;  // its first row's last key
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
    const int key = s0 + 8 * cc;
    const float b0 = hopper::ld_shared_f32(bias_t + 4 * 8 * cc);
    const float b1 = hopper::ld_shared_f32(bias_t + 4 * (8 * cc + 1));
    const float bias_e[2] = {key < c.s_len ? b0 : -INFINITY, key + 1 < c.s_len ? b1 : -INFINITY};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaf(cur[4 * cc + 2 * r + e], c.scale, bias_e[e]);
        if (kCausal) x += key + e > key_limit + 8 * r ? kMaskValue : 0.f;
        cur[4 * cc + 2 * r + e] = x;
        tile_max[r] = fmaxf(tile_max[r], x);
      }
    }
  }
  float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m_run[r], tile_max[r]);
    alpha[r] = hopper::exp2_ftz((m_run[r] - m_new) * kLog2e);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = hopper::exp2_ftz((cur[i] - m_run[(i / 2) % 2]) * kLog2e);
    row_sum[(i / 2) % 2] += p;
    cur[i] = p;
  }
  // this thread's share of each row's sum; the row's four threads add
  // theirs at the end
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + row_sum[r];
  uint32_t pa[4][4];  // P (bf16, unnormalised) as A fragments
  deep_fragments(cur, pa);
  hopper::fence_regs(pa);  // packed here, not at the wgmma that reads them (ptxas would
                           // fence there and serialise the products: C7519, C7520)

  // PV_{j-1} has landed: o is free, and V_{j-1}'s stage takes V_{j+1}
  uint32_t smem_pv = c.smem;
  asm volatile("" : "+r"(smem_pv));  // formed anew: nothing of the above held over the softmax
  hopper::wgmma_wait<1>();
  deep_wait_acc(o);
  if (j > 0) warp_arrive(smem_pv + L::kVEmpty + 8 * other);
  if (read_tid() < 32 && j > 0 && j + 1 < c.n_tiles) {
    hopper::mbar_wait(smem_pv + L::kVEmpty + 8 * other, ((j - 1) / kStages) & 1);
    fill_v<kC>(c, smem_pv, j + 1);
  }
  // rescaled only where a row's max moved (alpha is exactly 1 where it did
  // not, so the skip changes no bit), one vote a warp
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
  for (int a = 0; a < kFwdAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i / 2) % 2];
  deep_wait_acc(o);
  hopper::wgmma_fence();
  fwd_accumulate(o, pa,
                 hopper::desc_add(hopper::make_desc(smem_pv, kGroup, kLayout),
                                  L::kV + stage * kFwdTile));
  hopper::wgmma_commit();
}

// The forward. One block per (128 query rows, column half at D=512 or
// quarter at D=1024, head, batch); blockIdx.x / (D / 256) is the row tile,
// the cluster rank the column share.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, 1)
deep_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap bias_map,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t_len, int s_len, int heads,
                      int causal_offset, float scale) {
  constexpr int kC = D / kFwdCols;
  using L = FwdSmem<kC>;
  extern __shared__ uint8_t smem_raw[];
  FwdBlock c;
  c.smem = hopper::smem_u32(hopper::align_1024(smem_raw));
  c.k_map = &k_map;
  c.v_map = &v_map;
  c.bias_map = &bias_map;
  const int n_keys = (s_len + kFwdKeys - 1) / kFwdKeys;
  c.n_tiles = n_keys + (n_keys & 1);  // even: the loop takes two tiles a turn
  c.s_len = s_len;
  c.causal_offset = causal_offset;
  c.scale = scale;

  const uint32_t smem = c.smem;
  if (threadIdx.x == 0) {
    uint8_t* base = hopper::align_1024(smem_raw);
    auto init = [&](int offset, uint32_t count) {
      hopper::mbar_init(reinterpret_cast<uint64_t*>(base + offset), count);
    };
    init(L::kQBar, 1);
    for (int st = 0; st < kStages; ++st) {
      init(L::kKFull + 8 * st, 1);
      init(L::kKEmpty + 8 * st, kFwdThreads / 32);
      init(L::kVFull + 8 * st, 1);
      init(L::kVEmpty + 8 * st, kFwdThreads / 32);
    }
    // a share lands by st.async: one arrival (arming it for the share's
    // bytes) a tile; the peer warpgroup's four warps free the buffer
    for (int role = 0; role < 2; ++role) {
      init(L::kSFull + 8 * role, 1);
      if (kC > 1) hopper::mbar_expect_tx(smem + L::kSFull + 8 * role, kFwdXFloats * 4);
      init(L::kSFree + 8 * role, 4);
      if (kC == 4) init(L::kSFree + 8 * (2 + role), 4);
    }
    hopper::fence_barrier_init();
  }
  if constexpr (kC > 1)
    hopper::cluster_sync();  // the peers' barriers are initialised before any arrival
  else
    __syncthreads();

  // warp 0 loads the Q tile and the first two stages of each ring
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(smem + L::kQBar, kFwdQBytes);
#pragma unroll
      for (int a = 0; a < kFwdAtoms; ++a)
        hopper::tma_load_4d(smem + a * kFwdQAtom, &q_map, smem + L::kQBar,
                            (fwd_rank<kC>() * kFwdAtoms + a) * kAtomCols, blockIdx.y,
                            (blockIdx.x / kC) * kFwdRows, blockIdx.z);
    }
    for (int tile = 0; tile < kStages; ++tile) {
      fill_k<kC>(c, smem, tile);
      fill_v<kC>(c, smem, tile);
    }
  }

  float o[kFwdAtoms][32];
#pragma unroll
  for (int a = 0; a < kFwdAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  // zeroed here: sunk into the first product's window, the zeroing would make
  // ptxas serialise every wgmma of the kernel (C7515)
  deep_wait_acc(o);
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.f, 0.f};
  float s_a[32], s_b[32];

  // S_0, and an empty group where PV_{-1} would be
  hopper::mbar_wait(smem + L::kQBar, 0);
  hopper::mbar_wait(smem + L::kKFull, 0);
  hopper::wgmma_fence();
  const uint64_t desc = hopper::make_desc(smem, kGroup, kLayout);
  fwd_product(s_a, hopper::desc_add(desc, (threadIdx.x / 128) * kWgRows * kRowBytes),
              hopper::desc_add(desc, L::kK));
  hopper::wgmma_commit();
  hopper::wgmma_commit();
  for (int j = 0; j < c.n_tiles; j += 2) {
    fwd_tile<kC, kCausal, 0>(c, j, s_a, s_b, o, m_run, l_run);
    fwd_tile<kC, kCausal, 1>(c, j + 1, s_b, s_a, o, m_run, l_run);
  }
  hopper::wgmma_wait<0>();
  deep_wait_acc(o);
  hopper::fence_regs(s_a);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int a = 0; a < kFwdAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] /= l_run[(i / 2) % 2];
  const int rank = fwd_rank<kC>();
  const int tid = read_tid();
  const int row0 = fwd_row0<kC>(tid);
  const int h = read_ctaid_y(), b = read_ctaid_z();
  deep_store<D, kFwdAtoms>(o, out, row0, t_len, heads, h, b, rank * kFwdAtoms, 1.f);
  if (rank == 0 && m_out != nullptr && tid % 4 == 0) {  // the row's four threads hold equal m, l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t >= t_len) continue;
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m_run[r];
      l_out[stat] = l_run[r];
    }
  }
  if constexpr (kC > 1) hopper::cluster_sync();  // no block leaves while a peer writes to it
}

// ---------------------------------------------------------------------------
// bfloat16 backward: dq (#2) and dk/dv (#3), one design for both
// ---------------------------------------------------------------------------
//
// deep_bwd_kernel<D, kCausal, kDq> computes dq (kDq) or dk and dv. A block
// owns 64 rows (queries for dq, keys for dk/dv) and 256 head columns: all
// of them at D=256, one half at D=512, where the two blocks of a cluster
// (blockIdx.x = 2 tile + rank) hold the two halves of the same rows, one
// quarter at D=1024 (four blocks, blockIdx.x = 4 tile + rank).
//
// Tiles and stages. The owned pair (Q, G or K, V: 2 x 32 KB) is staged once;
// 64-row tiles of the other side (K, V or Q, G: 64 KB a stage) stream
// through a two-stage TMA ring, with the tile's vector beside them (dq: the
// keys' bias; dk/dv: the queries' m, 1/l, delta). Warp 0 loads: a stage is
// refilled, one tile ahead, as soon as both warpgroups have freed it
// (mbarriers; its vector fetched into registers a tile before that), so
// no thread waits on a block-wide barrier for a load.
//
// The logit tiles, once each. The first warpgroup computes the block's
// share of S (dq: Q.K^T; dk/dv: S^T = K.Q^T), the second of dP (G.V^T;
// dP^T = V.G^T): an m64n64 tile over the block's 256 columns, 16 SS steps
// of m64n64k16, so no product is computed twice. The shares meet in two
// 16 KB buffers, thread-major float4s:
// - D=256: each warpgroup writes the half of its share the other reads.
// - D=512: each warpgroup pushes its whole share into the peer block's
//   buffer with st.async, whose bytes complete a transaction on the
//   receiving barrier (no fence), then adds the peer's share to its own,
//   keeping its half in registers and writing the other half back for the
//   other warpgroup. Every sum is own + peer, so f32 addition gives both
//   blocks the same bits. The peer's warps free the buffer for the next
//   tile with one arrival each.
// - D=1024: the same in two rounds through the same buffer: the share goes
//   to block rank ^ 1 and comes back summed with it; that pair's sum goes
//   to block rank ^ 2 (once that block has read its first round: a
//   per-role free barrier) and is added as the D=512 step adds, so every
//   block holds (s0 + s1) + (s2 + s3).
// Then each warpgroup forms p and ds for its half of the tile's 64 streamed
// rows (16 elements a thread, computed then selected, no branch), rounds
// them to bf16 A fragments, and hands the other warpgroup the fragments it
// needs (dq: ds; dk/dv: ds to the second, p to the first) through the half
// of its buffer that only it had read. Its own k-steps are issued (RS,
// m64n64k16 an atom) before the hand-over, the other's after: dq's 4
// column atoms split 2 + 2 between the warpgroups; dv (first) and dk
// (second) take 4 atoms each, 128 registers.
//
// Budgets (nvcc -Xptxas -v, sm_90a; D=256 / D=512, without / with
// kCausal): 256 threads, one block an SM; shared memory 231,000 bytes +
// 1,088 of alignment slack; registers dq 144 / 141 and 164 / 168, dk/dv
// 200 / 202 and 213 / 214, zero spill bytes; D=1024 dq 174 / 170, dk/dv
// 236 / 236, zero spill bytes (under the 255 of 256 threads;
// a producer warpgroup with setmaxnreg left dk/dv about 200 and it
// spilled). Nothing is reduced across blocks: each block writes its own
// rows and columns.

constexpr int kBwdCols = 256;                       // head columns a block holds
constexpr int kBwdAtoms = kBwdCols / kAtomCols;     // 4
constexpr int kBwdRows = 64;                        // owned rows, and rows of a streamed tile
constexpr int kBwdAtom = kBwdRows * kRowBytes;      // 8 KB: one atom of a 64-row tile
constexpr int kBwdTile = kBwdAtoms * kBwdAtom;      // 32 KB: one operand's tile
constexpr int kBwdThreads = 256;                    // two warpgroups
constexpr int kXFloats = kBwdRows * kBwdRows;       // one 64 x 64 f32 share: 16 KB
constexpr int kVecFloats = 3 * kBwdRows;            // a streamed tile's vectors
// the owned pair, the ring's pairs, two exchange buffers, the vector ring
// and eleven barriers: 231,000 bytes
constexpr size_t kBwdBytes = size_t(2 + 2 * kStages) * kBwdTile + 2 * sizeof(float) * kXFloats +
                             kStages * sizeof(float) * kVecFloats + 11 * sizeof(uint64_t);

// a backward block's shared memory and coordinates
struct BwdBlock {
  uint8_t* own;     // [operand][atom][64 rows]: Q, G (dq) or K, V (dk/dv)
  uint8_t* ring;    // [stage][operand][atom][64 rows]: K, V (dq) or Q, G (dk/dv)
  float* xbuf;      // [role][kXFloats]: the S and dP shares, thread-major float4s
  float* vec;       // [stage][kVecFloats]
  uint64_t* full;   // [stage] the loading warp's 32 lanes and the TMA bytes
  uint64_t* empty;  // [stage] the 256 threads
  uint64_t* own_bar;
  uint64_t* sfull;  // [role] the peer's share of that role is in this block's buffer
  uint64_t* sfree;  // the peer's buffers are free for this block's shares
  uint64_t* sfree1;  // [role] kC=4: block rank ^ 2's buffer of that role is free for its round
  const CUtensorMap* maps[4];  // own0, own1, str0, str1
  int rank, own0, n_tiles, t_len, s_len, heads, h, b, causal_offset;
  float scale;
};


// a streamed tile's vector, as the lanes of the loading warp hold it: rows
// lane and lane + 32 of the tile (dq: the keys' bias; dk/dv: the queries'
// m, 1/l, delta), zeros past the end
struct TileVec {
  float v[3][2];
};

template <bool kDq>
__device__ __forceinline__ TileVec fetch_vec(const BwdBlock& c, int tile,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ m,
                                             const float* __restrict__ l,
                                             const float* __restrict__ delta) {
  const int lane = threadIdx.x % 32;
  TileVec out;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = tile * kBwdRows + lane + 32 * k;
    const bool valid = r < (kDq ? c.s_len : c.t_len);
    if constexpr (kDq) {
      out.v[0][k] = valid ? bias[int64_t(c.b) * c.s_len + r] : 0.f;
    } else {
      const int64_t stat = (int64_t(c.b) * c.heads + c.h) * c.t_len + r;
      out.v[0][k] = valid ? m[stat] : 0.f;
      out.v[1][k] = valid ? l[stat] : 0.f;  // inverted in fill_stage, once it has landed
      out.v[2][k] = valid ? delta[stat] : 0.f;
    }
  }
  return out;
}

// the loading warp (warp 0): streamed tile `tile` into ring stage `stage`,
// by TMA, and its vector; the stage's full barrier takes the 32 lanes'
// arrivals and the TMA bytes
template <bool kDq>
__device__ __forceinline__ void fill_stage(const BwdBlock& c, int stage, int tile,
                                           const TileVec& vec) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    uint8_t* dst = c.ring + stage * 2 * kBwdTile;
    hopper::mbar_expect_tx(&c.full[stage], 2 * kBwdTile);
#pragma unroll
    for (int a = 0; a < kBwdAtoms; ++a) {
      const int col = (c.rank * kBwdAtoms + a) * kAtomCols;
      hopper::tma_load_4d(dst + a * kBwdAtom, c.maps[2], &c.full[stage], col, c.h,
                          tile * kBwdRows, c.b);
      hopper::tma_load_4d(dst + kBwdTile + a * kBwdAtom, c.maps[3], &c.full[stage], col, c.h,
                          tile * kBwdRows, c.b);
    }
  }
  float* dst = c.vec + stage * kVecFloats;
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int w = 0; w < (kDq ? 1 : 3); ++w)
      dst[w * kBwdRows + lane + 32 * k] =
          (!kDq && w == 1) ? (vec.v[1][k] != 0.f ? 1.f / vec.v[1][k] : 0.f) : vec.v[w][k];
  if (lane != 0) hopper::mbar_arrive(&c.full[stage]);
}

// a warpgroup of role kRole: 0 computes the S share (and dv in
// dk/dv), 1 the dP share (and dk); in dq both accumulate dq, atoms 2 kRole
// and 2 kRole + 1 of the block's four. Each forms p and ds for its half of
// the tile's 64 streamed rows (chunks 4 kRole .. 4 kRole + 3 of the
// accumulator layout, k-steps 2 kRole and 2 kRole + 1) and hands the other
// the bf16 fragments it needs (dq: ds; dk/dv: ds to the second, p to the
// first) through the half of its share that no warpgroup of its block reads
template <int D, bool kCausal, bool kDq, int kRole>
__device__ __forceinline__ void deep_bwd_warpgroup(const BwdBlock& c,
                                                  const float* __restrict__ bias,
                                                  const float* __restrict__ m,
                                                  const float* __restrict__ l,
                                                  const float* __restrict__ delta,
                                                  __nv_bfloat16* __restrict__ out) {
  constexpr int kC = D / kBwdCols;  // blocks of a cluster
  constexpr int kHeld = kDq ? kBwdAtoms / 2 : kBwdAtoms;
  constexpr int kQ0 = 4 * kRole;    // the first chunk of this role's half
  constexpr int kChunk = 128;       // float4s of one chunk of a share (one a thread)
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int row0 = c.own0 + warp * 16 + lane / 4;  // this thread's rows: r = 0 and r = 1 (eight apart)
  const int col_in_chunk = 2 * (lane % 4);
  const uint32_t peer = uint32_t(c.rank ^ 1);

  // the owned rows' constants: dq's statistics (a row past T, or one whose
  // keys are all masked, gets ds = 0), dk/dv's key bias
  float m_r[2], inv_l[2], delta_r[2], bias_r[2];
  bool zero_ds[2], key_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if constexpr (kDq) {
      const bool valid = row < c.t_len;
      const int64_t stat = (int64_t(c.b) * c.heads + c.h) * c.t_len + row;
      m_r[r] = valid ? m[stat] : 0.f;
      inv_l[r] = valid ? 1.f / l[stat] : 0.f;
      delta_r[r] = valid ? delta[stat] : 0.f;
      zero_ds[r] = !valid || m_r[r] <= 0.5f * kMaskValue;
    } else {
      key_valid[r] = row < c.s_len;
      bias_r[r] = key_valid[r] ? bias[int64_t(c.b) * c.s_len + row] : 0.f;
    }
  }

  float acc[kHeld][32];
#pragma unroll
  for (int a = 0; a < kHeld; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float4* const shares = reinterpret_cast<float4*>(c.xbuf);  // [role][chunk][thread]
  float4* const mine = shares + kRole * 8 * kChunk;           // this role's: S or dP
  const float4* const theirs = shares + (1 - kRole) * 8 * kChunk;
  // the fragments for the other role go to this role's own half of its
  // share, which only this warpgroup reads, and come from the other's
  uint4* const drop = reinterpret_cast<uint4*>(mine + kQ0 * kChunk);
  const uint4* const pick = reinterpret_cast<const uint4*>(theirs + (4 - kQ0) * kChunk);

  // warp 0 of the first warpgroup loads: the owned tiles and the first
  // stages now, each later tile into the stage its predecessor freed, one
  // tile ahead (its vector fetched a tile before that)
  const bool loader = kRole == 0 && warp == 0;
  TileVec next;
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(c.own_bar, 2 * kBwdTile);
#pragma unroll
      for (int a = 0; a < kBwdAtoms; ++a) {
        const int col = (c.rank * kBwdAtoms + a) * kAtomCols;
        hopper::tma_load_4d(c.own + a * kBwdAtom, c.maps[0], c.own_bar, col, c.h, c.own0, c.b);
        hopper::tma_load_4d(c.own + kBwdTile + a * kBwdAtom, c.maps[1], c.own_bar, col, c.h,
                            c.own0, c.b);
      }
    }
    for (int st = 0; st < kStages && st < c.n_tiles; ++st)
      fill_stage<kDq>(c, st, st, fetch_vec<kDq>(c, st, bias, m, l, delta));
    if (kStages < c.n_tiles) next = fetch_vec<kDq>(c, kStages, bias, m, l, delta);
  }

  // at tile j, once both warpgroups are done with tile j - 1: its stage
  // takes tile j + 1
  auto refill = [&](int j) {
    if (loader && j >= 1 && j + 1 < c.n_tiles) {
      const int free_stage = (j + 1) % kStages;
      hopper::mbar_wait(&c.empty[free_stage], ((j - 1) / kStages) & 1);
      fill_stage<kDq>(c, free_stage, j + 1, next);
      if (j + 2 < c.n_tiles) next = fetch_vec<kDq>(c, j + 2, bias, m, l, delta);
    }
  };

  hopper::mbar_wait(c.own_bar, 0);
  for (int j = 0; j < c.n_tiles; ++j) {
    const int stage = j % kStages;
    hopper::mbar_wait(&c.full[stage], (j / kStages) & 1);
    const uint8_t* str = c.ring + stage * 2 * kBwdTile;
    const float* vec = c.vec + stage * kVecFloats;

    float x[32];  // this role's share, over the block's 256 columns
    hopper::wgmma_fence();
    deep_product<kBwdCols, 32>(x, c.own + kRole * kBwdTile, kBwdAtom, str + kRole * kBwdTile,
                               kBwdAtom);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(x);

    // S and dP over this role's half of the tile: the own share's half in
    // own[], the other's in oth[] (each own + peer at D=512)
    float own[16], oth[16];
    if constexpr (kC == 1) {
      hopper::named_sync(1, kBwdThreads);  // the last tile's buffers are read
      refill(j);
      // the other role reads the other half of the share
#pragma unroll
      for (int q = 4 - kQ0; q < 8 - kQ0; ++q)
        mine[q * kChunk + t] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
#pragma unroll
      for (int i = 0; i < 16; ++i) own[i] = x[4 * kQ0 + i];
    } else {
      // push the share into the peer's buffer once the peer has read it,
      // and refill the ring while it flies
      if (j > 0) hopper::mbar_wait_cluster(c.sfree, (j - 1) & 1);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        hopper::store_async_peer_f32x4(
            mine + q * kChunk + t, &c.sfull[kRole], peer,
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
      refill(j);
      if constexpr (kC == 4) {
        // a butterfly in two rounds through the same buffer: the share
        // above went to block rank ^ 1, and x becomes that pair's sum; the
        // sum goes to block rank ^ 2 and comes back as (s0 + s1) + (s2 + s3)
        // (each round's own + partner is the same f32 sum in both blocks):
        // the same bits in all four blocks
        hopper::mbar_wait_cluster(&c.sfull[kRole], 0);
        if (t == 0) hopper::mbar_expect_tx(&c.sfull[kRole], kXFloats * 4);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 v = mine[q * kChunk + t];
          x[4 * q] += v.x, x[4 * q + 1] += v.y, x[4 * q + 2] += v.z, x[4 * q + 3] += v.w;
        }
        hopper::fence_regs(x);  // the reads' values used before the buffer is handed on
        __syncwarp();  // the buffer is free for block rank ^ 2's round
        if (lane == 0) hopper::mbar_arrive_peer_relaxed(&c.sfree1[kRole], uint32_t(c.rank ^ 2));
        hopper::mbar_wait_cluster(&c.sfree1[kRole], j & 1);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          hopper::store_async_peer_f32x4(
              mine + q * kChunk + t, &c.sfull[kRole], uint32_t(c.rank ^ 2),
              make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
      }
      // the peer's share of this role is in this block's buffer (and the
      // barrier is armed for the next tile's): this role's half stays in
      // registers, the other half goes back whole for the other role
      hopper::mbar_wait_cluster(&c.sfull[kRole], kC == 4 ? 1 : j & 1);
      if (t == 0 && j + 1 < c.n_tiles) hopper::mbar_expect_tx(&c.sfull[kRole], kXFloats * 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = mine[q * kChunk + t];
        const float4 sum = make_float4(x[4 * q] + v.x, x[4 * q + 1] + v.y, x[4 * q + 2] + v.z,
                                       x[4 * q + 3] + v.w);
        if (q / 4 == kRole) {
          own[4 * (q % 4)] = sum.x, own[4 * (q % 4) + 1] = sum.y;
          own[4 * (q % 4) + 2] = sum.z, own[4 * (q % 4) + 3] = sum.w;
        } else {
          mine[q * kChunk + t] = sum;
        }
      }
    }
    hopper::named_sync(2, kBwdThreads);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = theirs[(kQ0 + q) * kChunk + t];
      oth[4 * q] = v.x, oth[4 * q + 1] = v.y, oth[4 * q + 2] = v.z, oth[4 * q + 3] = v.w;
    }

    // p and ds of the half, as bf16 A fragments; streamed rows past the
    // end masked by index, the causal bias by index after the pad bias;
    // every value computed, then selected (no branch an element)
    const int s0 = j * kBwdRows;
    uint32_t p_frag[2][4], ds_frag[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cc = kQ0 + q;
      float pv[4], dsv[4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int i = 4 * q + k4;  // x[4 cc + 2 r + e]
        const int r = k4 / 2;
        const int col = 8 * cc + col_in_chunk + k4 % 2;
        const int other = s0 + col;  // the streamed row: a key (dq) or a query (dk/dv)
        const float s_val = kRole == 0 ? own[i] : oth[i];
        const float dp_val = kRole == 0 ? oth[i] : own[i];
        if constexpr (kDq) {
          const bool valid = other < c.s_len;
          float logit = fmaf(s_val, c.scale, vec[col]);
          if (kCausal) logit += other > row0 + 8 * r + c.causal_offset ? kMaskValue : 0.f;
          const float e = hopper::exp2_ftz((logit - m_r[r]) * kLog2e) * inv_l[r];
          const float p = valid ? e : 0.f;
          const float ds = p * (dp_val - delta_r[r]);
          pv[k4] = p;
          dsv[k4] = zero_ds[r] ? 0.f : ds;
        } else {
          const bool valid = other < c.t_len;
          const float m_c = vec[col];
          float logit = fmaf(s_val, c.scale, bias_r[r]);
          if (kCausal) logit += row0 + 8 * r > other + c.causal_offset ? kMaskValue : 0.f;
          const float e = hopper::exp2_ftz((logit - m_c) * kLog2e) * vec[kBwdRows + col];
          const float p = valid && key_valid[r] ? e : 0.f;
          const float ds = p * (dp_val - vec[2 * kBwdRows + col]);
          pv[k4] = p;
          dsv[k4] = (!valid || m_c <= 0.5f * kMaskValue) ? 0.f : ds;
        }
      }
      p_frag[q / 2][2 * (q % 2)] = hopper::pack_bf16x2(pv[0], pv[1]);
      p_frag[q / 2][2 * (q % 2) + 1] = hopper::pack_bf16x2(pv[2], pv[3]);
      ds_frag[q / 2][2 * (q % 2)] = hopper::pack_bf16x2(dsv[0], dsv[1]);
      ds_frag[q / 2][2 * (q % 2) + 1] = hopper::pack_bf16x2(dsv[2], dsv[3]);
    }

    // the other role's fragments: ds in dq; in dk/dv the first role keeps
    // p and gives ds, the second keeps ds and gives p
    constexpr bool kKeepP = !kDq && kRole == 0;
    constexpr bool kGiveDs = kDq || kKeepP;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if constexpr (kGiveDs)
        drop[kk * kChunk + t] =
            make_uint4(ds_frag[kk][0], ds_frag[kk][1], ds_frag[kk][2], ds_frag[kk][3]);
      else
        drop[kk * kChunk + t] =
            make_uint4(p_frag[kk][0], p_frag[kk][1], p_frag[kk][2], p_frag[kk][3]);
    }
    // dq += ds.K; dv += p^T.G; dk += ds^T.Q: this role's k-steps while
    // the other's fragments come over, then the other's
    const uint8_t* acc_b = kDq ? str : str + (1 - kRole) * kBwdTile;
    const int acc_atom0 = kDq ? kRole * kHeld : 0;
    uint32_t keep[2][4], got[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep[kk][e] = kKeepP ? p_frag[kk][e] : ds_frag[kk][e];
    hopper::wgmma_fence();  // this role's 32 streamed rows, then the other's
    deep_accumulate<kHeld, 32>(acc, keep, acc_b + kRole * 32 * kRowBytes, kBwdAtom, acc_atom0);
    hopper::wgmma_commit();
    hopper::named_sync(3, kBwdThreads);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint4 v = pick[kk * kChunk + t];
      got[kk][0] = v.x, got[kk][1] = v.y, got[kk][2] = v.z, got[kk][3] = v.w;
    }
    hopper::wgmma_fence();
    deep_accumulate<kHeld, 32>(acc, got, acc_b + (1 - kRole) * 32 * kRowBytes, kBwdAtom,
                               acc_atom0);
    hopper::wgmma_commit();
    if constexpr (kC > 1) {  // this warp's reads of both buffers have landed: the peer may push
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive_peer_relaxed(c.sfree, peer);
    }
    hopper::wgmma_wait<0>();
    deep_wait_acc(acc);
    hopper::mbar_arrive(&c.empty[stage]);
  }

  const int atom0 = c.rank * kBwdAtoms + (kDq ? kRole * kHeld : 0);
  const int own_len = kDq ? c.t_len : c.s_len;
  const float mul = (kDq || kRole == 1) ? c.scale : 1.f;
  deep_store<D, kHeld>(acc, out, row0, own_len, c.heads, c.h, c.b, atom0, mul);
}

// dq (kDq: own Q and G, stream K and V, out0 = dq) or dk/dv (own K and V,
// stream Q and G, out0 = dv, out1 = dk). One block per (64 owned rows,
// column half at D=512, head, batch); blockIdx.x / (D / 256) is the row
// tile, the cluster rank the column half.
template <int D, bool kCausal, bool kDq>
__global__ void __launch_bounds__(kBwdThreads, 1)
deep_bwd_kernel(const __grid_constant__ CUtensorMap own0_map,
                const __grid_constant__ CUtensorMap own1_map,
                const __grid_constant__ CUtensorMap str0_map,
                const __grid_constant__ CUtensorMap str1_map, const float* __restrict__ bias,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ out0,
                __nv_bfloat16* __restrict__ out1, int t_len, int s_len, int heads,
                int causal_offset, float scale) {
  constexpr int kC = D / kBwdCols;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  BwdBlock c;
  c.own = smem;
  c.ring = smem + 2 * kBwdTile;
  c.xbuf = reinterpret_cast<float*>(smem + (2 + 2 * kStages) * kBwdTile);
  c.vec = c.xbuf + 2 * kXFloats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(c.vec + kStages * kVecFloats);
  c.full = bars;
  c.empty = bars + kStages;
  c.own_bar = bars + 2 * kStages;
  c.sfull = c.own_bar + 1;
  c.sfree = c.sfull + 2;
  c.sfree1 = c.sfree + 1;
  c.rank = kC > 1 ? int(hopper::cluster_rank()) : 0;
  c.own0 = int(blockIdx.x / kC) * kBwdRows;
  c.n_tiles = ((kDq ? s_len : t_len) + kBwdRows - 1) / kBwdRows;
  c.t_len = t_len;
  c.s_len = s_len;
  c.heads = heads;
  c.h = blockIdx.y;
  c.b = blockIdx.z;
  c.causal_offset = causal_offset;
  c.scale = scale;
  c.maps[0] = &own0_map;
  c.maps[1] = &own1_map;
  c.maps[2] = &str0_map;
  c.maps[3] = &str1_map;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(&c.full[st], 32);  // the loading warp's lanes (lane 0's with the bytes)
      hopper::mbar_init(&c.empty[st], kBwdThreads);
    }
    hopper::mbar_init(c.own_bar, 1);
    // a share lands by st.async: one arrival (arming it for the share's
    // bytes) a tile; the peer's warps free the buffers, one lane each
    for (int role = 0; role < 2; ++role) {
      hopper::mbar_init(&c.sfull[role], 1);
      if (kC > 1) hopper::mbar_expect_tx(&c.sfull[role], kXFloats * 4);
      hopper::mbar_init(&c.sfree1[role], 4);
    }
    hopper::mbar_init(c.sfree, 8);
    hopper::fence_barrier_init();
  }
  if constexpr (kC > 1)
    hopper::cluster_sync();  // the peers' barriers are initialised before any arrival
  else
    __syncthreads();

  if (threadIdx.x < 128)
    deep_bwd_warpgroup<D, kCausal, kDq, 0>(c, bias, m, l, delta, out0);
  else
    deep_bwd_warpgroup<D, kCausal, kDq, 1>(c, bias, m, l, delta, kDq ? out0 : out1);
  if constexpr (kC > 1) hopper::cluster_sync();  // no block leaves while a peer reads it
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// a block's most dynamic shared memory on the H100
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

// 1024 bytes of alignment slack and 64 of barriers beside the tiles
constexpr size_t kSlack = 1024 + 64;

template <int D>
cudaError_t fwd_scalar(const void* q, const void* k, const void* v, const float* bias,
                       void* out, float* m_out, float* l_out, int batch, int t_len, int s_len,
                       int heads, int causal, int causal_offset, const int64_t* sq,
                       const int64_t* sk, const int64_t* sv, cudaStream_t stream) {
  using G = ScalarFwd<D>;
  const auto kernel = causal ? deep_fwd_kernel<D, true> : deep_fwd_kernel<D, false>;
  cudaError_t err = set_smem(kernel, G::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + G::kRows - 1) / G::kRows, heads, batch);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), m_out, l_out, t_len, s_len, heads, causal_offset, sq[0],
      sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// the forward: one launch of deep_fwd_wgmma_kernel, in clusters of D / 256
// blocks
template <int D>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, const float* bias, void* out,
                      float* m_out, float* l_out, int batch, int t_len, int s_len, int heads,
                      int causal, int causal_offset, const int64_t* sq, const int64_t* sk,
                      const int64_t* sv, cudaStream_t stream) {
  constexpr int kC = D / kFwdCols;
  CUtensorMap q_map, k_map, v_map, bias_map;
  if (!hopper::encode_head_map(&q_map, q, batch, t_len, heads, D, sq, kAtomCols, kFwdRows) ||
      !hopper::encode_head_map(&k_map, k, batch, s_len, heads, D, sk, kAtomCols, kFwdKeys) ||
      !hopper::encode_head_map(&v_map, v, batch, s_len, heads, D, sv, kAtomCols, kFwdKeys) ||
      !hopper::encode_f32_vector_map(&bias_map, bias, uint64_t(batch) * s_len, kFwdKeys))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + FwdSmem<kC>::kBytes;  // with the alignment slack
  const auto kernel = causal ? deep_fwd_wgmma_kernel<D, true> : deep_fwd_wgmma_kernel<D, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((t_len + kFwdRows - 1) / kFwdRows) * kC, heads, batch);
  cfg.blockDim = dim3(kFwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = kC > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, q_map, k_map, v_map, bias_map,
                           static_cast<__nv_bfloat16*>(out), m_out, l_out, t_len, s_len, heads,
                           causal_offset, 1.0f / sqrtf(float(D)));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the four TMA maps of a backward launch: q and g boxes of `q_rows`, k and
// v of `k_rows`
template <int D>
bool encode_bwd_maps(const attn_deep::BwdArgs& a, int q_rows, int k_rows, CUtensorMap* q_map,
                     CUtensorMap* g_map, CUtensorMap* k_map, CUtensorMap* v_map) {
  const int64_t* st = a.st;
  return hopper::encode_head_map(q_map, a.q, a.batch, a.t_len, a.heads, D, st + 0, kAtomCols,
                                 q_rows) &&
         hopper::encode_head_map(g_map, a.g, a.batch, a.t_len, a.heads, D, st + 9, kAtomCols,
                                 q_rows) &&
         hopper::encode_head_map(k_map, a.k, a.batch, a.s_len, a.heads, D, st + 3, kAtomCols,
                                 k_rows) &&
         hopper::encode_head_map(v_map, a.v, a.batch, a.s_len, a.heads, D, st + 6, kAtomCols,
                                 k_rows);
}

template <int D>
cudaError_t dq_scalar(const attn_deep::BwdArgs& a) {
  using G = ScalarBwd<D>;
  const auto kernel = a.causal ? deep_dq_kernel<D, true> : deep_dq_kernel<D, false>;
  cudaError_t err = set_smem(kernel, G::kDqSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + G::kRows - 1) / G::kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, G::kDqSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.bias, a.m, a.l, a.delta,
      static_cast<float*>(a.dq), a.t_len, a.s_len, a.heads, a.causal_offset, a,
      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_scalar(const attn_deep::BwdArgs& a) {
  using G = ScalarBwd<D>;
  const auto kernel = a.causal ? deep_dkv_kernel<D, true> : deep_dkv_kernel<D, false>;
  cudaError_t err = set_smem(kernel, G::kDkvSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + G::kRows - 1) / G::kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, G::kDkvSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.bias, a.m, a.l, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.t_len, a.s_len, a.heads,
      a.causal_offset, a, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// dq (kDq) or dk/dv: one launch of deep_bwd_kernel, in clusters of D / 256
// blocks
template <int D, bool kDq>
cudaError_t bwd_wgmma(const attn_deep::BwdArgs& a) {
  constexpr int kC = D / kBwdCols;
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode_bwd_maps<D>(a, kBwdRows, kBwdRows, &q_map, &g_map, &k_map, &v_map))
    return cudaErrorInvalidValue;
  const size_t smem = kSlack + kBwdBytes;
  const auto kernel = a.causal ? deep_bwd_kernel<D, true, kDq> : deep_bwd_kernel<D, false, kDq>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kC;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const int own_len = kDq ? a.t_len : a.s_len;
  cfg.gridDim = dim3(((own_len + kBwdRows - 1) / kBwdRows) * kC, a.heads, a.batch);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = kC > 1 ? 1 : 0;
  const float scale = 1.0f / sqrtf(float(D));
  if constexpr (kDq) {
    __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq);
    err = cudaLaunchKernelEx(&cfg, kernel, q_map, g_map, k_map, v_map, a.bias, a.m, a.l, a.delta,
                             dq, dq, a.t_len, a.s_len, a.heads, a.causal_offset, scale);
  } else {
    err = cudaLaunchKernelEx(&cfg, kernel, k_map, v_map, q_map, g_map, a.bias, a.m, a.l, a.delta,
                             static_cast<__nv_bfloat16*>(a.dv),
                             static_cast<__nv_bfloat16*>(a.dk), a.t_len, a.s_len, a.heads,
                             a.causal_offset, scale);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

namespace attn_deep {

cudaError_t fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                const float* bias, void* out, float* m_out, float* l_out, int batch, int t_len,
                int s_len, int heads, int causal, int causal_offset, const int64_t* sq,
                const int64_t* sk, const int64_t* sv, cudaStream_t stream) {
#define PIT_DEEP(D)                                                                          \
  (dtype == 0 ? fwd_scalar<D>(q, k, v, bias, out, m_out, l_out, batch, t_len, s_len, heads,  \
                              causal, causal_offset, sq, sk, sv, stream)                     \
              : fwd_wgmma<D>(q, k, v, bias, out, m_out, l_out, batch, t_len, s_len, heads,   \
                             causal, causal_offset, sq, sk, sv, stream))
  switch (head_dim) {
    case 256: return PIT_DEEP(256);
    case 512: return PIT_DEEP(512);
    case 1024: return PIT_DEEP(1024);
    default: return cudaErrorInvalidValue;
  }
#undef PIT_DEEP
}

cudaError_t bwd_dq(int dtype, int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 256: return dtype == 0 ? dq_scalar<256>(a) : bwd_wgmma<256, true>(a);
    case 512: return dtype == 0 ? dq_scalar<512>(a) : bwd_wgmma<512, true>(a);
    case 1024: return dtype == 0 ? dq_scalar<1024>(a) : bwd_wgmma<1024, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_dkv(int dtype, int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 256: return dtype == 0 ? dkv_scalar<256>(a) : bwd_wgmma<256, false>(a);
    case 512: return dtype == 0 ? dkv_scalar<512>(a) : bwd_wgmma<512, false>(a);
    case 1024: return dtype == 0 ? dkv_scalar<1024>(a) : bwd_wgmma<1024, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn_deep

