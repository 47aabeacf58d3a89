// Fused multi-head attention at head depths 256 and 512, forward (#1) and
// backward (#2 dq, #3 dk/dv), written by hand for Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_fwd_impl
// (Pallas kernel _attention_kernel, with or without causal_offset and the
// with_lse statistics) and ::_fused_attention_bwd_impl (_bwd_dq_kernel,
// _bwd_dkv_kernel) at the head depths the TPU kernel takes beyond 128
// (LONG_KV_MAX_D = 512): the optical-flow model's one-head crosses
// (D = 512) and the multimodal model's. It computes what attention_fwd.cu
// and attention_bwd.cu compute, with the same biases, statistics, rounding
// points and masked-row rules (see their headers); only the geometry
// differs, because a head this deep does not fit their tiles.
//
// What bounds it on the H100: the flow crosses (B=8, T=2048 latents against
// S=182,528 pixels, one head of D=512, or the transpose for the decoder) are
// 4.B.T.S.D = 6.1 TFLOP forward against 3.2 GB of q/k/v/out: ~1,900
// FLOP/byte, far above the bf16 ridge, so the tensor cores bound it (6.2 ms
// at 989 TF/s); the backward's dq and dk/dv take 6 and 8 times B.T.S.D
// (9.3 and 12.4 ms).
//
// The forward and the f32 designs:
// - registers: a 64-row f32 accumulator of D columns costs D/2 registers a
//   thread of one warpgroup (256 at D=512, over the 255 a thread may hold).
//   The bf16 forward gives a warpgroup at most 256 accumulator columns: it
//   splits a block's rows between its two warpgroups at D=256 and its
//   columns at D=512, where both compute the whole logit tile.
// - shared memory: the forward's owned q tile is 64 KB and its K/V tiles 8
//   KB of rows a stage (64 or 32 keys), two stages.
// - float32 (exact scalar FMAs, as attention_fwd.cu / attention_bwd.cu): the
//   forward keeps 64 rows and 4 threads a row with 64-key (D=256) or 16-key
//   (D=512) tiles; the backward owns 32 rows with 8 threads a row and
//   streams 32-row (D=256) or 16-row (D=512) tiles. All tiles are staged as
//   f32 with row stride D+1.
//
// The bf16 backward (deep_bwd_kernel; the section below says how): one
// kernel template for dq and for dk/dv, one launch each, no atomics. A
// block owns 64 rows and 256 head columns; at D=512 a two-block cluster
// splits the columns, and its blocks add their halves of each logit tile
// through distributed shared memory. Its bound at the flow crosses is the
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

namespace {

constexpr float kMaskValue = -1e30f;  // pallas_attention.MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// float32: the exact scalar designs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

template <int D>
struct ScalarFwd {
  static constexpr int kRows = 64;                // query rows a block owns
  static constexpr int kLanes = 4;                // threads a query row
  static constexpr int kKeys = D == 256 ? 64 : 16;  // keys a K/V tile
  static constexpr int kKeysPerLane = kKeys / kLanes;
  static constexpr int kCols = D / kLanes;        // accumulator columns a thread
  static constexpr size_t kSmem =
      sizeof(float) * (size_t(kRows) * (D + 1) + 2 * size_t(kKeys) * (D + 1) +
                       size_t(kRows) * (kKeys + 1) + kKeys);
};

template <int D>
struct ScalarBwd {
  static constexpr int kRows = 32;                // rows (queries or keys) a block owns
  static constexpr int kLanes = 8;                // threads an owned row
  static constexpr int kTile = D == 256 ? 32 : 16;  // rows of a streamed tile
  static constexpr int kPerLane = kTile / kLanes;
  static constexpr int kCols = D / kLanes;
  // owned pair + streamed pair + ds strip + bias
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * size_t(kRows) * (D + 1) + 2 * size_t(kTile) * (D + 1) +
                       size_t(kRows) * (kTile + 1) + kTile);
  // owned pair + streamed pair + p and ds strips + m, l, delta
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * size_t(kRows) * (D + 1) + 2 * size_t(kTile) * (D + 1) +
                       2 * size_t(kRows) * (kTile + 1) + 3 * kTile);
};

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
  float acc[G::kCols];
#pragma unroll
  for (int i = 0; i < G::kCols; ++i) acc[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f;
  const int key_limit = t0 + row + causal_offset;  // the last key the row sees unmasked

  for (int s0 = 0; s0 < s_len; s0 += G::kKeys) {
    const int n = min(G::kKeys, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    stage_f32<D>(ks, kb, sks, s0, s_len, G::kKeys);
    stage_f32<D>(vs, vb, svs, s0, s_len, G::kKeys);
    if (tid < G::kKeys) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    float s[G::kKeysPerLane];
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * DP + d];
#pragma unroll
      for (int i = 0; i < G::kKeysPerLane; ++i)
        s[i] = fmaf(qd, ks[(lane + i * G::kLanes) * DP + d], s[i]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      s[i] = s[i] * scale + bs[j];
      if (kCausal && s0 + j > key_limit) s[i] += kMaskValue;
      if (j < n) tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < G::kKeysPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      const float p = j < n ? expf(s[i] - m_new) : 0.f;
      p_sum += p;
      ps[row * PP + j] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the row's four threads see each other's probabilities

#pragma unroll
    for (int i = 0; i < G::kCols; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
#pragma unroll
      for (int i = 0; i < G::kCols; ++i)
        acc[i] = fmaf(p, vs[j * DP + lane + i * G::kLanes], acc[i]);
    }
  }

  const int t = t0 + row;
  if (t < t_len) {
    float* o = out + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < G::kCols; ++i) o[lane + i * G::kLanes] = acc[i] / l;
    if (m_out != nullptr && lane == 0) {  // the row's four threads hold equal m, l
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
  float* qs = smem;                   // [kRows][DP]
  float* gs = qs + G::kRows * DP;     // [kRows][DP]
  float* ks = gs + G::kRows * DP;     // [kTile][DP]
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

  stage_f32<D>(qs, q + b * st[0] + h * st[2], st[1], t0, t_len, G::kRows);
  stage_f32<D>(gs, g + b * st[9] + h * st[11], st[10], t0, t_len, G::kRows);
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

  float acc[G::kCols];
#pragma unroll
  for (int i = 0; i < G::kCols; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += G::kTile) {
    const int n = min(G::kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage_f32<D>(ks, kb, st[4], s0, s_len, G::kTile);
    stage_f32<D>(vs, vb, st[7], s0, s_len, G::kTile);
    if (tid < G::kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    float s[G::kPerLane], dp[G::kPerLane];
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * DP + d];
      const float gd = gs[row * DP + d];
#pragma unroll
      for (int i = 0; i < G::kPerLane; ++i) {
        const int j = lane + i * G::kLanes;
        s[i] = fmaf(qd, ks[j * DP + d], s[i]);
        dp[i] = fmaf(gd, vs[j * DP + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      float x = s[i] * scale + bs[j];
      if (kCausal && s0 + j > key_limit) x += kMaskValue;
      const float p = expf(x - m_t) / l_t;
      dss[row * PP + j] = (masked_row || j >= n) ? 0.f : p * (dp[i] - delta_t);
    }
    __syncwarp();  // the row's threads see each other's ds

    for (int j = 0; j < n; ++j) {
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < G::kCols; ++i)
        acc[i] = fmaf(ds, ks[j * DP + lane + i * G::kLanes], acc[i]);
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
  float* ks = smem;                   // [kRows][DP]
  float* vs = ks + G::kRows * DP;     // [kRows][DP]
  float* qs = vs + G::kRows * DP;     // [kTile][DP]
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

  stage_f32<D>(ks, k + b * st[3] + h * st[5], st[4], s0, s_len, G::kRows);
  stage_f32<D>(vs, v + b * st[6] + h * st[8], st[7], s0, s_len, G::kRows);
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

    float s[G::kPerLane], dp[G::kPerLane];
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = ks[row * DP + d];
      const float vd = vs[row * DP + d];
#pragma unroll
      for (int i = 0; i < G::kPerLane; ++i) {
        const int j = lane + i * G::kLanes;
        s[i] = fmaf(qs[j * DP + d], kd, s[i]);
        dp[i] = fmaf(gs[j * DP + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kPerLane; ++i) {
      const int j = lane + i * G::kLanes;
      const float m_j = ms[j];
      float x = s[i] * scale + bias_s;
      if (kCausal && s_idx > t0 + j + causal_offset) x += kMaskValue;  // past the row's limit
      const float p = j < n ? expf(x - m_j) / ls[j] : 0.f;
      ps[row * PP + j] = p;
      dss[row * PP + j] = m_j <= 0.5f * kMaskValue ? 0.f : p * (dp[i] - des[j]);
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

template <int D>
struct Deep {
  static_assert(D == 256 || D == 512, "the deep designs take D = 256 or 512");
  static constexpr int kAtoms = D / kAtomCols;      // 4 or 8
  static constexpr int kSplit = D / 256;            // warpgroups sharing one 64-row group
  static constexpr int kRows = 2 * kWgRows / kSplit;  // rows the forward and dq own: 128 or 64
  static constexpr int kWgAtoms = kAtoms / kSplit;  // output atoms of a forward / dq warpgroup
  static constexpr int kKeys = 16384 / D;           // keys a forward K/V tile: 64 or 32
};

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

// one thread: rows r0 .. r0 + rows of a and, unless map_b is null, b into
// the tiles at ring_a and ring_b (atoms of `rows` rows), completing on `bar`
template <int D>
__device__ __forceinline__ void deep_load(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          uint8_t* ring_a, uint8_t* ring_b, uint64_t* bar,
                                          int rows, int r0, int h, int b) {
  const int atom = rows * kRowBytes;
  hopper::mbar_expect_tx(bar, (map_b ? 2 : 1) * Deep<D>::kAtoms * atom);
#pragma unroll
  for (int a = 0; a < Deep<D>::kAtoms; ++a) {
    hopper::tma_load_4d(ring_a + a * atom, map_a, bar, a * kAtomCols, h, r0, b);
    if (map_b) hopper::tma_load_4d(ring_b + a * atom, map_b, bar, a * kAtomCols, h, r0, b);
  }
}

// The forward. One block per (kRows query rows, head, batch), two consumer
// warpgroups: at D=256 each owns 64 rows and all 256 columns of its
// output, at D=512 both take the same 64 rows and each 256 of the columns
// (both compute the whole logit tile). TMA stages the q tile once and
// streams kKeys-key K/V tiles through a two-stage ring.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
deep_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t_len, int s_len, int heads,
                      int causal_offset, float scale) {
  using G = Deep<D>;
  constexpr int kQAtom = G::kRows * kRowBytes;
  constexpr int kKVAtom = G::kKeys * kRowBytes;
  constexpr int kKVBytes = G::kAtoms * kKVAtom;
  constexpr int kS = G::kKeys / 2;  // logit floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qs = smem;                                   // [atom][kRows rows]
  uint8_t* ks = qs + G::kAtoms * kQAtom;                // [stage][atom][kKeys rows]
  uint8_t* vs = ks + kStages * kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * kKVBytes);
  uint64_t* q_bar = bars;                               // q tile landed
  uint64_t* kv_bar = bars + 1;                          // [stage] K and V tiles landed

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int rg = wg / G::kSplit;  // the warpgroup's 64-row group of the block
  const int cg = wg % G::kSplit;  // its output atoms: cg * kWgAtoms ..
  const int t0 = blockIdx.x * G::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (s_len + G::kKeys - 1) / G::kKeys;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&kv_bar[st], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    deep_load<D>(&q_map, nullptr, qs, nullptr, q_bar, G::kRows, t0, h, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      deep_load<D>(&k_map, &v_map, ks + st * kKVBytes, vs + st * kKVBytes, &kv_bar[st],
                   G::kKeys, st * G::kKeys, h, b);
  }

  const int row_in_block = rg * kWgRows + warp * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + rg * kWgRows < t_len;
  const float* bias_b = bias + int64_t(b) * s_len;
  const int key_limit[2] = {t0 + row_in_block + causal_offset,
                            t0 + row_in_block + 8 + causal_offset};

  float o[G::kWgAtoms][32];
#pragma unroll
  for (int a = 0; a < G::kWgAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.f, 0.f};

  if (active) hopper::mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&kv_bar[stage], (j / kStages) & 1);
      const uint8_t* k_tile = ks + stage * kKVBytes;
      const uint8_t* v_tile = vs + stage * kKVBytes;
      float s[kS];
      hopper::wgmma_fence();
      deep_product<D>(s, qs + rg * kWgRows * kRowBytes, kQAtom, k_tile, kKVAtom);  // S = Q.K^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // logits: scale, pad bias, then the causal bias by index; keys past S
      // masked by index
      const int s0 = j * G::kKeys;
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < G::kKeys / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = s0 + 8 * c + col_in_chunk + e;
          const bool valid = key < s_len;
          const float bj = valid ? bias_b[key] : 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = s[4 * c + 2 * r + e] * scale + bj;
            if (kCausal && key > key_limit[r]) x += kMaskValue;
            s[4 * c + 2 * r + e] = x;
            if (valid) tile_max[r] = fmaxf(tile_max[r], x);
          }
        }
      }
      float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        const float m_new = fmaxf(m_run[r], tile_max[r]);
        alpha[r] = exp2f((m_run[r] - m_new) * kLog2e);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int c = 0; c < G::kKeys / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = s0 + 8 * c + col_in_chunk + e < s_len;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p = valid ? exp2f((s[4 * c + 2 * r + e] - m_run[r]) * kLog2e) : 0.f;
            row_sum[r] += p;
            s[4 * c + 2 * r + e] = p;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
        row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
        l_run[r] = alpha[r] * l_run[r] + row_sum[r];
      }
#pragma unroll
      for (int a = 0; a < G::kWgAtoms; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i / 2) % 2];

      uint32_t pa[kS / 8][4];  // P (bf16, unnormalised) as A fragments
      deep_fragments(s, pa);
      hopper::wgmma_fence();
      deep_accumulate<G::kWgAtoms, G::kKeys>(o, pa, v_tile, kKVAtom, cg * G::kWgAtoms);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      deep_wait_acc(o);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_tiles)
      deep_load<D>(&k_map, &v_map, ks + stage * kKVBytes, vs + stage * kKVBytes,
                   &kv_bar[stage], G::kKeys, (j + kStages) * G::kKeys, h, b);
  }

  if (!active) return;
#pragma unroll
  for (int a = 0; a < G::kWgAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] /= l_run[(i / 2) % 2];
  deep_store<D>(o, out, t0 + row_in_block, t_len, heads, h, b, cg * G::kWgAtoms, 1.f);
  if (cg == 0 && m_out != nullptr && lane % 4 == 0) {  // the row's four threads hold equal m, l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + row_in_block + 8 * r;
      if (t >= t_len) continue;
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m_run[r];
      l_out[stat] = l_run[r];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 backward: dq (#2) and dk/dv (#3), one design for both
// ---------------------------------------------------------------------------
//
// deep_bwd_kernel<D, kCausal, kDq> computes dq (kDq) or dk and dv. A block
// owns 64 rows (queries for dq, keys for dk/dv) and 256 head columns: all
// of them at D=256, one half at D=512, where the two blocks of a cluster
// (blockIdx.x = 2 tile + rank) hold the two halves of the same rows.
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
// kCausal): 256 threads, one block an SM; shared memory 230,984 bytes +
// 1,088 of alignment slack; registers dq 144 / 141 and 164 / 168, dk/dv
// 200 / 202 and 213 / 214, zero spill bytes (under the 255 of 256 threads;
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
// and nine barriers: 230,984 bytes
constexpr size_t kBwdBytes = size_t(2 + 2 * kStages) * kBwdTile + 2 * sizeof(float) * kXFloats +
                             kStages * sizeof(float) * kVecFloats + 9 * sizeof(uint64_t);

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
      // the peer's share of this role is in this block's buffer (and the
      // barrier is armed for the next tile's): this role's half stays in
      // registers, the other half goes back whole for the other role
      hopper::mbar_wait_cluster(&c.sfull[kRole], j & 1);
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
    if constexpr (kC == 2) {  // this warp's reads of both buffers have landed: the peer may push
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
  c.rank = kC == 2 ? int(hopper::cluster_rank()) : 0;
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
      if (kC == 2) hopper::mbar_expect_tx(&c.sfull[role], kXFloats * 4);
    }
    hopper::mbar_init(c.sfree, 8);
    hopper::fence_barrier_init();
  }
  if constexpr (kC == 2)
    hopper::cluster_sync();  // the peer's barriers are initialised before any arrival
  else
    __syncthreads();

  if (threadIdx.x < 128)
    deep_bwd_warpgroup<D, kCausal, kDq, 0>(c, bias, m, l, delta, out0);
  else
    deep_bwd_warpgroup<D, kCausal, kDq, 1>(c, bias, m, l, delta, kDq ? out0 : out1);
  if constexpr (kC == 2) hopper::cluster_sync();  // no block leaves while its peer reads it
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

template <int D>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, const float* bias, void* out,
                      float* m_out, float* l_out, int batch, int t_len, int s_len, int heads,
                      int causal, int causal_offset, const int64_t* sq, const int64_t* sk,
                      const int64_t* sv, cudaStream_t stream) {
  using G = Deep<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!hopper::encode_head_map(&q_map, q, batch, t_len, heads, D, sq, kAtomCols, G::kRows) ||
      !hopper::encode_head_map(&k_map, k, batch, s_len, heads, D, sk, kAtomCols, G::kKeys) ||
      !hopper::encode_head_map(&v_map, v, batch, s_len, heads, D, sv, kAtomCols, G::kKeys))
    return cudaErrorInvalidValue;
  const size_t smem = kSlack + size_t(G::kRows) * D * 2 + 2 * kStages * size_t(G::kKeys) * D * 2;
  const auto kernel = causal ? deep_fwd_wgmma_kernel<D, true> : deep_fwd_wgmma_kernel<D, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + G::kRows - 1) / G::kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map, bias,
                                           static_cast<__nv_bfloat16*>(out), m_out, l_out,
                                           t_len, s_len, heads, causal_offset,
                                           1.0f / sqrtf(float(D)));
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
    default: return cudaErrorInvalidValue;
  }
#undef PIT_DEEP
}

cudaError_t bwd_dq(int dtype, int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 256: return dtype == 0 ? dq_scalar<256>(a) : bwd_wgmma<256, true>(a);
    case 512: return dtype == 0 ? dq_scalar<512>(a) : bwd_wgmma<512, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_dkv(int dtype, int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 256: return dtype == 0 ? dkv_scalar<256>(a) : bwd_wgmma<256, false>(a);
    case 512: return dtype == 0 ? dkv_scalar<512>(a) : bwd_wgmma<512, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn_deep

