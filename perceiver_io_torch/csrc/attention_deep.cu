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
// at 989 TF/s); the backward's dq and dk/dv take 6 and 8 times
// B.T.S.D.
//
// Where the room runs out, and what each design does about it:
// - registers: a 64-row f32 accumulator of D columns costs D/2 registers a
//   thread of one warpgroup (256 at D=512, over the 255 a thread may hold).
//   Every bf16 kernel here gives a warpgroup at most 256 accumulator columns
//   (128 registers): the forward and dq split a block's rows between its
//   two warpgroups at D=256 and its columns at D=512; dk/dv splits the
//   columns, and at D=512 runs as two launches, one for dv and one for dk,
//   each recomputing the probabilities.
// - shared memory: a 128 x 128 K/V ring of the D <= 128 designs would be
//   1 MB at D=512. Here a block's owned tile is 64 KB of q (and 64 KB of g,
//   k or v where the kernel owns two) and the streamed tiles hold 8 KB of
//   rows a stage: 64 or 32 keys in the forward, 32 or 16 rows in the
//   backward, two stages, ~192 KB in all.
// - the S product: where two warpgroups share 64 rows (D=512, and dk/dv at
//   D=256), each computes the whole 64 x n logit tile from all D columns,
//   redundantly, so the softmax statistics of both are bit for bit the same
//   without an exchange. That costs tensor-core time (the forward does 1.5x
//   the products it needs at D=512), not correctness.
// - float32 (exact scalar FMAs, as attention_fwd.cu / attention_bwd.cu): the
//   forward keeps 64 rows and 4 threads a row with 64-key (D=256) or 16-key
//   (D=512) tiles; the backward owns 32 rows with 8 threads a row and
//   streams 32-row (D=256) or 16-row (D=512) tiles. All tiles are staged as
//   f32 with row stride D+1.
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
// D/64 of them side by side, each a TMA box of (64 columns, the tile's rows)
// read through the 4-D (B, rows, H, D) maps of hopper::encode_head_map.
// x = A.B^T of an owned and a streamed tile is an SS wgmma (both K-major),
// 16 columns a step; acc += X.B an RS wgmma with X rounded to bf16 in
// registers and the streamed tile as an MN-major B, one 64-column atom an
// instruction. A warpgroup holds 4 accumulator atoms (256 columns, 128
// registers), or 2 + 2 in the D=256 dk/dv kernel.

constexpr int kWgRows = 64;       // rows of one consumer warpgroup's accumulator
constexpr int kStages = 2;        // ring depth of the streamed tiles
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
  static constexpr int kStream = 8192 / D;          // rows a backward streamed tile: 32 or 16
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

// dq. One block per (kRows query rows, head, batch), the warpgroups split as
// the forward's; q and g staged once; kStream-key K/V tiles streamed; for
// each, S = Q.K^T and dP = G.V^T (SS), ds in registers, dq += ds.K (RS).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
deep_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap g_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const float* __restrict__ bias,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int t_len,
                     int s_len, int heads, int causal_offset, float scale) {
  using G = Deep<D>;
  constexpr int kOwnAtom = G::kRows * kRowBytes;
  constexpr int kOwnBytes = G::kAtoms * kOwnAtom;
  constexpr int kStrAtom = G::kStream * kRowBytes;
  constexpr int kStrBytes = G::kAtoms * kStrAtom;
  constexpr int kX = G::kStream / 2;  // logit floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qs = smem;                                  // [atom][kRows rows]
  uint8_t* gs = qs + kOwnBytes;
  uint8_t* ks = gs + kOwnBytes;                        // [stage][atom][kStream rows]
  uint8_t* vs = ks + kStages * kStrBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(vs + kStages * kStrBytes);
  uint64_t* own_bar = ring_bar + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int rg = wg / G::kSplit;
  const int cg = wg % G::kSplit;
  const int t0 = blockIdx.x * G::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (s_len + G::kStream - 1) / G::kStream;
  const float* bias_b = bias + int64_t(b) * s_len;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&ring_bar[st], 1);
    hopper::mbar_init(own_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    deep_load<D>(&q_map, &g_map, qs, gs, own_bar, G::kRows, t0, h, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      deep_load<D>(&k_map, &v_map, ks + st * kStrBytes, vs + st * kStrBytes, &ring_bar[st],
                   G::kStream, st * G::kStream, h, b);
  }

  const int row0 = t0 + rg * kWgRows + warp * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + rg * kWgRows < t_len;
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

  float acc[G::kWgAtoms][32];
#pragma unroll
  for (int a = 0; a < G::kWgAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;

  if (active) hopper::mbar_wait(own_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
      const uint8_t* k_tile = ks + stage * kStrBytes;
      const uint8_t* v_tile = vs + stage * kStrBytes;
      float s[kX], dp[kX];
      hopper::wgmma_fence();
      deep_product<D>(s, qs + rg * kWgRows * kRowBytes, kOwnAtom, k_tile, kStrAtom);
      deep_product<D>(dp, gs + rg * kWgRows * kRowBytes, kOwnAtom, v_tile, kStrAtom);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      const int s0 = j * G::kStream;
#pragma unroll
      for (int c = 0; c < G::kStream / 8; ++c) {
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
      uint32_t ds_a[kX / 8][4];
      deep_fragments(s, ds_a);
      hopper::wgmma_fence();
      deep_accumulate<G::kWgAtoms, G::kStream>(acc, ds_a, k_tile, kStrAtom, cg * G::kWgAtoms);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      deep_wait_acc(acc);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_tiles)
      deep_load<D>(&k_map, &v_map, ks + stage * kStrBytes, vs + stage * kStrBytes,
                   &ring_bar[stage], G::kStream, (j + kStages) * G::kStream, h, b);
  }

  if (active) deep_store<D>(acc, dq, row0, t_len, heads, h, b, cg * G::kWgAtoms, scale);
}

// dk/dv. One block per (64 keys, head, batch) in the transposed frame, as
// attention_bwd.cu's: k and v staged once; kStream-query Q/G tiles and their
// statistics (m, 1/l, delta) streamed; S^T = K.Q^T and dP^T = V.G^T (SS),
// p^T and ds^T in registers, dv += p^T.G and dk += ds^T.Q (RS). Both
// warpgroups take the block's 64 keys, each half of the columns. kMode 0
// accumulates both (D=256: 2 atoms of each a warpgroup); at D=512 the two
// accumulators would need 256 registers a thread, so kMode 1 (dv) and 2
// (dk) are two launches, 4 atoms of one each.
template <int D, bool kCausal, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
deep_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap g_map, const float* __restrict__ bias,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int t_len, int s_len, int heads,
                      int causal_offset, float scale) {
  using G = Deep<D>;
  constexpr bool kDv = kMode != 2;
  constexpr bool kDk = kMode != 1;
  constexpr int kHeld = G::kAtoms / 2;  // columns of each accumulator a warpgroup holds
  constexpr int kOwnAtom = kWgRows * kRowBytes;
  constexpr int kOwnBytes = G::kAtoms * kOwnAtom;
  constexpr int kStrAtom = G::kStream * kRowBytes;
  constexpr int kStrBytes = G::kAtoms * kStrAtom;
  constexpr int kX = G::kStream / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* ks = smem;                                  // [atom][64 rows]
  uint8_t* vs = ks + kOwnBytes;
  uint8_t* qs = vs + kOwnBytes;                        // [stage][atom][kStream rows]
  uint8_t* gs = qs + kStages * kStrBytes;
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(gs + kStages * kStrBytes);
  uint64_t* own_bar = ring_bar + kStages;
  float* stats = reinterpret_cast<float*>(own_bar + 1);  // [stage][m, 1/l, delta][kStream]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int s0 = blockIdx.x * kWgRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_len + G::kStream - 1) / G::kStream;
  const int64_t stat0 = (int64_t(b) * heads + h) * t_len;
  const float* bias_b = bias + int64_t(b) * s_len;

  // the statistics of query tile `tile` into ring stage `stage`; queries
  // past T are never read
  auto stage_stats = [&](int tile, int stage) {
    if (tid < G::kStream) {
      const int t = tile * G::kStream + tid;
      const bool valid = t < t_len;
      float* slot = stats + stage * 3 * G::kStream;
      slot[tid] = valid ? m[stat0 + t] : 0.f;
      slot[G::kStream + tid] = valid ? 1.f / l[stat0 + t] : 0.f;
      slot[2 * G::kStream + tid] = valid ? delta[stat0 + t] : 0.f;
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&ring_bar[st], 1);
    hopper::mbar_init(own_bar, 1);
    hopper::fence_barrier_init();
  }
  for (int st = 0; st < kStages && st < n_tiles; ++st) stage_stats(st, st);
  __syncthreads();
  if (tid == 0) {
    deep_load<D>(&k_map, kDk ? &v_map : nullptr, ks, vs, own_bar, kWgRows, s0, h, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      deep_load<D>(&q_map, &g_map, qs + st * kStrBytes, gs + st * kStrBytes, &ring_bar[st],
                   G::kStream, st * G::kStream, h, b);
  }

  const int row0 = s0 + warp * 16 + lane / 4;  // this thread's keys: r = 0 and r = 1 (eight apart)
  const int col_in_chunk = 2 * (lane % 4);
  float bias_r[2];
  bool key_valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_valid[r] = row0 + 8 * r < s_len;
    bias_r[r] = key_valid[r] ? bias_b[row0 + 8 * r] : 0.f;
  }

  float dk_acc[kHeld][32], dv_acc[kHeld][32];
#pragma unroll
  for (int a = 0; a < kHeld; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[a][i] = dv_acc[a][i] = 0.f;

  hopper::mbar_wait(own_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    hopper::mbar_wait(&ring_bar[stage], (j / kStages) & 1);
    const uint8_t* q_tile = qs + stage * kStrBytes;
    const uint8_t* g_tile = gs + stage * kStrBytes;
    const float* st_m = stats + stage * 3 * G::kStream;
    const float* st_inv_l = st_m + G::kStream;
    const float* st_delta = st_inv_l + G::kStream;
    float x[kX], dp[kX];
    hopper::wgmma_fence();
    deep_product<D>(x, ks, kOwnAtom, q_tile, kStrAtom);             // S^T = K.Q^T
    if (kDk) deep_product<D>(dp, vs, kOwnAtom, g_tile, kStrAtom);   // dP^T = V.G^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(x);
    if (kDk) hopper::fence_regs(dp);

    // p^T in place of x, ds^T in place of dp; queries past T masked by
    // index, the causal bias by index after the pad bias
    const int q0 = j * G::kStream;
#pragma unroll
    for (int c = 0; c < G::kStream / 8; ++c) {
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
          if (kDk) dp[i] = zero_ds ? 0.f : p * (dp[i] - st_delta[col]);
          x[i] = p;
        }
      }
    }
    uint32_t p_a[kX / 8][4], ds_a[kX / 8][4];
    if (kDv) deep_fragments(x, p_a);
    if (kDk) deep_fragments(dp, ds_a);
    hopper::wgmma_fence();
    if (kDv) deep_accumulate<kHeld, G::kStream>(dv_acc, p_a, g_tile, kStrAtom, wg * kHeld);
    if (kDk) deep_accumulate<kHeld, G::kStream>(dk_acc, ds_a, q_tile, kStrAtom, wg * kHeld);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (kDv) deep_wait_acc(dv_acc);
    if (kDk) deep_wait_acc(dk_acc);
    __syncthreads();  // both warpgroups are done with this stage
    if (j + kStages < n_tiles) {
      stage_stats(j + kStages, stage);  // read after the next iteration's barrier
      if (tid == 0)
        deep_load<D>(&q_map, &g_map, qs + stage * kStrBytes, gs + stage * kStrBytes,
                     &ring_bar[stage], G::kStream, (j + kStages) * G::kStream, h, b);
    }
  }

  if (kDk) deep_store<D>(dk_acc, dk, row0, s_len, heads, h, b, wg * kHeld, scale);
  if (kDv) deep_store<D>(dv_acc, dv, row0, s_len, heads, h, b, wg * kHeld, 1.f);
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

template <int D>
cudaError_t dq_wgmma(const attn_deep::BwdArgs& a) {
  using G = Deep<D>;
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode_bwd_maps<D>(a, G::kRows, G::kStream, &q_map, &g_map, &k_map, &v_map))
    return cudaErrorInvalidValue;
  const size_t smem =
      kSlack + 2 * size_t(G::kRows) * D * 2 + 2 * kStages * size_t(G::kStream) * D * 2;
  const auto kernel = a.causal ? deep_dq_wgmma_kernel<D, true> : deep_dq_wgmma_kernel<D, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + G::kRows - 1) / G::kRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      q_map, g_map, k_map, v_map, a.bias, a.m, a.l, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.t_len, a.s_len, a.heads, a.causal_offset, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int D, int kMode>
cudaError_t dkv_wgmma_pass(const attn_deep::BwdArgs& a, const CUtensorMap& k_map,
                           const CUtensorMap& v_map, const CUtensorMap& q_map,
                           const CUtensorMap& g_map) {
  using G = Deep<D>;
  // + the statistics ring
  const size_t smem = kSlack + 2 * size_t(kWgRows) * D * 2 +
                      2 * kStages * size_t(G::kStream) * D * 2 +
                      sizeof(float) * kStages * 3 * G::kStream;
  const auto kernel = a.causal ? deep_dkv_wgmma_kernel<D, true, kMode>
                               : deep_dkv_wgmma_kernel<D, false, kMode>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + kWgRows - 1) / kWgRows, a.heads, a.batch);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      k_map, v_map, q_map, g_map, a.bias, a.m, a.l, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.t_len, a.s_len, a.heads, a.causal_offset,
      1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_wgmma(const attn_deep::BwdArgs& a) {
  CUtensorMap q_map, g_map, k_map, v_map;
  if (!encode_bwd_maps<D>(a, Deep<D>::kStream, kWgRows, &q_map, &g_map, &k_map, &v_map))
    return cudaErrorInvalidValue;
  if constexpr (D == 256) {
    return dkv_wgmma_pass<D, 0>(a, k_map, v_map, q_map, g_map);
  } else {
    const cudaError_t err = dkv_wgmma_pass<D, 1>(a, k_map, v_map, q_map, g_map);  // dv
    if (err != cudaSuccess) return err;
    return dkv_wgmma_pass<D, 2>(a, k_map, v_map, q_map, g_map);                   // dk
  }
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
    case 256: return dtype == 0 ? dq_scalar<256>(a) : dq_wgmma<256>(a);
    case 512: return dtype == 0 ? dq_scalar<512>(a) : dq_wgmma<512>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t bwd_dkv(int dtype, int head_dim, const BwdArgs& a) {
  switch (head_dim) {
    case 256: return dtype == 0 ? dkv_scalar<256>(a) : dkv_wgmma<256>(a);
    case 512: return dtype == 0 ? dkv_scalar<512>(a) : dkv_wgmma<512>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn_deep
