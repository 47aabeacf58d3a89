// Fused multi-head attention forward for the Perceiver latent attention,
// written by hand for Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_fwd_impl
// (Pallas kernel _attention_kernel), the forward of fused_attention, with or
// without causal_offset (_causal_bias) and the with_lse statistics.
//
// Computes, per (batch b, head h, query row t):
//   out[b,t,h,:] = softmax_s(q[b,t,h,:] . k[b,s,h,:] * D^-0.5 + bias[b,s]
//                            + causal[t,s]) @ v[b,:,h,:]
// with the additive pad bias of the TPU kernel (0 or -1e30) and, when the
// causal flag is set, the TPU kernel's additive causal bias: -1e30 where key
// s > t + causal_offset, t the GLOBAL query row (the kernel never pads the
// query axis), added by index in f32 after the pad bias, never read from a
// (T, S) mask. Both biases are finite, so a fully masked row softmaxes to
// uniform over the keys masked exactly once (-1e30 + logit rounds to
// -1e30; a key masked twice scores -2e30 and drops out): with the pad bias
// alone, the mean of v over all S keys, exactly as the TPU kernel and the
// einsum path give; with the causal flag, the mean over the visible padded
// keys and the future unpadded ones. No key tile is skipped for lying
// beyond the diagonal: such a row would lose its future keys. Logits,
// running max (starting at -1e30), denominator and accumulator are f32; the
// unnormalised probabilities exp(logit - m) are rounded to the value dtype
// before the P.V product, as the TPU kernel's p.astype(v.dtype) does, while
// the denominator sums them unrounded; the output is written in the input
// dtype.
//
// What bounds it on the H100: at the serving shapes (e.g. the encoder
// cross-attention B=64, T=256, S=512, H=4, D=128 in bf16) the work is
// 4.B.H.T.S.D = 17.2 GFLOP against 101 MB of q/k/v/out, ~170 FLOP/byte:
// below the bf16 ridge (~295 FLOP/byte), so the least time is set by bytes
// at 3.35 TB/s (30 us), with the operations at 989 TF/s close behind
// (17 us). At D=16 the exponentials (one per logit) come first.
//
// Two designs, chosen by dtype (not a fallback):
//
// - float32: exact f32, scalar FMAs (wgmma has no full-f32 mode and TF32
//   would break the f32 parity bar; the TPU kernel asks for HIGHEST
//   precision there). One block per (64-query tile, head, batch); 256
//   threads, four per query row. The query tile and each 64-key K/V tile
//   are staged through shared memory as f32 (row stride D+1, so column reads
//   hit distinct banks); the online softmax and the D/4 accumulator columns
//   of each thread stay in registers across K/V tiles. Each thread scores
//   16 of the tile's 64 keys; the four threads of a row combine max and sum
//   with warp shuffles and exchange probabilities through shared memory.
//
// - bfloat16: tensor cores, FlashAttention-style for Hopper. One block per
//   (128-query tile, head, batch) with two consumer warpgroups of 64 rows
//   each. TMA stages the q tile once and streams 128-key K/V tiles through
//   a two-stage ring (mbarriers), in swizzled layouts (rows of 32, 64 or 128
//   bytes; D=128 as two 64-column atoms; D=8 zero-padded to 16 by TMA's
//   out-of-bounds fill). S = Q.K^T is an SS wgmma (K is K-major: D is
//   contiguous) into f32 registers; the online softmax runs there, masking
//   keys past S by index (TMA fills them with zeros, which would score 0,
//   not -1e30) and adding the causal bias by index in the same registers;
//   P goes to bf16 in registers, laid out as the A operand, and
//   O += P.V is an RS wgmma with V as an MN-major B. A warpgroup whose rows
//   all lie past T skips the products (T=8 on the serving decoder).
//
// Statistics (the training forward): given m_out/l_out, the kernel also
// writes each row's final running max m and denominator l as (B, H, T) f32,
// the residuals the backward (attention_bwd.cu) recomputes the
// probabilities from as exp(logit - m) / l. They stay two arrays, not one
// log-sum-exp: on a fully masked row m is pinned at -1e30, which would
// absorb log l in f32. The TPU kernel's 128-lane broadcast of m and l is a
// Mosaic layout artefact and is not copied. Serving passes null pointers
// and writes nothing extra.

#include "attention_deep.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e30f;  // pallas_attention.MASK_VALUE

// ---------------------------------------------------------------------------
// float32: the exact scalar design
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                   // query rows per block
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kLanes = 4;                   // threads per query row
constexpr int kThreads = kRows * kLanes;    // 256
constexpr int kKeysPerLane = kKeys / kLanes;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * (D + 1) + 2 * size_t(kKeys) * (D + 1) +
                          size_t(kRows) * (kKeys + 1) + kKeys);
}

// kCausal: the causal bias is compiled in only where it is asked for, so a
// call without it runs the exact code it ran before the causal offset
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int t_len, int s_len, int heads,
                     int causal_offset,
                     int64_t sqb, int64_t sqt, int64_t sqh,
                     int64_t skb, int64_t sks, int64_t skh,
                     int64_t svb, int64_t svs, int64_t svh, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kKeys + 1;
  constexpr int kCols = D / kLanes;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][DP]
  float* ks = qs + kRows * DP;       // [kKeys][DP]
  float* vs = ks + kKeys * DP;       // [kKeys][DP]
  float* ps = vs + kKeys * DP;       // [kRows][PP]
  float* bs = ps + kRows * PP;       // [kKeys]

  const int tid = threadIdx.x;
  const int row = tid / kLanes;
  const int lane = tid % kLanes;
  const int t0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const float* biasb = bias + int64_t(b) * s_len;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = t0 + r;
    qs[r * DP + d] = t < t_len ? qb[t * sqt + d] : 0.f;
  }

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f;
  // the last key this row sees unmasked by the causal bias
  const int key_limit = t0 + row + causal_offset;

  for (int s0 = 0; s0 < s_len; s0 += kKeys) {
    const int n = min(kKeys, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      if (r < n) {
        ks[r * DP + d] = kb[(s0 + r) * sks + d];
        vs[r * DP + d] = vb[(s0 + r) * svs + d];
      }
    }
    if (tid < kKeys) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();

    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[row * DP + d];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i)
        s[i] = fmaf(qd, ks[(lane + i * kLanes) * DP + d], s[i]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + i * kLanes;
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
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + i * kLanes;
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
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float p = ps[row * PP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[i] = fmaf(p, vs[j * DP + lane + i * kLanes], acc[i]);
    }
  }

  const int t = t0 + row;
  if (t < t_len) {
    float* o = out + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[lane + i * kLanes] = acc[i] / l;
    if (m_out != nullptr && lane == 0) {  // the row's four threads hold equal m, l
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m;
      l_out[stat] = l;
    }
  }
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v, const float* bias,
                          void* out, float* m_out, float* l_out, int batch, int t_len,
                          int s_len, int heads, int causal, int causal_offset,
                          const int64_t* sq, const int64_t* sk, const int64_t* sv,
                          cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  const auto kernel = causal ? attention_fwd_kernel<D, true> : attention_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), m_out, l_out, t_len, s_len, heads, causal_offset,
      sq[0], sq[1], sq[2],
      sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma design
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                     // query rows per consumer warpgroup
constexpr int kBlockRows = 2 * kWgRows;         // query rows per block
constexpr int kTileKeys = 128;                  // keys per K/V tile (the S tile's n)
constexpr int kStages = 2;                      // K/V ring depth
constexpr int kWgThreads = 256;                 // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geometry {
  static constexpr int kDp = D < 16 ? 16 : D;             // head dim in shared memory
  static constexpr int kAtomCols = kDp > 64 ? 64 : kDp;   // columns of one swizzle atom / TMA box
  static constexpr int kAtoms = kDp / kAtomCols;           // 2 at D = 128, else 1
  static constexpr int kRowBytes = kAtomCols * 2;          // 32, 64 or 128
  static constexpr uint32_t kLayout = hopper::layout_for_row_bytes(kRowBytes);
  static constexpr uint32_t kGroup = 8 * kRowBytes;        // bytes between 8-row groups
  static constexpr int kQAtom = kBlockRows * kRowBytes;    // one atom of the q tile
  static constexpr int kKVAtom = kTileKeys * kRowBytes;    // one atom of a K or V tile
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kKVBytes = kAtoms * kKVAtom;
  static constexpr int kORegs = kAtomCols / 2;             // accumulator floats per atom
  // 1024 bytes of alignment slack, q, K and V rings, 3 barriers
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 64;
};

// one thread: K and V tile `tile` of (b, h) into ring stage `stage`
template <int D>
__device__ __forceinline__ void load_kv_tile(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                             uint8_t* ks, uint8_t* vs, uint64_t* kv_bar,
                                             int tile, int stage, int h, int b) {
  using G = Geometry<D>;
  hopper::mbar_expect_tx(&kv_bar[stage], 2 * G::kKVBytes);
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a) {
    hopper::tma_load_4d(ks + stage * G::kKVBytes + a * G::kKVAtom, k_map, &kv_bar[stage],
                        a * G::kAtomCols, h, tile * kTileKeys, b);
    hopper::tma_load_4d(vs + stage * G::kKVBytes + a * G::kKVAtom, v_map, &kv_bar[stage],
                        a * G::kAtomCols, h, tile * kTileKeys, b);
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ m_out, float* __restrict__ l_out, int t_len,
                           int s_len, int heads, int causal_offset, float scale) {
  using G = Geometry<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* qs = smem;                                  // [atom][kBlockRows rows]
  uint8_t* ks = qs + G::kQBytes;                       // [stage][atom][kTileKeys rows]
  uint8_t* vs = ks + kStages * G::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * G::kKVBytes);
  uint64_t* q_bar = bars;                              // q tile landed
  uint64_t* kv_bar = bars + 1;                         // [stage] K and V tiles landed

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int t0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (s_len + kTileKeys - 1) / kTileKeys;

  if (tid == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&kv_bar[st], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
    for (int a = 0; a < G::kAtoms; ++a)
      hopper::tma_load_4d(qs + a * G::kQAtom, &q_map, q_bar, a * G::kAtomCols, h, t0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      load_kv_tile<D>(&k_map, &v_map, ks, vs, kv_bar, st, st, h, b);
  }

  // this thread's accumulator rows: r = 0 and r = 1 (eight rows apart)
  const int row_in_block = wg * kWgRows + warp * 16 + lane / 4;
  const int col_in_chunk = 2 * (lane % 4);
  const bool active = t0 + wg * kWgRows < t_len;
  const float* bias_b = bias + int64_t(b) * s_len;
  // the last key each of this thread's two rows sees unmasked by the causal bias
  const int key_limit[2] = {t0 + row_in_block + causal_offset,
                            t0 + row_in_block + 8 + causal_offset};

  float o[G::kAtoms][G::kORegs];
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < G::kORegs; ++i) o[a][i] = 0.f;
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.f, 0.f};

  if (active) hopper::mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    if (active) {
      hopper::mbar_wait(&kv_bar[stage], (j / kStages) & 1);
      const uint8_t* k_tile = ks + stage * G::kKVBytes;
      const uint8_t* v_tile = vs + stage * G::kKVBytes;

      // S = Q . K^T over the padded head dim, 16 columns a step
      float s[kTileKeys / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::kDp / 16; ++kk) {
        const int atom = (16 * kk) / G::kAtomCols;
        const int in_row = (16 * kk) % G::kAtomCols * 2;
        const uint64_t da = hopper::make_desc(
            qs + atom * G::kQAtom + wg * kWgRows * G::kRowBytes + in_row, G::kGroup, G::kLayout);
        const uint64_t db =
            hopper::make_desc(k_tile + atom * G::kKVAtom + in_row, G::kGroup, G::kLayout);
        hopper::wgmma_ss_m64n128k16(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // logits: scale, pad bias, then the causal bias by index (the TPU
      // kernel's order of the two additions); keys past S masked by index;
      // s[4c + 2r + e] is (row r, key 8c + col_in_chunk + e) of the tile
      const int s0 = j * kTileKeys;
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int c = 0; c < kTileKeys / 8; ++c) {
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
      for (int c = 0; c < kTileKeys / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool valid = s0 + 8 * c + col_in_chunk + e < s_len;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p =
                valid ? exp2f((s[4 * c + 2 * r + e] - m_run[r]) * kLog2e) : 0.f;
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
      for (int a = 0; a < G::kAtoms; ++a)
#pragma unroll
        for (int i = 0; i < G::kORegs; ++i) o[a][i] *= alpha[(i / 2) % 2];

      // P (bf16, unnormalised) as the A fragments of the 16-key steps:
      // registers {row r, keys 16kk + col_in_chunk (+8)} of the S layout
      uint32_t pa[kTileKeys / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk) {
        pa[kk][0] = hopper::pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = hopper::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = hopper::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = hopper::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileKeys / 16; ++kk)
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a)
          hopper::wgmma_rs_tb<G::kORegs>(
              o[a], pa[kk],
              hopper::make_desc(v_tile + a * G::kKVAtom + kk * 16 * G::kRowBytes, G::kGroup,
                                G::kLayout));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a) hopper::fence_regs(o[a]);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + kStages < n_tiles)
      load_kv_tile<D>(&k_map, &v_map, ks, vs, kv_bar, j + kStages, stage, h, b);
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + row_in_block + 8 * r;
    if (t >= t_len) continue;
    __nv_bfloat16* o_row = out + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int a = 0; a < G::kAtoms; ++a) {
#pragma unroll
      for (int c = 0; c < G::kAtomCols / 8; ++c) {
        const int col = a * G::kAtomCols + 8 * c + col_in_chunk;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(
              o[a][4 * c + 2 * r] / l_run[r], o[a][4 * c + 2 * r + 1] / l_run[r]);
      }
    }
    if (m_out != nullptr && lane % 4 == 0) {  // the row's four threads hold equal m, l
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m_run[r];
      l_out[stat] = l_run[r];
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         void* out, float* m_out, float* l_out, int batch, int t_len,
                         int s_len, int heads, int causal, int causal_offset,
                         const int64_t* sq, const int64_t* sk, const int64_t* sv,
                         cudaStream_t stream) {
  using G = Geometry<D>;
  CUtensorMap q_map, k_map, v_map;
  // boxes of one swizzle atom of columns and a q tile's or a K/V tile's rows
  if (!hopper::encode_head_map(&q_map, q, batch, t_len, heads, D, sq, G::kAtomCols, kBlockRows) ||
      !hopper::encode_head_map(&k_map, k, batch, s_len, heads, D, sk, G::kAtomCols, kTileKeys) ||
      !hopper::encode_head_map(&v_map, v, batch, s_len, heads, D, sv, G::kAtomCols, kTileKeys))
    return cudaErrorInvalidValue;
  const auto kernel =
      causal ? attention_fwd_wgmma_kernel<D, true> : attention_fwd_wgmma_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(G::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kBlockRows - 1) / kBlockRows, heads, batch);
  kernel<<<grid, kWgThreads, G::kSmem, stream>>>(
      q_map, k_map, v_map, bias, static_cast<__nv_bfloat16*>(out), m_out, l_out, t_len, s_len,
      heads, causal_offset, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, int head_dim, const void* q, const void* k, const void* v,
                     const float* bias, void* out, float* m_out, float* l_out, int batch,
                     int t_len, int s_len, int heads, int causal, int causal_offset,
                     const int64_t* sq, const int64_t* sk, const int64_t* sv,
                     cudaStream_t stream) {
#define PIT_LAUNCH(D)                                                                         \
  (dtype == 0 ? launch_scalar<D>(q, k, v, bias, out, m_out, l_out, batch, t_len, s_len,        \
                                 heads, causal, causal_offset, sq, sk, sv, stream)            \
              : launch_wgmma<D>(q, k, v, bias, out, m_out, l_out, batch, t_len, s_len, heads,  \
                                causal, causal_offset, sq, sk, sv, stream))
  switch (head_dim) {
    case 8: return PIT_LAUNCH(8);
    case 16: return PIT_LAUNCH(16);
    case 32: return PIT_LAUNCH(32);
    case 64: return PIT_LAUNCH(64);
    case 128: return PIT_LAUNCH(128);
    case 256:
    case 512:
    case 1024:  // the deep designs (attention_deep.cu)
      return attn_deep::fwd(dtype, head_dim, q, k, v, bias, out, m_out, l_out, batch, t_len,
                            s_len, heads, causal, causal_offset, sq, sk, sv, stream);
    default: return cudaErrorInvalidValue;
  }
#undef PIT_LAUNCH
}

}  // namespace

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design).
// q is (B, T, H, D) and k/v are (B, S, H, D), each with unit stride along D
// and the given (batch, row, head) strides in elements (bf16: 16-byte aligned
// bases and strides that are multiples of 8, for TMA); bias is (B, S) f32
// contiguous; out is (B, T, H, D) contiguous; m_out and l_out are both null,
// or both (B, H, T) f32 contiguous. causal (0 or 1) adds the causal bias:
// -1e30 where key s > t + causal_offset. Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue if a tensor map cannot be
// encoded).
extern "C" int attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* bias, void* out, void* m_out,
                             void* l_out, int batch,
                             int t_len, int s_len, int heads, int causal, int causal_offset,
                             int64_t sqb, int64_t sqt, int64_t sqh,
                             int64_t skb, int64_t sks, int64_t skh,
                             int64_t svb, int64_t svs, int64_t svh, void* stream) {
  const int64_t sq[3] = {sqb, sqt, sqh};
  const int64_t sk[3] = {skb, sks, skh};
  const int64_t sv[3] = {svb, svs, svh};
  float* m_f = static_cast<float*>(m_out);
  float* l_f = static_cast<float*>(l_out);
  if ((m_f == nullptr) != (l_f == nullptr) || (dtype != 0 && dtype != 1) ||
      (causal != 0 && causal != 1))
    return cudaErrorInvalidValue;
  return dispatch(dtype, head_dim, q, k, v, static_cast<const float*>(bias), out, m_f, l_f,
                  batch, t_len, s_len, heads, causal, causal_offset, sq, sk, sv,
                  static_cast<cudaStream_t>(stream));
}
