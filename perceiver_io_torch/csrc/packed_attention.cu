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
// function. A fully masked row attends uniformly (the mean of v); its dq and
// dk are exactly 0, its dv contribution stays.
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
// SM on 132 SMs at 1980 MHz: the exponentials bound it. This first design
// runs every product as scalar f32 FMAs from shared memory (no tensor
// cores) and recomputes the logits in each pass, so the non-tensor f32 rate
// and shared-memory bandwidth bound it in practice; wgmma is later work.
//
// Design: one block per (64-row tile, head, b), 256 threads, four lanes per
// row; the looped tile is 64 rows, staged through shared memory as f32 with
// row stride D+1 (column reads hit distinct banks). A first design let a
// block own all H heads of 16 rows, to stage each row as one contiguous run
// of E channels; every block then re-staged the whole K/V for a quarter of
// the rows; its forward measured 1.9x this one's time at the C=64 encoder
// cross and 3.4x at E=512 (chip_smoke.py on one H100, PERF.md).
// - forward: one block per query tile. Pass 1 over the key tiles takes each
//   row's running max and denominator (per lane, then combined across the
//   four lanes by shuffles); pass 2 recomputes the logits, normalises, rounds
//   p to v's dtype into a per-row shared strip and accumulates P.V, D/4
//   columns a lane.
// - dq: one block per query tile. Pass 1 takes m, the denominator l and
//   u = sum exp(logit - m) * dp online (delta = u / l); pass 2 forms ds and
//   accumulates dq. It writes (m, l, delta) per (b, t, h) into a (B, T, H, 3)
//   f32 scratch for the dk/dv kernel.
// - dk/dv: one block per key tile owning its keys; it loops over the query
//   tiles (q, g and the scratch), recomputes p and ds and accumulates dk and
//   dv.
// No atomics: each block owns its outputs, so results repeat bit for bit.
// Rows past T and keys past S are staged as zeros and contribute nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // rows (queries or keys) a block owns
constexpr int kTile = 64;                 // rows of the tile the block loops over
constexpr int kLanes = 4;                 // threads per owned row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kPerLane = kTile / kLanes;  // tile rows each thread scores
constexpr float kMaskValue = -1e30f;      // pallas_attention.MASK_VALUE

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a value entering a product in the input dtype (p.astype(v.dtype), ...)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Strides {  // (batch, row) strides in elements of q, k, v, g
  int64_t qb, qt, kb, ks, vb, vs, gb, gt;
};

// rows [r0, r0 + 64) of one head's D channels (row stride rs) into an f32
// [64][D + 1] tile; rows at or past n become zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* tile, const T* src, int64_t rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * (D + 1) + d] = r0 + r < n ? to_f32(src[(r0 + r) * rs + d]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, T* __restrict__ out, int t_len, int s_len,
                  int heads, Strides st, float scale) {
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
  const T* kb = k + b * st.kb + h * D;
  const T* vb = v + b * st.vb + h * D;
  const float* biasb = bias + int64_t(b) * s_len;

  stage<T, D>(qs, q + b * st.qb + h * D, st.qt, t0, t_len);
  const float* qrow = qs + row * DP;

  // pass 1: the row max and the denominator
  float m = -FLT_MAX, l = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    stage<T, D>(ks, kb, st.ks, s0, s_len);
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

  // pass 2: normalised probabilities, rounded to v's dtype, times v
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();
    stage<T, D>(ks, kb, st.ks, s0, s_len);
    stage<T, D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane];
    dots<D>(s, qrow, ks, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      const float p = j < n ? expf(s[i] * scale + bs[j] - m) / l : 0.f;
      ps[row * PP + j] = round_to<T>(p);
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
    T* o = out + (int64_t(b) * t_len + t) * (int64_t(heads) * D) + h * D + lane;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) o[i * kLanes] = from_f32<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ bias,
                     T* __restrict__ dq, float* __restrict__ stats, int t_len, int s_len,
                     int heads, Strides st, float scale) {
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
  const T* kb = k + b * st.kb + h * D;
  const T* vb = v + b * st.vb + h * D;
  const float* biasb = bias + int64_t(b) * s_len;

  stage<T, D>(qs, q + b * st.qb + h * D, st.qt, t0, t_len);
  stage<T, D>(gs, g + b * st.gb + h * D, st.gt, t0, t_len);
  const float* qrow = qs + row * DP;
  const float* grow = gs + row * DP;

  // pass 1: m, l and u = sum exp(logit - m) * dp, online; delta = u / l
  float m = -FLT_MAX, l = 0.f, u = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage<T, D>(ks, kb, st.ks, s0, s_len);
    stage<T, D>(vs, vb, st.vs, s0, s_len);
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

  // pass 2: ds, rounded to q's dtype, times k
  float acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();
    stage<T, D>(ks, kb, st.ks, s0, s_len);
    stage<T, D>(vs, vb, st.vs, s0, s_len);
    if (tid < kTile) bs[tid] = tid < n ? biasb[s0 + tid] : 0.f;
    __syncthreads();
    float s[kPerLane], dp[kPerLane];
    dots<D>(s, qrow, ks, lane);
    dots<D>(dp, grow, vs, lane);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int j = lane + i * kLanes;
      const float p = expf(s[i] * scale + bs[j] - m) / l;
      const float ds = (masked_row || j >= n) ? 0.f : p * (dp[i] - delta) * scale;
      dss[row * PP + j] = round_to<T>(ds);
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
    T* o = dq + (int64_t(b) * t_len + t) * (int64_t(heads) * D) + h * D + lane;
#pragma unroll
    for (int i = 0; i < D / kLanes; ++i) o[i * kLanes] = from_f32<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
packed_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ g, const float* __restrict__ bias,
                      const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                      int t_len, int s_len, int heads, Strides st, float scale) {
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
  const T* qb = q + b * st.qb + h * D;
  const T* gb = g + b * st.gb + h * D;

  stage<T, D>(ks, k + b * st.kb + h * D, st.ks, s0, s_len);
  stage<T, D>(vs, v + b * st.vb + h * D, st.vs, s0, s_len);
  const float* krow = ks + row * DP;
  const float* vrow = vs + row * DP;
  const float bias_s = s_idx < s_len ? bias[int64_t(b) * s_len + s_idx] : 0.f;

  float dk_acc[D / kLanes], dv_acc[D / kLanes];
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int n = min(kTile, t_len - t0);
    __syncthreads();  // the previous tile is consumed (and the k, v tiles stored)
    stage<T, D>(qs, qb, st.qt, t0, t_len);
    stage<T, D>(gs, gb, st.gt, t0, t_len);
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
      const float ds = m_j <= 0.5f * kMaskValue ? 0.f : p * (dp[i] - sts[j * 3 + 2]) * scale;
      ps[row * PP + j] = round_to<T>(p);
      dss[row * PP + j] = round_to<T>(ds);
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
      dk[o + i * kLanes] = from_f32<T>(dk_acc[i]);
      dv[o + i * kLanes] = from_f32<T>(dv_acc[i]);
    }
  }
}

template <int D>
constexpr size_t smem_floats(int staged_tiles, int strips, int extra) {
  return size_t(staged_tiles) * kTile * (D + 1) + size_t(strips) * kRows * (kTile + 1) + extra;
}

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, int D>
cudaError_t launch(Kind kind, const Args& a) {
  const int owned = kind == Kind::kDkv ? a.s_len : a.t_len;  // rows the blocks own
  const dim3 grid((owned + kRows - 1) / kRows, a.heads, a.batch);
  const float scale = float(1.0 / sqrt(double(D)));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  cudaError_t err;
  if (kind == Kind::kFwd) {  // q, k, v tiles, the p strip, the bias tile
    const size_t smem = sizeof(float) * smem_floats<D>(3, 1, kTile);
    if ((err = allow_smem(packed_fwd_kernel<T, D>, smem)) != cudaSuccess) return err;
    packed_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, a.bias, static_cast<T*>(a.out), a.t_len, a.s_len, a.heads, a.st, scale);
  } else if (kind == Kind::kDq) {  // q, g, k, v tiles, the ds strip, the bias tile
    const size_t smem = sizeof(float) * smem_floats<D>(4, 1, kTile);
    if ((err = allow_smem(packed_bwd_dq_kernel<T, D>, smem)) != cudaSuccess) return err;
    packed_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.bias, static_cast<T*>(a.out), a.stats, a.t_len, a.s_len, a.heads, a.st,
        scale);
  } else {  // k, v, q, g tiles, the p and ds strips, the (m, l, delta) tile
    const size_t smem = sizeof(float) * smem_floats<D>(4, 2, 3 * kTile);
    if ((err = allow_smem(packed_bwd_dkv_kernel<T, D>, smem)) != cudaSuccess) return err;
    packed_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.bias, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.t_len,
        a.s_len, a.heads, a.st, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, Kind kind, const Args& a) {
  switch (head_dim) {
    case 8: return launch<T, 8>(kind, a);
    case 16: return launch<T, 16>(kind, a);
    case 32: return launch<T, 32>(kind, a);
    case 64: return launch<T, 64>(kind, a);
    case 128: return launch<T, 128>(kind, a);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int head_dim, Kind kind, const Args& a) {
  if (a.heads <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_head_dim<float>(head_dim, kind, a);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(head_dim, kind, a);
  return cudaErrorInvalidValue;
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

// dtype: 0 = float32, 1 = bfloat16. q and g are (B, T, E), k and v (B, S, E),
// E = heads * head_dim, each with unit stride along E and the given (batch,
// row) strides in elements; bias is (B, S) f32 contiguous; out, dq are
// (B, T, E) and dk, dv (B, S, E), contiguous; stats is the (B, T, H, 3) f32
// (m, l, delta) scratch the dq kernel writes and the dk/dv kernel reads. Each
// returns the cudaError_t of its launch (0 on success).
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
