// Fused multi-head attention backward for the Perceiver latent attention,
// written by hand for Hopper (sm_90a): one kernel for dq, one for dk and dv.
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_bwd_impl,
// Pallas kernels _bwd_dq_kernel (dq) and _bwd_dkv_kernel (dk, dv), without
// causal_offset.
//
// Computes, per (batch b, head h), from the forward's saved row statistics
// m (running max) and l (denominator) and delta[t] = sum_d g[t,d] * out[t,d]:
//   logit[t,s] = q[t] . k[s] * D^-0.5 + bias[b,s]        (bias after the scale)
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
//
// What bounds it on the H100: at the training shapes (the encoder
// cross-attention B=64, T=256, S=512, H=4, D=128 in bf16) the two kernels
// recompute the logits and g.v^T in both passes, seven products of
// 2.B.H.T.S.D (60 GFLOP) against 201 MB of q, k, v, out, g, dq, dk, dv;
// the least time is the bytes at 3.35 TB/s (60 us), the five products the
// function needs at 989 TF/s close behind (43 us). Like the forward, this
// first design runs every product as scalar f32 FMAs from shared memory (no
// tensor cores), so it is bound by the 67 TF/s non-tensor f32 rate and by
// shared-memory bandwidth; wgmma for the products is later work.
//
// Design: two launches, each deterministic (no atomics), each owning its
// outputs outright, so no block ever sums into another's.
// - dq kernel: one block per (64-query tile, head, batch), 256 threads, four
//   per query row. The q and g tiles stay in shared memory; the block loops
//   over 64-key K/V tiles, and each thread recomputes p and ds for 16 of the
//   tile's keys, passes the rounded ds to its row's other three threads
//   through a per-row shared strip, and accumulates D/4 columns of dq in
//   registers.
// - dk/dv kernel: one block per (64-key tile, head, batch), four threads per
//   key row. The k and v tiles stay in shared memory; the block loops over
//   64-query tiles (q, g, m, l, delta), each thread recomputes p and ds for
//   16 of the tile's queries against its key, and accumulates D/4 columns of
//   dk and of dv in registers.
// Tiles are staged as f32 with row stride D+1, so column reads hit distinct
// banks; rows past the end of T or S are staged as zeros and contribute 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// a value entering a product in the input dtype (ds.astype(k.dtype), ...)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [r0, r0 + kRows) of a (.., n, ., D) operand with row stride `rs` into
// an f32 [kRows][D + 1] tile; rows at or past n become zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* tile, const T* src, int64_t rs, int r0, int n) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    tile[r * (D + 1) + d] = r0 + r < n ? to_f32(src[(r0 + r) * rs + d]) : 0.f;
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

struct Strides {  // (batch, row, head) strides in elements of q, k, v, g
  int64_t qb, qt, qh, kb, ks, kh, vb, vs, vh, gb, gt, gh;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ bias, const float* __restrict__ m,
                        const float* __restrict__ l, const float* __restrict__ delta,
                        T* __restrict__ dq, int t_len, int s_len, int heads, Strides st,
                        float scale) {
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

  stage<T, D>(qs, q + b * st.qb + h * st.qh, st.qt, t0, t_len);
  stage<T, D>(gs, g + b * st.gb + h * st.gh, st.gt, t0, t_len);
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const float* biasb = bias + int64_t(b) * s_len;

  const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
  const bool live = t < t_len;
  const float m_t = live ? m[stat] : 0.f;
  const float l_t = live ? l[stat] : 1.f;
  const float delta_t = live ? delta[stat] : 0.f;
  const bool masked_row = !live || m_t <= 0.5f * kMaskValue;

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += kTile) {
    const int n = min(kTile, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q, g tiles stored)
    stage<T, D>(ks, kb, st.ks, s0, s_len);
    stage<T, D>(vs, vb, st.vs, s0, s_len);
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
      const float p = expf(s[i] * scale + bs[j] - m_t) / l_t;
      const float ds = (masked_row || j >= n) ? 0.f : p * (dp[i] - delta_t);
      dss[row * PP + j] = round_to<T>(ds);
    }
    __syncwarp();  // the row's four threads see each other's ds

    for (int j = 0; j < n; ++j) {
      const float ds = dss[row * PP + j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(ds, ks[j * DP + lane + i * kLanes], acc[i]);
    }
  }

  if (live) {
    T* o = dq + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[lane + i * kLanes] = from_f32<T>(acc[i] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ bias, const float* __restrict__ m,
                         const float* __restrict__ l, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int t_len, int s_len,
                         int heads, Strides st, float scale) {
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

  stage<T, D>(ks, k + b * st.kb + h * st.kh, st.ks, s0, s_len);
  stage<T, D>(vs, v + b * st.vb + h * st.vh, st.vs, s0, s_len);
  const T* qb = q + b * st.qb + h * st.qh;
  const T* gb = g + b * st.gb + h * st.gh;
  const int64_t stat0 = (int64_t(b) * heads + h) * t_len;
  const float bias_s = s_idx < s_len ? bias[int64_t(b) * s_len + s_idx] : 0.f;

  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += kTile) {
    const int n = min(kTile, t_len - t0);
    __syncthreads();  // the previous tile is consumed (and the k, v tiles stored)
    stage<T, D>(qs, qb, st.qt, t0, t_len);
    stage<T, D>(gs, gb, st.gt, t0, t_len);
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
      const float p = j < n ? expf(s[i] * scale + bias_s - m_j) / ls[j] : 0.f;
      const float ds = m_j <= 0.5f * kMaskValue ? 0.f : p * (dp[i] - des[j]);
      ps[row * PP + j] = round_to<T>(p);
      dss[row * PP + j] = round_to<T>(ds);
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
      dk[o + lane + i * kLanes] = from_f32<T>(dk_acc[i] * scale);
      dv[o + lane + i * kLanes] = from_f32<T>(dv_acc[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *g;
  const float *bias, *m, *l, *delta;
  void *dq, *dk, *dv;
  int batch, t_len, s_len, heads;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kRows - 1) / kRows, a.heads, a.batch);
  attention_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.bias, a.m, a.l, a.delta, static_cast<T*>(a.dq),
      a.t_len, a.s_len, a.heads, a.st, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s_len + kRows - 1) / kRows, a.heads, a.batch);
  attention_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.bias, a.m, a.l, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.t_len, a.s_len, a.heads, a.st, 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <bool kDq, typename T>
cudaError_t dispatch_head_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 8: return kDq ? launch_dq<T, 8>(a) : launch_dkv<T, 8>(a);
    case 16: return kDq ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (dtype == 0) return dispatch_head_dim<kDq, float>(head_dim, a);
  if (dtype == 1) return dispatch_head_dim<kDq, __nv_bfloat16>(head_dim, a);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* g, const void* bias,
               const void* m, const void* l, const void* delta, void* dq, void* dk, void* dv,
               int batch, int t_len, int s_len, int heads, const int64_t* strides,
               void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.bias = static_cast<const float*>(bias);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.batch = batch; a.t_len = t_len; a.s_len = s_len; a.heads = heads;
  a.st = Strides{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                 strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and g are (B, T, H, D), k and v are
// (B, S, H, D), each with unit stride along D and the given (batch, row, head)
// strides in elements; bias is (B, S) f32 contiguous; m, l and delta are
// (B, H, T) f32 contiguous; dq is (B, T, H, D) and dk, dv are (B, S, H, D),
// contiguous. Each returns the cudaError_t of its launch (0 on success).
extern "C" int attention_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* g, const void* bias,
                                const void* m, const void* l, const void* delta, void* dq,
                                int batch, int t_len, int s_len, int heads,
                                int64_t sqb, int64_t sqt, int64_t sqh,
                                int64_t skb, int64_t sks, int64_t skh,
                                int64_t svb, int64_t svs, int64_t svh,
                                int64_t sgb, int64_t sgt, int64_t sgh, void* stream) {
  const int64_t strides[12] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sgb, sgt, sgh};
  return dispatch<true>(dtype, head_dim,
                        make_args(q, k, v, g, bias, m, l, delta, dq, nullptr, nullptr,
                                  batch, t_len, s_len, heads, strides, stream));
}

extern "C" int attention_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* g, const void* bias,
                                 const void* m, const void* l, const void* delta, void* dk,
                                 void* dv, int batch, int t_len, int s_len, int heads,
                                 int64_t sqb, int64_t sqt, int64_t sqh,
                                 int64_t skb, int64_t sks, int64_t skh,
                                 int64_t svb, int64_t svs, int64_t svh,
                                 int64_t sgb, int64_t sgt, int64_t sgh, void* stream) {
  const int64_t strides[12] = {sqb, sqt, sqh, skb, sks, skh, svb, svs, svh, sgb, sgt, sgh};
  return dispatch<false>(dtype, head_dim,
                         make_args(q, k, v, g, bias, m, l, delta, nullptr, dk, dv,
                                   batch, t_len, s_len, heads, strides, stream));
}
