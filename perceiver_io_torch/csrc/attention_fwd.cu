// Fused multi-head attention forward for the Perceiver latent attention,
// written by hand for Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_attention.py::_fused_attention_fwd_impl
// (Pallas kernel _attention_kernel), the forward of fused_attention without
// causal_offset, with or without the with_lse statistics.
//
// Computes, per (batch b, head h, query row t):
//   out[b,t,h,:] = softmax_s(q[b,t,h,:] . k[b,s,h,:] * D^-0.5 + bias[b,s]) @ v[b,:,h,:]
// with the additive pad bias of the TPU kernel (0 or -1e30). The bias is
// finite, so a fully masked row softmaxes to uniform over all S keys (the
// mean of v), exactly as the TPU kernel and the einsum path give. Logits,
// running max, denominator and accumulator are f32; the probabilities are
// rounded to the value dtype before the P.V product, as the TPU kernel's
// p.astype(v.dtype) does; the output is written in the input dtype.
//
// What bounds it on the H100: at the serving shapes (e.g. the encoder
// cross-attention B=64, T=256, S=512, H=4, D=128 in bf16) the work is
// 4.B.H.T.S.D = 17.2 GFLOP against 101 MB of q/k/v/out, ~170 FLOP/byte:
// below the bf16 ridge (~295 FLOP/byte), so the least time is set by bytes
// at 3.35 TB/s (30 us), with the operations at 989 TF/s close behind
// (17 us). This first kernel is the simple, correct design: it reads each
// input once, but runs both products as scalar f32 FMAs (no tensor cores),
// so in practice it is bound by the 67 TF/s non-tensor f32 rate and by
// shared-memory bandwidth; moving the two products onto wgmma is later work.
//
// Design: one block per (64-query tile, head, batch); 256 threads, four per
// query row. The query tile and each 64-key K/V tile are staged through
// shared memory as f32 (row stride D+1, so column reads hit distinct banks);
// the online softmax (running max m, denominator l) and the D/4 accumulator
// columns of each thread stay in registers across K/V tiles, so the (T, S)
// logits never reach device memory. Each thread scores 16 of the tile's 64
// keys; the four threads of a row combine max and sum with warp shuffles and
// exchange probabilities through a per-row shared-memory strip.
//
// Statistics (the training forward): given m_out/l_out, the kernel also
// writes each row's final running max m and denominator l as (B, H, T) f32,
// the residuals the backward (attention_bwd.cu) recomputes the
// probabilities from as exp(logit - m) / l. They stay two arrays, not one
// log-sum-exp: on a fully masked row m is pinned at -1e30, which would
// absorb log l in f32. The TPU kernel's 128-lane broadcast of m and l is a
// Mosaic layout artefact and is not copied. Serving passes null pointers
// and writes nothing extra.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                   // query rows per block
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kLanes = 4;                   // threads per query row
constexpr int kThreads = kRows * kLanes;    // 256
constexpr int kKeysPerLane = kKeys / kLanes;
constexpr float kMaskValue = -1e30f;        // pallas_attention.MASK_VALUE

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the probabilities enter P.V in the value dtype (p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * (D + 1) + 2 * size_t(kKeys) * (D + 1) +
                          size_t(kRows) * (kKeys + 1) + kKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, float* __restrict__ m_out,
                     float* __restrict__ l_out, int t_len, int s_len, int heads,
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

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const float* biasb = bias + int64_t(b) * s_len;

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = t0 + r;
    qs[r * DP + d] = t < t_len ? to_f32(qb[t * sqt + d]) : 0.f;
  }

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = kMaskValue;
  float l = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += kKeys) {
    const int n = min(kKeys, s_len - s0);
    __syncthreads();  // the previous tile is consumed (and the q tile stored)
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      if (r < n) {
        ks[r * DP + d] = to_f32(kb[(s0 + r) * sks + d]);
        vs[r * DP + d] = to_f32(vb[(s0 + r) * svs + d]);
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
      ps[row * PP + j] = round_to<T>(p);
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
    T* o = out + ((int64_t(b) * t_len + t) * heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[lane + i * kLanes] = from_f32<T>(acc[i] / l);
    if (m_out != nullptr && lane == 0) {  // the row's four threads hold equal m, l
      const int64_t stat = (int64_t(b) * heads + h) * t_len + t;
      m_out[stat] = m;
      l_out[stat] = l;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* out, float* m_out, float* l_out, int batch, int t_len,
                   int s_len, int heads,
                   const int64_t* sq, const int64_t* sk, const int64_t* sv,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + kRows - 1) / kRows, heads, batch);
  attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(out), m_out, l_out, t_len, s_len, heads, sq[0], sq[1], sq[2],
      sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], 1.0f / sqrtf(float(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int head_dim, const void* q, const void* k, const void* v,
                              const float* bias, void* out, float* m_out, float* l_out,
                              int batch, int t_len, int s_len, int heads,
                              const int64_t* sq, const int64_t* sk, const int64_t* sv,
                              cudaStream_t stream) {
#define PIT_LAUNCH(D) \
  launch<T, D>(q, k, v, bias, out, m_out, l_out, batch, t_len, s_len, heads, sq, sk, sv, stream)
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is (B, T, H, D) and k/v are (B, S, H, D),
// each with unit stride along D and the given (batch, row, head) strides in
// elements; bias is (B, S) f32 contiguous; out is (B, T, H, D) contiguous;
// m_out and l_out are both null, or both (B, H, T) f32 contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int attention_fwd(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* bias, void* out, void* m_out,
                             void* l_out, int batch,
                             int t_len, int s_len, int heads,
                             int64_t sqb, int64_t sqt, int64_t sqh,
                             int64_t skb, int64_t sks, int64_t skh,
                             int64_t svb, int64_t svs, int64_t svh, void* stream) {
  const int64_t sq[3] = {sqb, sqt, sqh};
  const int64_t sk[3] = {skb, sks, skh};
  const int64_t sv[3] = {svb, svs, svh};
  const float* bias_f = static_cast<const float*>(bias);
  float* m_f = static_cast<float*>(m_out);
  float* l_f = static_cast<float*>(l_out);
  if ((m_f == nullptr) != (l_f == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(head_dim, q, k, v, bias_f, out, m_f, l_f, batch, t_len,
                                    s_len, heads, sq, sk, sv, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k, v, bias_f, out, m_f, l_f, batch,
                                            t_len, s_len, heads, sq, sk, sv, st);
  return cudaErrorInvalidValue;
}
