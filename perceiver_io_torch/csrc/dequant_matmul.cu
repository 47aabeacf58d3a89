// Weight-only dequantizing matmul for quantized serving, written by hand for
// Hopper (sm_90a).
//
// Replaces: perceiver_io_tpu/ops/pallas_matmul.py::dequant_matmul (Pallas
// kernel _dequant_matmul_kernel).
//
// Computes out (M, N) = x (M, K) @ (q (K, N) * scale), with the convert and
// the scale applied per weight tile inside the kernel and f32 accumulation.
//   bits 8: q is int8 (K, N), values in [-127, 127], scale (N,) per channel.
//   bits 4: q is packed two nibbles per uint8 along K, (K/2, N): the low
//           nibble holds the even row, the high nibble the odd row, each
//           sign-extended, values in [-7, 7].
//   group_size 0 means per-channel scales (N,); otherwise scales are grouped
//   (K / group_size, N) and row k of column n dequantizes by
//   scale[k / group_size, n].
// x and out are float32 or bfloat16 (out has x's dtype). With f32 x the
// product is exact f32 (FMAs, no TF32); with bf16 x the dequantized weight
// is rounded to bf16 first, as the TPU kernel's w.astype(x.dtype) does.
//
// What bounds it on the H100: the weight stream. At the serving shapes the
// int bytes are few (a 512 x 512 int8 kernel is 256 KB) but M is large (the
// self-attention projections see M = B.N = 16384 rows), so the product is
// 2.M.K.N = 8.6 GFLOP against ~34 MB of x/out: ~250 FLOP/byte, just under
// the bf16 ridge, bytes first (10 us) and operations close behind (8.7 us).
// The vocab head (M = 512, N = 10003) is bound by its weight bytes. This
// first kernel is the simple, correct design: 64 x 64 output tiles, 32-deep
// K tiles staged through shared memory (x transposed, the weight tile
// dequantized to f32 on the way in), a 4 x 4 register block of scalar f32
// FMAs per thread. It reads the int bytes once per 64-row band of x; tensor
// cores (wgmma) and TMA are later work, so in practice it runs against the
// 67 TF/s non-tensor f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 block of outputs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int BITS>
__device__ __forceinline__ int load_q(const uint8_t* __restrict__ q, int k, int n, int cols) {
  if (BITS == 8) return int(reinterpret_cast<const int8_t*>(q)[int64_t(k) * cols + n]);
  const int byte = q[int64_t(k >> 1) * cols + n];
  const int nib = (k & 1) ? (byte >> 4) : (byte & 0xF);
  return (nib ^ 8) - 8;  // sign-extend the 4-bit value
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int rows, int depth, int cols, int group_size) {
  __shared__ float xs[kBK][kBM + 1];  // x tile, transposed
  __shared__ float ws[kBK][kBN + 1];  // dequantized weight tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < rows && k < depth) ? to_f32(x[int64_t(m) * depth + k]) : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < depth && n < cols) {
        const float s = group_size > 0 ? scale[int64_t(k / group_size) * cols + n] : scale[n];
        w = round_to<T>(float(load_q<BITS>(q, k, n, cols)) * s);
      }
      ws[r][c] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < cols) out[int64_t(m) * cols + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const void* q, const float* scale, void* out, int rows,
                   int depth, int cols, int group_size, cudaStream_t stream) {
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  dequant_matmul_kernel<T, BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), scale, static_cast<T*>(out),
      rows, depth, cols, group_size);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). bits: 8 or 4. group_size: 0
// for per-channel scales, else the rows per scale group (must divide K).
// All arrays are contiguous. Returns the cudaError_t of the launch.
extern "C" int dequant_matmul(int dtype, int bits, int group_size, const void* x,
                              const void* q, const void* scale, void* out, int rows,
                              int depth, int cols, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bits == 8)
    return launch<float, 8>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 0 && bits == 4)
    return launch<float, 4>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 1 && bits == 8)
    return launch<__nv_bfloat16, 8>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 1 && bits == 4)
    return launch<__nv_bfloat16, 4>(x, q, s, out, rows, depth, cols, group_size, st);
  return cudaErrorInvalidValue;
}
