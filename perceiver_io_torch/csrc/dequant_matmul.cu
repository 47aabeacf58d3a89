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
// is rounded to bf16 first, round_bf16(float(q) * scale), as the TPU
// kernel's w.astype(x.dtype) does.
//
// What bounds it on the H100: at the serving shapes the int bytes are few
// (a 512 x 512 int8 kernel is 256 KB) but M is large (the self-attention
// projections see M = B.N = 16384 rows), so the product is 2.M.K.N =
// 8.6 GFLOP against ~34 MB of x/out: ~250 FLOP/byte, just under the bf16
// ridge, bytes first (10 us) and operations close behind (8.7 us). The
// vocab head (M = 512, N = 10003) is bound by its weight bytes.
//
// Two designs, chosen by dtype (not a fallback):
//
// - float32: exact f32, scalar FMAs (wgmma has no full-f32 mode; the TPU
//   kernel asks for HIGHEST precision there): 64 x 64 output tiles, 32-deep
//   K tiles staged through shared memory (x transposed, the weight tile
//   dequantized to f32 on the way in), a 4 x 4 register block per thread.
//
// - bfloat16: a mixed-input tensor-core GEMM. A block of two consumer
//   warpgroups owns a 128 x 128 output tile and walks K in 64-deep steps
//   through a two-stage ring: TMA brings the x tile (K-major, 128-byte
//   swizzle, ragged M and K zero-filled), while the threads load the int
//   bytes of the (64, 128) weight tile into registers, dequantize them to
//   bf16 and store them K-major in the same swizzle, so both operands of
//   the SS wgmma (m64 n128 k16, f32 accumulators) are K-major. The int bytes
//   are read once per 128-row band of x; the next step's bytes are in
//   flight while the current step's products run. The weight loads take 4
//   bytes (4 columns) at a time where every row of q is 4-byte aligned (N a
//   multiple of 4) and single bytes otherwise (the vocab head's N = 10003);
//   the output is stored in bf16 pairs where N is even, singly otherwise,
//   masked at the M and N edges.

#include "hopper.cuh"

#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: the exact scalar design
// ---------------------------------------------------------------------------

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 block of outputs

template <int BITS>
__device__ __forceinline__ int load_q(const uint8_t* __restrict__ q, int k, int n, int cols) {
  if (BITS == 8) return int(reinterpret_cast<const int8_t*>(q)[int64_t(k) * cols + n]);
  const int byte = q[int64_t(k >> 1) * cols + n];
  const int nib = (k & 1) ? (byte >> 4) : (byte & 0xF);
  return (nib ^ 8) - 8;  // sign-extend the 4-bit value
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ out,
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
      xs[c][r] = (m < rows && k < depth) ? x[int64_t(m) * depth + k] : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int k = k0 + r, n = n0 + c;
      float w = 0.f;
      if (k < depth && n < cols) {
        const float s = group_size > 0 ? scale[int64_t(k / group_size) * cols + n] : scale[n];
        w = float(load_q<BITS>(q, k, n, cols)) * s;
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
      if (n < cols) out[int64_t(m) * cols + n] = acc[i][j];
    }
  }
}

template <int BITS>
cudaError_t launch_scalar(const void* x, const void* q, const float* scale, void* out, int rows,
                          int depth, int cols, int group_size, cudaStream_t stream) {
  const dim3 grid((cols + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  dequant_matmul_kernel<BITS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(q), scale,
      static_cast<float*>(out), rows, depth, cols, group_size);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma design
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;            // output rows per block (two warpgroups of 64)
constexpr int kTileN = 128;            // output columns per block
constexpr int kTileK = 64;             // K per step: one 128-byte swizzle row of bf16
constexpr int kWgThreads = 256;
constexpr int kTileBytes = kTileM * kTileK * 2;   // an x tile; the weight tile is the same
constexpr int kRawBytes = kTileK * kTileN;        // one step's int bytes (int4 fills half)
constexpr int kRawSlots = 3;                      // the int bytes arrive two steps ahead
constexpr uint32_t kGroup = 8 * 128;              // bytes between 8-row groups
// 1024 bytes of alignment slack, two stages of x and of the weight, the raw
// int ring, 2 barriers: two blocks fit an SM
constexpr size_t kWgSmem = 1024 + 4 * kTileBytes + kRawSlots * kRawBytes + 64;

// One step's int bytes of q into a raw slot: rows of 128 bytes (columns
// n0 .. n0+127 of 64 K rows, or of 32 packed int4 row pairs), zeros past K
// and N. `aligned` (N a multiple of 16, q 16-byte aligned): 16-byte
// cp.async, waited on later; otherwise byte loads and a 16-byte store.
template <int BITS>
__device__ __forceinline__ void fill_raw(uint8_t* raw, const uint8_t* __restrict__ q, int step,
                                         int n0, int depth, int cols, bool aligned, int tid) {
  constexpr int kRows = BITS == 8 ? kTileK : kTileK / 2;
  const int q_rows = BITS == 8 ? depth : depth / 2;
#pragma unroll
  for (int i = 0; i < kRows * 8 / kWgThreads; ++i) {
    const int chunk = tid + i * kWgThreads;
    const int r = chunk / 8, col = chunk % 8 * 16;
    const int row = step * kRows + r, n = n0 + col;
    uint8_t* dst = raw + r * 128 + col;
    if (aligned) {
      const bool in = row < q_rows && n < cols;
      hopper::cp_async_16(dst, in ? q + int64_t(row) * cols + n : q, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (row < q_rows) {
        const uint8_t* src = q + int64_t(row) * cols + n;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (n + j < cols) w[j / 4] |= uint32_t(__ldg(src + j)) << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// This thread's share of a weight tile: columns 4*nq .. +3 of the tile and
// its K rows 8*kc .. +7, as raw words from a raw slot (int8: one 4-column
// word per K row; int4: one per packed row pair).
template <int BITS>
struct WeightSlice {
  static constexpr int kWords = BITS == 8 ? 8 : 4;
  uint32_t word[kWords];

  __device__ __forceinline__ void load(const uint8_t* raw, int kc, int nq) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      word[i] = *reinterpret_cast<const uint32_t*>(raw + (kWords * kc + i) * 128 + 4 * nq);
  }

  // value of K row 8*kc + r, column 4*nq + j (sign-extended)
  __device__ __forceinline__ int value(int r, int j) const {
    if (BITS == 8) return int(int8_t((word[r] >> (8 * j)) & 0xFF));
    const uint32_t byte = (word[r / 2] >> (8 * j)) & 0xFF;
    const int nib = (r & 1) ? int(byte >> 4) : int(byte & 0xF);
    return (nib ^ 8) - 8;
  }
};

// the scales of this thread's 4 columns at its 8-deep K chunk of `step`
// (a chunk lies inside one group: group sizes are multiples of 8)
__device__ __forceinline__ void step_scales(float (&sc)[4], const float* __restrict__ scale,
                                            int step, int kc, int n_first, int depth, int cols,
                                            int group_size) {
  const int g = group_size == 0 ? 0 : min(step * kTileK + 8 * kc, depth - 1) / group_size;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sc[c] = n_first + c < cols ? scale[int64_t(g) * cols + n_first + c] : 0.f;
}

template <int BITS>
__global__ void __launch_bounds__(kWgThreads, 2)
dequant_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const uint8_t* __restrict__ q, const float* __restrict__ scale,
                            __nv_bfloat16* __restrict__ out, int rows, int depth, int cols,
                            int group_size, bool aligned) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint8_t* xs = smem;                          // [stage] 128 rows x 128 bytes, swizzled
  uint8_t* ws = smem + 2 * kTileBytes;         // [stage] 128 columns x 128 bytes, swizzled
  uint8_t* raw = smem + 4 * kTileBytes;        // [slot] the int bytes, plain rows
  uint64_t* x_bar = reinterpret_cast<uint64_t*>(raw + kRawSlots * kRawBytes);  // [stage]

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int steps = (depth + kTileK - 1) / kTileK;

  // the weight slice this thread dequantizes: 4 columns, one 8-deep K chunk
  const int nq = tid % 32;
  const int kc = tid / 32;
  const int n_first = n0 + 4 * nq;

  if (tid == 0) {
    hopper::mbar_init(&x_bar[0], 1);
    hopper::mbar_init(&x_bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&x_bar[0], kTileBytes);
    hopper::tma_load_2d(xs, &x_map, &x_bar[0], 0, m0);
  }
  // steps 0 and 1 of the int bytes in flight (the second group may be empty)
  fill_raw<BITS>(raw, q, 0, n0, depth, cols, aligned, tid);
  hopper::cp_async_commit();
  if (steps > 1) fill_raw<BITS>(raw + kRawBytes, q, 1, n0, depth, cols, aligned, tid);
  hopper::cp_async_commit();
  float sc[4];
  step_scales(sc, scale, 0, kc, n_first, depth, cols, group_size);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  hopper::cp_async_wait<1>();
  __syncthreads();  // step 0's int bytes are in their slot

  for (int j = 0; j < steps; ++j) {
    const int stage = j & 1;

    // dequantize step j into the weight tile of this stage: row n holds 64
    // K values (128 bytes) of column n0 + n; its 16-byte chunk kc sits at
    // chunk kc ^ (n % 8), the 128-byte swizzle wgmma and TMA share
    WeightSlice<BITS> slice;
    slice.load(raw + (j % kRawSlots) * kRawBytes, kc, nq);
    uint8_t* w_tile = ws + stage * kTileBytes;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t packed[4];
#pragma unroll
      for (int r = 0; r < 8; r += 2)
        packed[r / 2] = hopper::pack_bf16x2(float(slice.value(r, c)) * sc[c],
                                            float(slice.value(r + 1, c)) * sc[c]);
      const int n = 4 * nq + c;
      *reinterpret_cast<uint4*>(w_tile + n * 128 + ((kc ^ (n & 7)) * 16)) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    hopper::wgmma_wait<0>();      // step j-1's products are done (this warpgroup)
    hopper::fence_regs(acc);
    hopper::cp_async_wait<0>();   // step j+1's int bytes (this thread's copies) landed
    hopper::fence_proxy_async();
    __syncthreads();  // the weight tile is whole, step j+1's bytes are in place, and
                      // both warpgroups are past step j-1 (its x stage is free)
    if (tid == 0 && j + 1 < steps) {
      hopper::mbar_expect_tx(&x_bar[stage ^ 1], kTileBytes);
      hopper::tma_load_2d(xs + (stage ^ 1) * kTileBytes, &x_map, &x_bar[stage ^ 1],
                          (j + 1) * kTileK, m0);
    }
    if (j + 2 < steps) {
      fill_raw<BITS>(raw + ((j + 2) % kRawSlots) * kRawBytes, q, j + 2, n0, depth, cols,
                     aligned, tid);
      hopper::cp_async_commit();
    }
    if (group_size != 0 && j + 1 < steps)
      step_scales(sc, scale, j + 1, kc, n_first, depth, cols, group_size);
    hopper::mbar_wait(&x_bar[stage], (j >> 1) & 1);

    const uint8_t* x_tile = xs + stage * kTileBytes + wg * 64 * 128;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
      hopper::wgmma_ss_m64n128k16(
          acc, hopper::make_desc(x_tile + kk * 32, kGroup, hopper::kSwizzle128),
          hopper::make_desc(w_tile + kk * 32, kGroup, hopper::kSwizzle128), 1);
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // acc[4c + 2r + e] is (row warp*16 + lane/4 + 8r, column 8c + 2*(lane%4) + e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * r;
    if (m >= rows) continue;
    __nv_bfloat16* o_row = out + int64_t(m) * cols;
#pragma unroll
    for (int c = 0; c < kTileN / 8; ++c) {
      const int n = n0 + 8 * c + 2 * (lane % 4);
      const float lo = acc[4 * c + 2 * r], hi = acc[4 * c + 2 * r + 1];
      if (cols % 2 == 0 && n + 1 < cols) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + n) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (n < cols) o_row[n] = __float2bfloat16(lo);
        if (n + 1 < cols) o_row[n + 1] = __float2bfloat16(hi);
      }
    }
  }
}

template <int BITS>
cudaError_t launch_wgmma(const void* x, const void* q, const float* scale, void* out, int rows,
                         int depth, int cols, int group_size, cudaStream_t stream) {
  // x (M, K) contiguous: dims (K, M), boxes of 64 K x 128 rows
  const cuuint64_t dims[2] = {cuuint64_t(depth), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(depth) * 2};
  const cuuint32_t box[2] = {kTileK, kTileM};
  CUtensorMap x_map;
  if (!hopper::encode_bf16_map(&x_map, 2, x, dims, strides, box)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dequant_matmul_wgmma_kernel<BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(kWgSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((cols + kTileN - 1) / kTileN, (rows + kTileM - 1) / kTileM);
  dequant_matmul_wgmma_kernel<BITS><<<grid, kWgThreads, kWgSmem, stream>>>(
      x_map, static_cast<const uint8_t*>(q), scale, static_cast<__nv_bfloat16*>(out), rows,
      depth, cols, group_size, cols % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar design), 1 = bfloat16 (the wgmma design;
// x 16-byte aligned, K a multiple of 8, group_size a multiple of 8). bits: 8
// or 4. group_size: 0 for per-channel scales, else the rows per scale group
// (must divide K). All arrays are contiguous. Returns the cudaError_t of the
// launch (cudaErrorInvalidValue if x's tensor map cannot be encoded).
extern "C" int dequant_matmul(int dtype, int bits, int group_size, const void* x,
                              const void* q, const void* scale, void* out, int rows,
                              int depth, int cols, void* stream) {
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && bits == 8)
    return launch_scalar<8>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 0 && bits == 4)
    return launch_scalar<4>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 1 && bits == 8)
    return launch_wgmma<8>(x, q, s, out, rows, depth, cols, group_size, st);
  if (dtype == 1 && bits == 4)
    return launch_wgmma<4>(x, q, s, out, rows, depth, cols, group_size, st);
  return cudaErrorInvalidValue;
}
