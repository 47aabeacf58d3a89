// The tile machinery of the port's bf16 attention kernels that stream one
// side of the attention past a block's owned rows: the dq and dk/dv kernels
// of attention_bwd.cu (#2, #3) and the three kernels of
// packed_attention.cu (#4, #5).
//
// A block owns 128 rows (two consumer warpgroups of 64) of one side, staged
// once by TMA, and streams 64-row tiles of the other side through a
// two-stage TMA ring (mbarriers), in swizzled layouts: rows of 32, 64 or
// 128 bytes, D=128 as two 64-column atoms, D=8 zero-padded to 16 by TMA's
// out-of-bounds fill. Tiles are read through 4-D (B, rows, H, D) tensor
// maps (hopper::encode_head_map), so a head's columns end at D whatever
// follows them in memory. Products are wgmma with f32 accumulators in
// registers: x = A.B^T of an owned and a streamed tile (SS, both K-major),
// then acc += X.B with X rounded to bf16 in registers as the A operand and
// the streamed tile as an MN-major B.

#pragma once

#include "hopper.cuh"

#include <stdint.h>

namespace attn_tiles {

constexpr int kWgRows = 64;               // rows of one consumer warpgroup
constexpr int kOwnRows = 2 * kWgRows;     // rows a block owns
constexpr int kStreamRows = 64;           // rows of a streamed tile
constexpr int kStages = 2;                // ring depth of the streamed tiles
constexpr int kWgThreads = 256;           // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadded = -0.5e30f;       // a bias or max at or below: the mask value

template <int D>
struct Geometry {
  static constexpr int kDp = D < 16 ? 16 : D;             // head dim in shared memory
  static constexpr int kAtomCols = kDp > 64 ? 64 : kDp;   // columns of one swizzle atom / TMA box
  static constexpr int kAtoms = kDp / kAtomCols;           // 2 at D = 128, else 1
  static constexpr int kRowBytes = kAtomCols * 2;          // 32, 64 or 128
  static constexpr uint32_t kLayout = hopper::layout_for_row_bytes(kRowBytes);
  static constexpr uint32_t kGroup = 8 * kRowBytes;        // bytes between 8-row groups
  static constexpr int kOwnAtom = kOwnRows * kRowBytes;
  static constexpr int kStreamAtom = kStreamRows * kRowBytes;
  static constexpr int kOwnBytes = kAtoms * kOwnAtom;      // one owned tile
  static constexpr int kStreamBytes = kAtoms * kStreamAtom;  // one streamed tile
  static constexpr int kRegs = kAtomCols / 2;              // accumulator floats per atom
  // 1024 bytes of alignment slack, two owned tiles, two rings of streamed
  // tiles, the ring's barriers and the owned tiles' one
  static constexpr size_t kSmem = 1024 + 2 * kOwnBytes + 2 * kStages * kStreamBytes +
                                  8 * (kStages + 1);
};

// one thread: the block's owned tiles of a and, unless map_b is null, b
// (rows r0..) into shared memory
template <int D>
__device__ __forceinline__ void load_own(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                         uint8_t* own_a, uint8_t* own_b, uint64_t* bar, int r0,
                                         int h, int b) {
  using G = Geometry<D>;
  hopper::mbar_expect_tx(bar, (map_b ? 2 : 1) * G::kOwnBytes);
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a) {
    hopper::tma_load_4d(own_a + a * G::kOwnAtom, map_a, bar, a * G::kAtomCols, h, r0, b);
    if (map_b)
      hopper::tma_load_4d(own_b + a * G::kOwnAtom, map_b, bar, a * G::kAtomCols, h, r0, b);
  }
}

// one thread: streamed tile `tile` of a and, unless map_b is null, b into
// ring stage `stage`
template <int D>
__device__ __forceinline__ void load_stream(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                            uint8_t* ring_a, uint8_t* ring_b, uint64_t* bars,
                                            int tile, int stage, int h, int b) {
  using G = Geometry<D>;
  hopper::mbar_expect_tx(&bars[stage], (map_b ? 2 : 1) * G::kStreamBytes);
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a) {
    hopper::tma_load_4d(ring_a + stage * G::kStreamBytes + a * G::kStreamAtom, map_a,
                        &bars[stage], a * G::kAtomCols, h, tile * kStreamRows, b);
    if (map_b)
      hopper::tma_load_4d(ring_b + stage * G::kStreamBytes + a * G::kStreamAtom, map_b,
                          &bars[stage], a * G::kAtomCols, h, tile * kStreamRows, b);
  }
}

// The streamed key tiles of example `bias_b` that hold a key that is not
// padding, listed in live[0..count) (live has n_tiles + 1 ints; live[n_tiles]
// gets the count); with `all_if_none`, every tile where none does (a fully
// masked example). All threads of the block call it; it synchronises them.
__device__ __forceinline__ int list_live_tiles(const float* bias_b, int s_len, int n_tiles,
                                               int* live, bool all_if_none) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n_tiles; i += kWgThreads / 32) {  // one warp a tile
    const int k0 = i * kStreamRows + lane, k1 = k0 + 32;
    const bool valid = (k0 < s_len && bias_b[k0] > kPadded) ||
                       (k1 < s_len && bias_b[k1] > kPadded);
    const bool any = __any_sync(0xffffffffu, valid);
    if (lane == 0) live[i] = any;
  }
  __syncthreads();
  if (warp == 0) {  // the flags compacted in place into the list of live tiles
    int count = 0;
    for (int base = 0; base < n_tiles; base += 32) {
      const bool flag = base + lane < n_tiles && live[base + lane];
      const uint32_t ballot = __ballot_sync(0xffffffffu, flag);
      if (flag) live[count + __popc(ballot & ((1u << lane) - 1))] = base + lane;
      count += __popc(ballot);
    }
    if (count == 0 && all_if_none) {
      for (int i = lane; i < n_tiles; i += 32) live[i] = i;
      count = n_tiles;
    }
    if (lane == 0) live[n_tiles] = count;
  }
  __syncthreads();
  return live[n_tiles];
}

// x = A . B^T over the padded head dim (started, not awaited): A the
// warpgroup's 64 rows of an owned tile, B a streamed tile, both K-major;
// x[4c + 2r + e] is (row r, column 8c + col_in_chunk + e) of the 64 x 64 tile
template <int D>
__device__ __forceinline__ void tile_product(float (&x)[32], const uint8_t* own, int wg,
                                             const uint8_t* stream) {
  using G = Geometry<D>;
#pragma unroll
  for (int kk = 0; kk < G::kDp / 16; ++kk) {
    const int atom = (16 * kk) / G::kAtomCols;
    const int in_row = (16 * kk) % G::kAtomCols * 2;
    const uint64_t da = hopper::make_desc(
        own + atom * G::kOwnAtom + wg * kWgRows * G::kRowBytes + in_row, G::kGroup, G::kLayout);
    const uint64_t db =
        hopper::make_desc(stream + atom * G::kStreamAtom + in_row, G::kGroup, G::kLayout);
    hopper::wgmma_ss_m64n64k16(x, da, db, kk > 0);
  }
}

// a 64 x 64 f32 tile in the accumulator layout, rounded to bf16 as the A
// fragments of its four 16-column steps
__device__ __forceinline__ void to_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = hopper::pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = hopper::pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = hopper::pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = hopper::pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc += A . B (started, not awaited): A the fragments of a 64 x 64 tile whose
// columns are the streamed rows, B the streamed tile (MN-major: D contiguous)
template <int D>
__device__ __forceinline__ void accumulate(
    float (&acc)[Geometry<D>::kAtoms][Geometry<D>::kRegs], const uint32_t (&a)[4][4],
    const uint8_t* stream) {
  using G = Geometry<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int atom = 0; atom < G::kAtoms; ++atom)
      hopper::wgmma_rs_tb<G::kRegs>(
          acc[atom], a[kk],
          hopper::make_desc(stream + atom * G::kStreamAtom + kk * 16 * G::kRowBytes, G::kGroup,
                            G::kLayout));
}

template <int D>
__device__ __forceinline__ void wait_acc(float (&acc)[Geometry<D>::kAtoms][Geometry<D>::kRegs]) {
#pragma unroll
  for (int a = 0; a < Geometry<D>::kAtoms; ++a) hopper::fence_regs(acc[a]);
}

// rows r of this thread's accumulator (eight apart) of (B, n, H, D) `out`,
// times `mul`, in bf16; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_rows(
    const float (&acc)[Geometry<D>::kAtoms][Geometry<D>::kRegs], __nv_bfloat16* out,
    int row0, int n, int heads, int h, int b, float mul) {
  using G = Geometry<D>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* o_row = out + ((int64_t(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int a = 0; a < G::kAtoms; ++a) {
#pragma unroll
      for (int c = 0; c < G::kAtomCols / 8; ++c) {
        const int col = a * G::kAtomCols + 8 * c + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(
              acc[a][4 * c + 2 * r] * mul, acc[a][4 * c + 2 * r + 1] * mul);
      }
    }
  }
}

// a block's most dynamic shared memory on the H100
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace attn_tiles
