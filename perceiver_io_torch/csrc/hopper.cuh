// Hopper (sm_90a) building blocks shared by the tensor-core kernels of the
// port: mbarriers, TMA tensor loads and their tensor maps, wgmma matrix
// descriptors and the wgmma instructions of the kernels, in inline PTX.
//
// Shared-memory tiles are written by TMA (or, for a dequantized weight tile,
// by threads applying the same swizzle) and read by wgmma through a matrix
// descriptor of the same swizzle mode: rows of 32, 64 or 128 bytes, eight
// rows to a swizzle atom (256, 512 or 1024 bytes), every tile based on a
// 1024-byte boundary. A K-major operand (the reduction dim contiguous) steps
// through K by moving the descriptor's start address 32 bytes along the row;
// an MN-major one (a transposed B) by moving it 16 rows down. Each
// instruction here reads one swizzle atom across, so the leading byte offset
// (the stride between atoms across a row) is never used; the stride byte
// offset is the stride between 8-row groups.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// descriptor layout codes (bits 62-63) and the matching TMA swizzle modes
constexpr uint32_t kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3;

__host__ __device__ constexpr uint32_t layout_for_row_bytes(int row_bytes) {
  return row_bytes == 128 ? kSwizzle128 : row_bytes == 64 ? kSwizzle64 : kSwizzle32;
}

inline CUtensorMapSwizzle tma_swizzle_for_row_bytes(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after the dynamic shared memory base
__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Barriers and tiles are named by pointer or by their 32-bit shared-memory
// address (smem_u32): a kernel that forms its addresses from one base at
// each use, instead of holding pointers across a loop, takes the latter.

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}

// one arrival, releasing this thread's earlier shared-memory reads and writes
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }

// the named barrier `id` (1-15; 0 is __syncthreads'): returns once
// `threads` threads (whole warps) have reached it
__device__ __forceinline__ void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// returns once the barrier has completed the phase of the given parity; a
// phase that never completes (a lost TMA transaction) traps after ~2^34
// clocks, so it surfaces as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// ---- thread block clusters ----

// the block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// every thread of every block of the cluster arrives and waits; shared
// memory written before it is visible to the cluster's blocks after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// two floats at the same shared-memory offset of block `rank` of the cluster
__device__ __forceinline__ float2 load_peer_f32x2(const float* local, uint32_t rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(smem_u32(local)),
               "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(peer)
               : "memory");
  return v;
}

// the address of the same shared-memory offset in block `rank` of the
// cluster, in the cluster's shared window
__device__ __forceinline__ uint32_t map_peer(uint32_t addr, uint32_t rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(peer) : "r"(addr), "r"(rank));
  return peer;
}

// four floats to `addr` of the cluster's shared window (map_peer),
// asynchronously: their 16 bytes complete a transaction on the barrier at
// `bar`, an address of the same block (armed there by an mbar_expect_tx)
__device__ __forceinline__ void store_async_f32x4(uint32_t addr, uint32_t bar, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// four floats to the same shared-memory offset of block `rank` of the
// cluster, asynchronously: their 16 bytes complete a transaction on the
// barrier at `bar`'s offset there (armed by an mbar_expect_tx)
__device__ __forceinline__ void store_async_peer_f32x4(float4* local, uint64_t* bar, uint32_t rank,
                                                       float4 v) {
  store_async_f32x4(map_peer(smem_u32(local), rank), map_peer(smem_u32(bar), rank), v);
}

// four 32-bit words to the same shared-memory offset of block `rank` of the
// cluster, as store_async_peer_f32x4 stores four floats
__device__ __forceinline__ void store_async_peer_u32x4(uint4* local, uint64_t* bar, uint32_t rank,
                                                       uint4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(map_peer(smem_u32(local), rank)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(map_peer(smem_u32(bar), rank))
      : "memory");
}

// one arrival on the barrier at `bar` of the cluster's shared window
// (map_peer), ordering nothing: a signal that this thread's reads, whose
// values it has used, are done
__device__ __forceinline__ void mbar_arrive_cluster_relaxed(uint32_t bar) {
  asm volatile("mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival on the barrier at the same offset in block `rank` of the
// cluster, ordering nothing (for a signal that this thread's reads, whose
// values it has used, are done)
__device__ __forceinline__ void mbar_arrive_peer_relaxed(uint64_t* bar, uint32_t rank) {
  mbar_arrive_cluster_relaxed(map_peer(smem_u32(bar), rank));
}

// 2^x, flushing results below 2^-126 to 0 (ex2.approx.ftz)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// mbar_wait that acquires at cluster scope: what landed by st.async from,
// or was released by, another block of the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  mbar_wait_cluster(smem_u32(bar), parity);
}

// ---- shared memory by address ----

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f32x4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ---- TMA ----

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  tma_load_4d(smem_u32(dst), map, smem_u32(bar), c0, c1, c2, c3);
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// ---- cp.async ----

// 16 bytes global -> shared, asynchronously; with src_bytes 0 nothing is
// read and the 16 bytes land as zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// returns once at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy shared-memory writes made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled looked up through the CUDA runtime's entry-point
// query, so the library needs no link against libcuda; null where missing
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1), boxes of `box`, swizzled for rows of box[0] * 2 bytes.
// Elements outside the tensor land as zeros. False if the encoding is refused.
inline bool encode_bf16_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                tma_swizzle_for_row_bytes(int(box[0]) * 2), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D map over a (B, rows, H, head_dim) bf16 view with the given element
// strides (batch, row, head): boxes of (box_cols columns, one head, box_rows
// rows, one batch). Columns past head_dim and rows past `rows` land as zeros.
inline bool encode_head_map(CUtensorMap* map, const void* base, int batch, int rows, int heads,
                            int head_dim, const int64_t* strides, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {cuuint64_t(head_dim), cuuint64_t(heads), cuuint64_t(rows),
                              cuuint64_t(batch)};
  const cuuint64_t bytes[3] = {cuuint64_t(strides[2]) * 2, cuuint64_t(strides[1]) * 2,
                               cuuint64_t(strides[0]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(box_cols), 1, cuuint32_t(box_rows), 1};
  return encode_bf16_map(map, 4, base, dims, bytes, box);
}

// A 5-D map over the same view whose box is a whole tile of `atoms`
// 64-column swizzle atoms side by side: dims (64 columns, rows, atoms,
// heads, batch), boxes of (64, box_rows, atoms, one head, one batch), which
// land as `atoms` consecutive [box_rows][64] atoms, each as a 4-D box of one
// atom would: one TMA instruction where encode_head_map takes `atoms`
inline bool encode_atom_tile_map(CUtensorMap* map, const void* base, int batch, int rows,
                                 int heads, int head_dim, const int64_t* strides, int box_rows,
                                 int atoms) {
  const cuuint64_t dims[5] = {64, cuuint64_t(rows), cuuint64_t(head_dim / 64), cuuint64_t(heads),
                              cuuint64_t(batch)};
  const cuuint64_t bytes[4] = {cuuint64_t(strides[1]) * 2, 128, cuuint64_t(strides[2]) * 2,
                               cuuint64_t(strides[0]) * 2};
  const cuuint32_t box[5] = {64, cuuint32_t(box_rows), cuuint32_t(atoms), 1, 1};
  return encode_bf16_map(map, 5, base, dims, bytes, box);
}

// A 1-D map over `n` contiguous f32 values (16-byte aligned), boxes of
// `box` values (a multiple of 4). Values past `n` land as zeros; a box's
// first value must lie on a 16-byte boundary.
inline bool encode_f32_vector_map(CUtensorMap* map, const void* base, uint64_t n, uint32_t box) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {cuuint64_t(n)};
  const cuuint64_t strides[1] = {cuuint64_t((n * 4 + 15) / 16 * 16)};  // a rank-1 map reads none
  const cuuint32_t boxes[1] = {box};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims, strides,
                boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// ---- wgmma ----

// A shared-memory matrix descriptor: start address, stride between 8-row
// groups, swizzle layout. The leading byte offset field carries the same
// stride: no instruction here spans two swizzle atoms across a row, where
// that field would be read, so it costs nothing and holds for either
// reading of the field in an MN-major operand.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t group_stride_bytes,
                                              uint32_t layout) {
  const uint64_t addr = smem_addr;
  const uint64_t stride = (group_stride_bytes >> 4) & 0x3FFF;
  return ((addr & 0x3FFFF) >> 4) | (stride << 16) | (stride << 32) | (uint64_t(layout) << 62);
}
__device__ __forceinline__ uint64_t make_desc(const void* smem_ptr, uint32_t group_stride_bytes,
                                              uint32_t layout) {
  return make_desc(smem_u32(smem_ptr), group_stride_bytes, layout);
}

// the descriptor of make_desc(addr + bytes, ...) from make_desc(addr, ...):
// the start address field (addr / 16, 14 bits) takes no carry while the
// address stays inside the 228 KB of shared memory
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving uses of accumulator registers across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for A fragments held in registers: their packing is done here,
// not sunk past a later wgmma.fence to the instruction that reads them
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64 x n128, f32) {=, +=} A (m64 x k16) . B (k16 x n128), both read from shared
// memory through K-major descriptors; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64 x n64, f32) {=, +=} A (m64 x k16) . B (k16 x n64), both read from shared
// memory through K-major descriptors; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64 x n32, f32) {=, +=} A (m64 x k16) . B (k16 x n32), both read from shared
// memory through K-major descriptors; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (m64 x n16, f32) {=, +=} A (m64 x k16) . B (k16 x n16), both read from shared
// memory through K-major descriptors; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the SS product of an m64 tile whose accumulator holds N floats a thread
// (n = 2N columns: 16, 32 or 64), both operands K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  wgmma_ss_m64n16k16(d, desc_a, desc_b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  wgmma_ss_m64n32k16(d, desc_a, desc_b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  wgmma_ss_m64n64k16(d, desc_a, desc_b, accumulate);
}

// D (m64 x n16, f32) += A (m64 x k16, bf16 in registers) . B (k16 x n16) read from
// shared memory through an MN-major descriptor (B transposed).
__device__ __forceinline__ void wgmma_rs_m64n16k16_tb(float (&d)[8], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n32, f32) += A (m64 x k16, bf16 in registers) . B (k16 x n32) read from
// shared memory through an MN-major descriptor (B transposed).
__device__ __forceinline__ void wgmma_rs_m64n32k16_tb(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (m64 x n64, f32) += A (m64 x k16, bf16 in registers) . B (k16 x n64) read from
// shared memory through an MN-major descriptor (B transposed).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (+)= A . B with A from registers (the fragments of a 64 x 16 tile) and
// B K-major in shared memory, as wgmma_ss takes it; d is overwritten when
// `accumulate` is false
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(int(accumulate)));
}

// the RS product of an m64 tile whose accumulator holds N floats a thread
// (n = 2N columns: 16, 32 or 64), B MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N], const uint32_t (&a)[4], uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_rs_tb<8>(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  wgmma_rs_m64n16k16_tb(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  wgmma_rs_m64n32k16_tb(d, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  wgmma_rs_m64n64k16_tb(d, a, desc_b);
}

}  // namespace hopper
