"""Where a streamed tile's time goes in the bf16 D=1024 attention kernels.

The card has no ``ncu``, so this tool reads the kernels' own clocks: it
copies this package's ``csrc/`` to a scratch directory, inserts ``clock64``
stamps after fixed code lines of ``attention_deep.cu`` (the phases of a key
tile in the forward's ``fwd_tile``, of a streamed tile in the backward's
``deep_bwd_quarters``), builds the copy into a library of its own
(``build.py`` pointed at it) and launches the forward, dq and dk/dv once
each at ImageNet's encoder cross, (8, 512, 50176, 1, 1024) in bf16, no
padding. Thread 0 of each warpgroup of the first eight blocks of examples
0 and 5 (two clusters each; a launch that runs in two waves has example 5
in the second) writes the stamps of its first 64 tiles; ``%globaltimer``
at the block's start and end turns clock cycles into ns. One JSON line per
kernel: for each warpgroup (the forward's roles are its two 64-row
halves; the backward's role 0 computes S, role 1 dP) the median over the
sampled blocks of each phase's median ns over the steady tiles (the first
and last kept tile left out), keyed by the phase's END, and the tile's ns;
the block's start to its owned tiles (the forward's Q) and to its first
tile. The stamps cost a few percent (``wall_ms`` against the unstamped
kernel's events time). An edit of the kernel that moves one of those lines
(``FWD_ANCHORS``, ``BWD_ANCHORS``) makes the tool exit naming it.

The forward's phases (``fwd_tile`` at D=1024, tile j, one warpgroup):
``s_landed`` S_j has landed (PV_{j-1} may still run; its quarter's pad bias
loads issued); ``buffer_free`` the peers have read this block's last
fragments; ``pushed`` quarter q of the share sent to block q;
``next_issued`` S_{j+1} issued (its K stage awaited) and the loading warp's
K refill; ``quarters_in`` the peers' quarters have landed; ``summed`` this
block's quarter summed in rank order (and the peers told it is read);
``logits`` the quarter's logits and each row's max over them;
``gather_ok`` every block has read its quarters; ``maxima_in`` the rows'
maxima sent to and received from every block; ``p_formed`` m, alpha, the
quarter's p and this block's share of l; ``frags_sent`` k-step rank of P's
bf16 fragments sent to every block; ``frags_in`` the peers' fragments have
landed and are read; ``pv_landed`` PV_{j-1} has landed; ``pv_issued`` the
loading warp's V refill, V_j awaited, the output rescaled and PV_j
issued.

``--probe`` first reads how many four-block clusters of each D=1024
kernel the card holds at once (``cudaOccupancyMaxActiveClusters`` at its
launch's shared memory), then times the SM-to-SM network: every block of
a full grid of 2- and 4-block clusters stores 200 x 32 KB into a peer's
shared memory (``push1``: one peer, ``push3``: the three others in turn,
``pull1``: loads from one peer, ``local``: its own), one JSON line each
with the GB/s of a block (per SM).

Run on the card from the repo root::

    python -m perceiver_io_torch.tools.deep_stamps [--probe]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

NT, NP = 64, 20            # tiles kept, stamps a tile
ROLE_SLOTS = NT * NP + 8   # and a header of 8 a warpgroup
SLOTS = 1 << 16

HEADER = r"""
__device__ unsigned long long g_pit_stamps[@SLOTS@];
__device__ __forceinline__ unsigned long long pit_clock() {
  unsigned long long t; asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)); return t; }
__device__ __forceinline__ unsigned long long pit_gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
extern "C" int pit_stamps_read(void* dst, int n) {
  return cudaMemcpyFromSymbol(dst, g_pit_stamps, size_t(n) * 8); }
extern "C" int pit_stamps_clear() {
  void* p; cudaGetSymbolAddress(&p, g_pit_stamps); return cudaMemset(p, 0, @SLOTS@ * 8); }
__device__ __forceinline__ int pit_slot() {  // -1: not sampled
  if (blockIdx.y != 0 || blockIdx.x >= 8 || (blockIdx.z != 0 && blockIdx.z != 5)) return -1;
  return (blockIdx.z == 5) * 8 + blockIdx.x; }
#define PIT_AT(role, i) ((volatile unsigned long long*)g_pit_stamps)[64 + (pit_slot_ * 2 + (role)) * @RS@ + (i)]
#define PIT_STAMP(role, j, k) do { if (pit_on && (j) < @NT@) PIT_AT(role, (j) * @NP@ + (k)) = pit_clock(); } while (0)
#define PIT_HEAD(role, k) do { if (pit_on) PIT_AT(role, @HD@ + (k)) = pit_clock(); } while (0)
#define PIT_GHEAD(role, k) do { if (pit_on) PIT_AT(role, @HD@ + (k)) = pit_gtime(); } while (0)
"""
for key, val in (("@SLOTS@", SLOTS), ("@RS@", ROLE_SLOTS), ("@NT@", NT), ("@NP@", NP),
                 ("@HD@", NT * NP)):
    HEADER = HEADER.replace(key, str(val))

# how many clusters of each D=1024 launch the card holds at once (0: the
# forward, 1: dq, 2: dk/dv), at its grid for (8, 512, 50176, 1, 1024)
OCCUPANCY = r"""
template <typename Kernel>
static int pit_clusters(Kernel kernel, size_t smem, dim3 grid, int* n) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 4;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return int(cudaOccupancyMaxActiveClusters(n, kernel, &cfg));
}
extern "C" int pit_max_clusters(int which, int* n, long long* smem) {
  if (which == 0) {
    *smem = 1024 + FwdSmem<4>::kBytes;
    return pit_clusters(deep_fwd_wgmma_kernel<1024, false>, *smem, dim3(16, 1, 8), n);
  }
  *smem = kSlack + kBwdBytes;
  return which == 1 ? pit_clusters(deep_bwd_kernel<1024, false, true>, *smem, dim3(32, 1, 8), n)
                    : pit_clusters(deep_bwd_kernel<1024, false, false>, *smem,
                                   dim3(3136, 1, 8), n);
}
"""


def _vars(on: str) -> str:
    """The sampling state of a function's scope: this block's slot and
    whether this thread stamps."""
    return f"  const int pit_slot_ = pit_slot();\n  const bool pit_on = pit_slot_ >= 0 && {on};\n"


# the block's start (and the sampling state), its owned tiles in, its end;
# a per-tile function's sampling state and the tile's start
START, OWN, END, TILE = "start", "own", "end", "tile"


def _head(role: str, mark: str) -> str:
    return {START: f"  PIT_HEAD({role}, 0);\n  PIT_GHEAD({role}, 5);\n",
            OWN: f"  PIT_HEAD({role}, 1);\n",
            END: f"  PIT_HEAD({role}, 2);\n  PIT_GHEAD({role}, 6);\n"}[mark]


# (anchor, what goes after it): a tile phase's name (a stamp ending it, the
# first the tile's start: "top"), START / OWN / END (the block's), or TILE
# (a per-tile function's sampling state and "top"); each anchor is the first
# occurrence after the previous one, from the body's signature on
FWD_BODY = "__device__ __forceinline__ void fwd_tile("
FWD_ROLE, FWD_KERNEL_ROLE = "role", "int(threadIdx.x / 128)"
FWD_ANCHORS = [
    ("  const int role = tid / 128;  // the warpgroup: rows 64 role .. of the block\n", TILE),
    ("  warp_arrive(smem + L::kKEmpty + 8 * stage);\n", "s_landed"),
    ("    const uint32_t rank = uint32_t(fwd_rank<kC>());\n", "buffer_free"),
    ("                                    v);\n      }\n", "pushed"),
    ("    fill_k<kC>(c, smem, j + 2);\n  }\n", "next_issued"),
    ("    hopper::mbar_wait_cluster(smem + L::kSFull + 8 * role, j & 1);\n", "quarters_in"),
    ("          hopper::map_peer(smem + L::kGok + 8 * role, uint32_t(tid % 32)));\n", "summed"),
    ("      q_max[r] = fmaxf(q_max[r], __shfl_xor_sync(0xffffffffu, q_max[r], 2));\n    }\n",
     "logits"),
    ("    hopper::mbar_wait_cluster(smem + L::kGok + 8 * role, j & 1);\n", "gather_ok"),
    ("    hopper::mbar_wait_cluster(smem + L::kMFull + 8 * role, j & 1);\n", "maxima_in"),
    ("    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + row_sum[r];\n", "p_formed"),
    ("                                hopper::map_peer(smem + L::kFFull + 8 * role, peer), bits);\n"
     "    }\n", "frags_sent"),
    ("    hopper::mbar_wait_cluster(smem + L::kFFull + 8 * role, j & 1);\n", "frags_in"),
    ("  if (j > 0) warp_arrive(smem_pv + L::kVEmpty + 8 * other);\n", "pv_landed"),
    ("                                  L::kV + stage * kFwdTile));\n  hopper::wgmma_commit();\n",
     "pv_issued"),
    ("  c.scale = scale;\n", START),
    ("  hopper::mbar_wait(smem + L::kQBar, 0);\n", OWN),
    ("  deep_store<D, kFwdAtoms>(o, out, row0, t_len, heads, h, b, rank * kFwdAtoms, 1.f);\n",
     END)]
FWD_TILE_ON, FWD_KERNEL_ON = "kC == 4 && tid % 128 == 0", "D == 1024 && threadIdx.x % 128 == 0"

BWD_BODY = "__device__ __forceinline__ void deep_bwd_quarters("
BWD_ROLE = "kRole"
BWD_ANCHORS = [
    ("  const OwnRows rows = own_rows<kDq>(c, row0, bias, m, l, delta);\n", START),
    ("  hopper::mbar_wait(c.own_bar, 0);\n", OWN),
    ("  for (int j = 0; j < c.n_tiles; ++j) {\n    const int stage = j % kSt;\n", "top"),
    ("    hopper::wgmma_wait<0>();\n    hopper::fence_regs(x);\n", "share"),
    ("    if (j > 0) hopper::mbar_wait_cluster(c.sfree, (j - 1) & 1);\n", "buffers_free"),
    ("    if (loader && !kDq) refill_stage<kDq, kSt>(c, j, next, bias, m, l, delta);\n",
     "pushed"),
    ("    if (kDq && j + 1 < c.n_tiles) product(x, j + 1);\n", "dq_next_share_issued"),
    ("    hopper::mbar_wait_cluster(q_full, j & 1);\n", "quarters_in"),
    ("    hopper::named_sync(1, kBwdThreads);\n", "own_quarters"),
    ("                             pv, dsv);\n", "p_ds"),
    ("    hopper::named_sync(2, kBwdThreads);\n", "own_fragments"),
    ("    if (!kDq && j + 1 < c.n_tiles) product(x, j + 1);\n", "dkv_next_share_issued"),
    ("    hopper::mbar_wait_cluster(f_full, j & 1);\n", "fragments_in"),
    ("                               acc_atom0);\n    hopper::wgmma_commit();\n",
     "accumulation_issued"),
    ("    deep_wait_acc(acc);\n", "accumulated"),
    ("  deep_store<1024, kHeld>(acc, out, row0, own_len, c.heads, c.h, c.b, atom0, mul);\n",
     END)]


def insert_stamps(src: str, body: str, anchors: list, tile_role: str, tile_on: str,
                  block_role: str, block_on: str) -> tuple:
    """``src`` with the stamps of one kernel's anchors; the tile phases'
    names in stamp order."""
    at = src.index(body)
    phases = []
    for anchor, mark in anchors:
        found = src.find(anchor, at)
        if found < 0:
            raise SystemExit(f"deep_stamps: no {anchor.strip()!r} after {body.strip()!r}: "
                             "another design?")
        if mark == TILE:
            text = _vars(tile_on) + f"    PIT_STAMP({tile_role}, j, {len(phases)});\n"
            phases.append("top")
        elif mark in (START, OWN, END):
            text = (_vars(block_on) if mark == START else "") + _head(block_role, mark)
        else:
            text = f"    PIT_STAMP({tile_role}, j, {len(phases)});\n"
            phases.append(mark)
        at = found + len(anchor)
        src = src[:at] + text + src[at:]
    return src, phases


def stamped_source(src: str) -> tuple:
    """``attention_deep.cu`` with the stamps and the occupancy reading; the
    forward's and the backward's tile phases' names in stamp order."""
    out = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + HEADER, 1)
    out, fwd = insert_stamps(out, FWD_BODY, FWD_ANCHORS, FWD_ROLE, FWD_TILE_ON,
                             FWD_KERNEL_ROLE, FWD_KERNEL_ON)
    out, bwd = insert_stamps(out, BWD_BODY, BWD_ANCHORS, BWD_ROLE, "t == 0", BWD_ROLE, "t == 0")
    return out + OCCUPANCY, {"fwd": fwd, "bwd": bwd}


def summarise(raw: list, phases: list) -> dict:
    """Per warpgroup: the median over the sampled blocks of each phase's
    median ns over the steady tiles, the tile's ns, the block's start to
    its first tile and to its owned tiles."""
    per_role = {0: [], 1: []}
    for slot in range(16):
        for role in (0, 1):
            base = 64 + (slot * 2 + role) * ROLE_SLOTS
            tiles = [raw[base + j * NP: base + j * NP + len(phases)] for j in range(NT)]
            head = raw[base + NT * NP: base + NT * NP + 8]
            live = [j for j in range(NT) if all(tiles[j])]
            if len(live) < 4 or not (head[5] and head[6] and head[0] and head[2]):
                continue
            per_ns = (head[6] - head[5]) / (head[2] - head[0])  # ns a clock
            steady = live[1:-1]
            row = {"tile": statistics.median(
                tiles[b][0] - tiles[a][0] for a, b in zip(steady, steady[1:])) * per_ns}
            for k in range(1, len(phases)):
                row[phases[k]] = statistics.median(
                    tiles[j][k] - tiles[j][k - 1] for j in steady) * per_ns
            row["start_to_own"] = (head[1] - head[0]) * per_ns
            row["start_to_first_tile"] = (tiles[live[0]][0] - head[0]) * per_ns
            row["clock_ghz"] = 1 / per_ns
            per_role[role].append(row)
    return {f"role{role}": {key: round(statistics.median(r[key] for r in rows), 1)
                            for key in rows[0]}
            for role, rows in per_role.items() if rows}


PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t o; asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(o) : "r"(a), "r"(r));
  return o; }
__device__ __forceinline__ void csync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory"); }
// mode 0: st.shared::cluster to peer rank + 1; 1: to the others in turn;
// 2: ld.shared::cluster from rank + 1; 3: st.shared to this block
template <int C>
__global__ void probe(int iters, int mode, unsigned long long* out) {
  extern __shared__ float4 buf[];
  uint32_t rank; asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  uint32_t peers[3];
  for (int p = 0; p < 3; ++p) peers[p] = mapa(base, (rank + 1 + p) % C);
  for (int k = threadIdx.x; k < 2048; k += 256) buf[k] = make_float4(1, 2, 3, 4);
  csync();
  unsigned long long g0; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  float acc = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll 8
    for (int k = threadIdx.x; k < 2048; k += 256) {
      const float f = float(i);
      if (mode <= 1) {
        const uint32_t dst = (mode == 0 ? peers[0] : peers[(k / 256) % (C - 1)]) + 16 * k;
        asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "f"(f),
                     "f"(f), "f"(f), "f"(f) : "memory");
      } else if (mode == 2) {
        float4 v;
        asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(peers[0] + 16 * k)
                     : "memory");
        acc += v.x + v.w;
      } else {
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(base + 16 * k), "f"(f),
                     "f"(f), "f"(f), "f"(f) : "memory");
      }
    }
  }
  csync();
  unsigned long long g1; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  if (threadIdx.x == 0) out[blockIdx.x] = (g1 - g0) | (acc == 12345.f);
}
extern "C" int dsmem_probe(int cluster, int blocks, int iters, int mode, void* out) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks); cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 200 * 1024;  // one block an SM
  cfg.attrs = &attr; cfg.numAttrs = 1;
  auto kernel = cluster == 2 ? probe<2> : probe<4>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, iters, mode, (unsigned long long*)out);
  return e != cudaSuccess ? int(e) : int(cudaGetLastError());
}
"""


def network_probe(torch, nvcc: str, scratch: Path) -> None:
    src, lib_path = scratch / "dsmem_probe.cu", scratch / "libdsmem_probe.so"
    src.write_text(PROBE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.dsmem_probe.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    iters = 200
    for cluster in (2, 4):
        blocks = 132 // cluster * cluster
        for mode, name in enumerate(("push1", "push3", "pull1", "local")):
            out = torch.zeros(blocks, dtype=torch.int64, device="cuda")
            for _ in range(2):  # the second launch is the reading
                if lib.dsmem_probe(cluster, blocks, iters, mode, out.data_ptr()) != 0:
                    raise RuntimeError("dsmem_probe: launch failed")
                torch.cuda.synchronize()
            gbps = iters * 32768 / out.cpu().double()  # bytes a ns: GB/s a block
            print(json.dumps(dict(probe=name, cluster=cluster, blocks=blocks,
                                  gb_per_s_per_sm=round(float(gbps.median()), 2),
                                  gb_per_s_per_sm_min=round(float(gbps.min()), 2))), flush=True)


def occupancy_probe(lib) -> None:
    """One JSON line: the four-block clusters of each D=1024 kernel that the
    card holds at once, and the launch's shared memory a block."""
    lib.pit_max_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    reading = {}
    for which, name in enumerate(("fwd", "dq", "dkv")):
        n, smem = ctypes.c_int(0), ctypes.c_longlong(0)
        err = lib.pit_max_clusters(which, ctypes.byref(n), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"deep_stamps: cudaOccupancyMaxActiveClusters failed ({err})")
        reading[name] = dict(max_active_clusters=n.value, smem_bytes=smem.value)
    print(json.dumps(dict(probe="max_active_clusters", cluster=4, **reading)), flush=True)


def main(argv=None) -> None:
    import torch

    from perceiver_io_torch.ops import attention_kernel as ak
    from perceiver_io_torch.ops import build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probe", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deep_stamps: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="stamps_", dir=build.BUILD_DIR))
    try:
        csrc = scratch / "csrc"
        shutil.copytree(build.CSRC_DIR, csrc)
        deep = csrc / "attention_deep.cu"
        text, phases = stamped_source(deep.read_text())
        deep.write_text(text)
        build.CSRC_DIR, build.BUILD_DIR, build._library = csrc, scratch / "build", None
        lib = build.library()
        lib.pit_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if args.probe:
            occupancy_probe(lib)
            network_probe(torch, build.nvcc_path(), scratch)

        b, t, s, d = 8, 512, 50176, 1024
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, g = (torch.randn(b, t, 1, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, 1, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
        bias, delta = ak.pad_bias(None, b, s, "cuda"), ak.bwd_delta(g, out)
        for part, fn, names in (
                ("fwd", lambda: ak.attention_fwd_with_stats(q, k, v, None), phases["fwd"]),
                ("dq", lambda: ak.launch_bwd_dq(q, k, v, bias, m, l, delta, g), phases["bwd"]),
                ("dkv", lambda: ak.launch_bwd_dkv(q, k, v, bias, m, l, delta, g),
                 phases["bwd"])):
            fn()
            torch.cuda.synchronize()
            lib.pit_stamps_clear()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
            raw = (ctypes.c_uint64 * SLOTS)()
            if lib.pit_stamps_read(ctypes.addressof(raw), SLOTS) != 0:
                raise RuntimeError("deep_stamps: reading the stamps failed")
            print(json.dumps(dict(kernel=part, dims=[b, t, s, 1, d],
                                  wall_ms=round(wall, 3), phases=names,
                                  ns=summarise(list(raw), names))), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main()
