"""Where a streamed tile's time goes in the bf16 D=1024 attention backward.

The card has no ``ncu``, so this tool reads the kernel's own clock: it
copies this package's ``csrc/`` to a scratch directory, inserts ``clock64``
stamps after fixed code lines of ``deep_bwd_quarters`` in
``attention_deep.cu`` (the phases of a streamed tile), builds the copy into
a library of its own (``build.py`` pointed at it) and launches dq and dk/dv
once each at ImageNet's encoder cross, (8, 512, 50176, 1, 1024) in bf16, no padding. Thread 0 of each
warpgroup of the first eight blocks of examples 0 and 5 (two clusters
each; at B=8 dq runs in two waves, example 5 in the second) writes the
stamps of its first 64 tiles; ``%globaltimer`` at the block's start and end
turns clock cycles into ns. One JSON line per kernel: for each warpgroup
(role 0: S, role 1: dP) the median over the sampled blocks of each phase's
median ns over the steady tiles (the first and last kept tile left out),
keyed by the phase's end, and the tile's ns; the block's start to its first
tile. The stamps cost a few percent (``wall_ms`` against the
unstamped kernel's events time). An edit of the kernel that moves one of
those lines (``ANCHORS``) makes the tool exit naming it.

``--probe`` first times the SM-to-SM network: every block of a full grid
of 2- and 4-block clusters stores 200 x 32 KB into a peer's shared memory
(``push1``: one peer, ``push3``: the three others in turn, ``pull1``:
loads from one peer, ``local``: its own), one JSON line each with the GB/s
of a block (per SM).

Run on the card from the repo root::

    python -m perceiver_io_torch.tools.deep_bwd_stamps [--probe]
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

NT, NP = 64, 13            # tiles kept, stamps a tile
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

START = ("  const int pit_slot_ = pit_slot();\n  const bool pit_on = pit_slot_ >= 0 && t == 0;\n"
         "  PIT_HEAD(kRole, 0);\n  PIT_GHEAD(kRole, 5);\n")
END = "  PIT_HEAD(kRole, 2);\n  PIT_GHEAD(kRole, 6);\n"


def _stamp(k):
    return f"    PIT_STAMP(kRole, j, {k});\n"


# (anchor, phase ending there): a stamp goes after the anchor's first
# occurrence in the body of deep_bwd_quarters
BODY = "__device__ __forceinline__ void deep_bwd_quarters("
ANCHORS = [
    ("  const OwnRows rows = own_rows<kDq>(c, row0, bias, m, l, delta);\n", None),
    ("  hopper::mbar_wait(c.own_bar, 0);\n", "own"),
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
     "end")]


def stamped_source(src: str) -> tuple:
    """``attention_deep.cu`` with the stamps; the tile phases' names in
    stamp order."""
    out = src.replace('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + HEADER, 1)
    start = out.index(BODY)
    phases, k = [], 0
    for anchor, phase in ANCHORS:
        at = out.find(anchor, start)
        if at < 0:
            raise SystemExit(f"deep_bwd_stamps: no {anchor.strip()!r} in deep_bwd_quarters: another design?")
        if phase is None:
            text = START
        elif phase == "own":
            text = "  PIT_HEAD(kRole, 1);\n"
        elif phase == "end":
            text = END
        else:
            text = _stamp(k)
            phases.append(phase)
            k += 1
        out = out[:at + len(anchor)] + text + out[at + len(anchor):]
    return out, phases


def summarise(raw: list, phases: list) -> dict:
    """Per warpgroup: the median over the sampled blocks of each phase's
    median ns over the steady tiles, the tile's ns, the block's start to
    its first tile and to its owned pair."""
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


def main(argv=None) -> None:
    import torch

    from perceiver_io_torch.ops import attention_kernel as ak
    from perceiver_io_torch.ops import build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--probe", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deep_bwd_stamps: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    scratch = Path(tempfile.mkdtemp(prefix="stamps_", dir=build.BUILD_DIR))
    try:
        if args.probe:
            network_probe(torch, build.nvcc_path(), scratch)
        csrc = scratch / "csrc"
        shutil.copytree(build.CSRC_DIR, csrc)
        deep = csrc / "attention_deep.cu"
        text, phases = stamped_source(deep.read_text())
        deep.write_text(text)
        build.CSRC_DIR, build.BUILD_DIR, build._library = csrc, scratch / "build", None
        lib = build.library()
        lib.pit_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]

        b, t, s, d = 8, 512, 50176, 1024
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, g = (torch.randn(b, t, 1, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        k, v = (torch.randn(b, s, 1, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        out, m, l = ak.attention_fwd_with_stats(q, k, v, None)
        bias, delta = ak.pad_bias(None, b, s, "cuda"), ak.bwd_delta(g, out)
        for part, fn in (("dq", lambda: ak.launch_bwd_dq(q, k, v, bias, m, l, delta, g)),
                         ("dkv", lambda: ak.launch_bwd_dkv(q, k, v, bias, m, l, delta, g))):
            fn()
            torch.cuda.synchronize()
            lib.pit_stamps_clear()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
            raw = (ctypes.c_uint64 * SLOTS)()
            if lib.pit_stamps_read(ctypes.addressof(raw), SLOTS) != 0:
                raise RuntimeError("deep_bwd_stamps: reading the stamps failed")
            print(json.dumps(dict(kernel=part, dims=[b, t, s, 1, d],
                                  wall_ms=round(wall, 3), phases=phases,
                                  ns=summarise(list(raw), phases))), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    main()
