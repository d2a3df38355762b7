#!/usr/bin/env python3
"""The card's row-gather rate from L2 and from HBM: the floor under B1.

B1's ``lanes_f32`` path gathers one slab row of x per edge (64 lanes of
f32: 256 B at the main path's shape) and ``words_bool`` one row of
packed words (8 words: 32 B).  This builds a kernel that does nothing
but such gathers — each warp sums rows of a table at random row indices
with 16-byte loads, 16 indices in flight a warp — and runs it on GPU 0
for tables from 10 MB (L2-resident) to 166 MB (HBM), printing one JSON
line per configuration (gathered GB/s, and the time 1.83 GB of gathers
would take: x (81,306 × 256) f32 over 1,788,490 edges), then the card's
name and power limit.  Run from the root of a checkout on a machine
with a GPU and ``nvcc``::

    python3 tools/l2_gather_rate.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// warp w sums rows idx[w * per_warp ...] of `table` (rows of row_vec
// float4); lanes span the row, lane groups take further rows
__global__ void __launch_bounds__(256) gather_rows(
    const float4* __restrict__ table, const int* __restrict__ idx,
    float* __restrict__ out, int row_vec, int per_warp, int n_warps) {
  const int warp = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31, groups = 32 / row_vec;
  const int g = lane / row_vec, c = lane % row_vec;
  const int* rows = idx + (long long)warp * per_warp;
  float acc = 0.0f;
  for (int i = g; i < per_warp; i += groups * 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = i + u * groups;
      v[u] = k < per_warp ? __ldg(table + (long long)__ldcs(rows + k) *
                                              row_vec + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  out[(long long)warp * 32 + lane] = acc;
}
extern "C" int gather_rows(const void* table, const void* idx, void* out,
                           int row_vec, int per_warp, int n_warps) {
  gather_rows<<<(n_warps + 7) / 8, 256>>>(
      static_cast<const float4*>(table), static_cast<const int*>(idx),
      static_cast<float*>(out), row_vec, per_warp, n_warps);
  return (int)cudaGetLastError();
}
"""

N_ROWS = 81_306
#: (row bytes, table rows): B1's f32 slab rows (256 B) over tables of
#: 10.4, 20.8 (the main path's 64-lane slab), 41.6, 83.3 and 166.5 MB,
#: and its packed 𝔹 rows (32 B) over x's 2.6 MB of words
CONFIGS = ((256, N_ROWS // 2), (256, N_ROWS), (256, 2 * N_ROWS),
           (256, 4 * N_ROWS), (256, 8 * N_ROWS), (32, N_ROWS))
GATHERS = 1 << 24      # rows gathered a run
PER_WARP = 64
B1_F32_GATHER_BYTES = 1_788_490 * 256 * 4


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("l2_gather_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "gather.cu", Path(tmp) / "gather.so"
        src.write_text(SOURCE)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.CFLAGS, "-shared", "-o",
                        str(lib_path), str(src)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.gather_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        gen = torch.Generator(device="cuda").manual_seed(0)
        n_warps = GATHERS // PER_WARP
        out = torch.empty(n_warps * 32, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for row_bytes, rows in CONFIGS:
            table = torch.rand((rows, row_bytes // 4), generator=gen,
                               device="cuda")
            idx = torch.randint(0, rows, (GATHERS,), generator=gen,
                                device="cuda", dtype=torch.int32)
            row_vec = row_bytes // 16

            def run():
                cuda_lib.check(lib.gather_rows(
                    table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    row_vec, PER_WARP, n_warps), "gather_rows")
            run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                run()
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) * 1e-3 / 10
            rate = GATHERS * row_bytes / s
            print(json.dumps({
                "row_bytes": row_bytes, "table_mb": rows * row_bytes / 1e6,
                "gathers": GATHERS, "gather_gb_per_s": rate / 1e9,
                "b1_f32_gathers_ms": B1_F32_GATHER_BYTES / rate * 1e3}),
                flush=True)
            del table, idx
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
