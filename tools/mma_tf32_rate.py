#!/usr/bin/env python3
"""The card's ``mma.sync`` TF32 rate: the ceiling under B5's prefill_tc.

Builds a kernel that does nothing but ``mma.sync.aligned.m16n8k8`` TF32
products into ``acc`` independent accumulators a warp, runs it on GPU 0
at a few occupancies and prints one JSON line per configuration (TFLOP/s
and SM cycles per MMA at the card's maximum SM clock), then the card's
name and power limit.  The first configuration is prefill_tc's QKᵀ loop:
8 accumulators a warp, two blocks of 4 warps an SM.  Run from the root
of a checkout on a machine with a GPU and ``nvcc``::

    python3 tools/mma_tf32_rate.py
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
template <int ACC>
__global__ void mma_loop(float* out, int iters) {
  float c[ACC][4] = {};
  uint32_t a[4], b0 = __float_as_uint(1.0f), b1 = __float_as_uint(0.5f);
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < ACC; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int n = 0; n < ACC; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop(float* out, int acc, int blocks, int threads,
                        int iters) {
  if (acc == 8) mma_loop<8><<<blocks, threads>>>(out, iters);
  else mma_loop<16><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

#: (accumulators a warp, blocks an SM, threads a block)
CONFIGS = ((8, 2, 128), (16, 2, 128), (8, 4, 128), (16, 4, 128))
SMS = 132
ITERS = 2000


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_rate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "mma.cu", Path(tmp) / "mma.so"
        src.write_text(SOURCE)
        subprocess.run([cuda_lib._nvcc(), *cuda_lib.CFLAGS, "-shared", "-o",
                        str(lib_path), str(src)], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.mma_loop.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
        clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
        out = torch.empty(SMS * 4 * 128, device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for acc, per_sm, threads in CONFIGS:
            blocks = SMS * per_sm
            cuda_lib.check(lib.mma_loop(out.data_ptr(), acc, blocks, threads,
                                        10), "mma_loop")
            torch.cuda.synchronize()
            start.record()
            lib.mma_loop(out.data_ptr(), acc, blocks, threads, ITERS)
            end.record()
            end.synchronize()
            s = start.elapsed_time(end) * 1e-3
            mmas = blocks * threads // 32 * ITERS * acc
            print(json.dumps({
                "accumulators_per_warp": acc, "blocks_per_sm": per_sm,
                "warps_per_sm": per_sm * threads // 32,
                "tflops_tf32": mmas * 2 * 16 * 8 * 8 / s / 1e12,
                "sm_cycles_per_mma": s * clock_hz * SMS / mmas}),
                flush=True)
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
