"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``:
pointers and the CUDA stream pass as ``c_void_p``, sizes as ``c_int`` /
``c_longlong``, and every entry point returns ``cudaGetLastError()``.
The first call in a process builds ``build/repro_torch/
librepro_torch_<hash>.so`` at the root of the checkout — one ``nvcc``
per source, all started together, then one link — unless a library for
the current sources' hash is already there.  Nothing is built or
loaded at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("coo_segment.cu", "coo_spmm.cu", "semiring_matmul.cu",
           "ssm_scan.cu", "flash_attention.cu", "flash_attention_bwd.cu")
#: headers the sources include (hashed with them)
HEADERS = ("attention_mask.cuh", "tf32_mma.cuh", "wide_simt.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C entry points: name → argtypes (restype is int: a cudaError_t)
SIGNATURES = {
    # mode, vals, ids, out, m, lanes, n, stream
    "coo_segment_reduce": (_I, _P, _P, _P, _L, _I, _I, _P),
    # mode, kernel, elem_bytes, vals, item_edge, item_dst, slot_fold,
    # fold_row, fold_seg, tickets, out, part, m, n, row_len, vec, tpe,
    # chunk, n_items, item_first, item_last, max_item_edges, n_split,
    # n_part, part_elems, n_tickets, grid_x, grid_y, stream
    "coo_segment_runs": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _L, _L, _I, _I, _P),
    # mode, src, w, item_edge, item_dst, fold_row, fold_seg, x, out, part,
    # nnz, n_out, lanes, row_len, vec, threads_per_edge, chunk, n_items,
    # item_first, item_last, max_item_edges, n_split, n_part, part_elems,
    # grid_x, grid_y, stream
    "coo_spmm_items": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I,
                       _P),
    # x (bool bytes), words, rows, lanes, row_words, stream
    "coo_spmm_pack": (_P, _P, _I, _I, _I, _P),
    # words, out (bool bytes), rows, lanes, row_words, stream
    "coo_spmm_unpack": (_P, _P, _I, _I, _I, _P),
    # a, b, bt, c, m, n, k, transpose, tile_m, tile_n, grid_x, grid_y,
    # stream
    "semiring_matmul_tc_bool": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _I, _P),
    # mode, a, b, c, m, n, k, tile_m, tile_n, grid_x, grid_y, stream
    "semiring_matmul_tile_f32": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _P),
    # mode, a, b, part, c, m, n, k, k_per_split, splits, width, stream
    "semiring_matmul_stream": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P),
    # a, b, h, bsz, t, d, stream
    "ssm_scan": (_P, _P, _P, _I, _I, _I, _P),
    # B4's time tile (rows) and thread groups a channel
    "ssm_scan_tile": (),
    "ssm_scan_groups": (),
    # q, k, v, o, lse (or null), bsz, tq, tk, hq, hkv, d, k strides
    # (b, t, h), v strides (b, t, h), causal, window, chunk, q_offset,
    # scale, q_tile, grid_x, grid_y, grid_z, stream
    "flash_attention_prefill": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _F,
                                _I, _I, _I, _I, _P),
    # q, k, v, o, lse (or null), part, then as prefill up to scale; rows,
    # splits, keys_per_split, grid_x, grid_y, grid_z, scratch floats,
    # stream
    "flash_attention_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                               _F, _I, _I, _I, _I, _I, _I, _L, _P),
    # as prefill: q, k, v, o, lse (or null), … scale, q_tile, grid_x,
    # grid_y, grid_z, stream
    "flash_attention_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _F,
                             _I, _I, _I, _I, _P),
    # B5's backward: o, dout, delta, bsz, tq, hq, d, stream
    "flash_attention_bwd_rowdot": (_P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, dout, lse, delta, dk, dv, bsz, tq, tk, hq, hkv, d, causal,
    # window, chunk, q_offset, scale, stream
    "flash_attention_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, dout, lse, delta, dq, then as dkdv from bsz
    "flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _F, _P),
    # the wide_simt route (128 < d ≤ 256): as dkdv and dq
    "flash_attention_bwd_dkdv_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                      _P),
    "flash_attention_bwd_dq_wide": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # the wide_chunk route (d > 256): as the wide_simt entries
    "flash_attention_wide_chunk": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _L, _L, _L, _L, _L, _L, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _I, _P),
    "flash_attention_bwd_dkdv_chunk": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _F, _P),
    "flash_attention_bwd_dq_chunk": (_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                     _P),
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from src/repro_torch/csrc on first use")
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{source_hash()}.so"


def build() -> Path:
    """Compile every source in parallel and link one shared library;
    the compiler's output (``-Xptxas -v``: registers, spills) lands in
    ``build.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, p in procs:
            text, _ = p.communicate()
            log.append(f"== {name} (rc {p.returncode})\n{text}")
            if p.returncode:
                failed.append(name)
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" +
                               "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {out.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, out)  # atomic: concurrent builders agree
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


#: the half types the float kernels (B4, B5) take besides f32: their
#: wrappers cast them to f32 at the entry and the outputs back, as the
#: reference's Pallas kernels keep f32 carries and accumulators and store
#: in the input's dtype
HALF_TYPES = (torch.bfloat16, torch.float16)


def f32_entry(name: str, *ts: torch.Tensor):
    """``(tensors, back)``: the explicit f32 cast at a float kernel's
    entry.  Inputs of one half type (:data:`HALF_TYPES`) come back as f32
    copies, and ``back`` casts an output to that type; any other inputs
    come back as they are (``require`` then checks them), and ``back``
    returns an output as it is."""
    dtype = ts[0].dtype
    if dtype not in HALF_TYPES:
        return ts, lambda out: out
    if any(t.dtype != dtype for t in ts):
        raise TypeError(f"{name}: inputs of mixed dtypes "
                        f"{[t.dtype for t in ts]}")
    return tuple(t.float() for t in ts), lambda out: out.to(dtype)


def require(t: torch.Tensor, name: str, *, dtype, shape=None,
            strided: bool = False) -> None:
    """The wrappers' argument check: CUDA, dtype, shape, contiguity
    (with ``strided``, only the last dimension must be contiguous: the
    kernel takes the other strides as arguments)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if strided:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be "
                             f"contiguous")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
