"""B1: fused batched COO semiring SpMM (``csrc/coo_spmm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/coo_spmm.py:214``
(``_spmm_kernel`` via ``_spmm_pallas_call`` :260 / ``spmm_pallas``
:284): the batched fixpoint's frontier advance
``out[d, b] = ⊕_{e: dst(e)=d} w_e ⊗ x[src(e), b]`` as one pass — gather,
⊗ and segment-⊕ fused, no intermediate in device memory.

Geometry (:func:`plan_geometry` / :func:`_build_plan`) is the
reference's, host-built from the concrete operator and cached weakly
per (coords, values, transpose): edges stably sorted by destination,
the unique destinations ``udst`` and their segment starts ``seg``.  The
reference's (out-block, src-block) chunk bucketing exists only for the
TPU's VMEM and is not ported: the CUDA kernel walks the dst-sorted rows
directly, one thread block per destination row with threads across the
B lanes (see the source note in the ``.cu`` file).  Device copies of a
plan are memoized on the plan, once per device.

Bound on the card: bytes (indices, weights, the x rows, the written
rows).

:func:`spmm` dispatches on ``x``'s device: CPU tensors take the plain
version (:func:`repro_torch.kernels.ref.coo_spmm_ref`), CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.core import semiring as sr_mod
from repro_torch.kernels import cuda_lib, ref

#: the plain PyTorch version of this kernel
coo_spmm_plain = ref.coo_spmm_ref

_MODE = {"bool": 0, "trop": 1, "maxplus": 2, "nat": 3, "real": 3}


@dataclasses.dataclass
class SpmmPlan:
    """Host-planned geometry for one (operator, transpose) orientation."""

    sr_name: str
    n_in: int
    n_out: int
    transpose: bool
    nnz: int
    src: np.ndarray    # (nnz,) gather index per edge, dst-sorted
    dst: np.ndarray    # (nnz,) output index per edge, sorted
    udst: np.ndarray   # unique output indices
    seg: np.ndarray    # segment starts of each udst row into src/dst
    w: np.ndarray      # (nnz,) edge values, semiring dtype
    device_cache: dict = dataclasses.field(default_factory=dict)

    def on(self, device) -> dict:
        """The plan's arrays on ``device`` (int32 indices; ``seg`` with
        its end sentinel), copied once per device."""
        device = torch.device(device)
        cached = self.device_cache.get(device)
        if cached is None:
            def t(a, dtype=None):
                arr = np.ascontiguousarray(a if dtype is None
                                           else a.astype(dtype))
                return torch.from_numpy(arr).to(device)
            seg_end = np.concatenate([self.seg, [self.nnz]])
            cached = self.device_cache[device] = dict(
                src=t(self.src, np.int32), dst=t(self.dst, np.int32),
                udst=t(self.udst, np.int32), seg=t(seg_end, np.int32),
                w=t(self.w))
        return cached


_PLANS: dict[tuple[int, int, bool], tuple[object, object, SpmmPlan]] = {}


def plan_geometry(rel, *, transpose: bool = False) -> SpmmPlan:
    """The (cached) fused-SpMM geometry of a binary sparse relation."""
    key = (id(rel.coords), id(rel.values), bool(transpose))
    ent = _PLANS.get(key)
    if ent is not None and ent[0]() is rel.coords \
            and ent[1]() is rel.values:
        return ent[2]
    plan = _build_plan(rel, transpose)

    def _evict(r, k=key):
        cur = _PLANS.get(k)
        if cur is not None and r in (cur[0], cur[1]):
            _PLANS.pop(k, None)

    _PLANS[key] = (weakref.ref(rel.coords, _evict),
                   weakref.ref(rel.values, _evict), plan)
    return plan


def _build_plan(rel, transpose: bool) -> SpmmPlan:
    h = rel.as_np()
    k = int(h.nnz)
    ci, co = (0, 1) if transpose else (1, 0)
    gidx = np.asarray(h.coords[:k, ci], np.int64)
    oidx = np.asarray(h.coords[:k, co], np.int64)
    vals = np.asarray(h.values[:k])
    order = np.argsort(oidx, kind="stable")
    src, dst, w = gidx[order], oidx[order], vals[order]
    if k:
        udst, seg = np.unique(dst, return_index=True)
    else:
        udst, seg = np.zeros(0, np.int64), np.zeros(0, np.int64)
    return SpmmPlan(rel.semiring, int(h.shape[ci]), int(h.shape[co]),
                    transpose, k, src, dst, udst, seg, w)


def spmm(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Fused SpMM: ``x`` ``(n_in, B)`` or ``(n_in,)`` → ``(n_out, ...)``."""
    if x.shape[0] != plan.n_in:
        raise ValueError(f"x has {x.shape[0]} rows, operator takes "
                         f"{plan.n_in}")
    if x.device.type == "cpu":
        p = plan.on(x.device)
        return coo_spmm_plain(sr_mod.get(plan.sr_name), p["src"], p["w"],
                              p["dst"], x, plan.n_out)
    return spmm_cuda(plan, x)


def spmm_cuda(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; counts launches in ``.launches``."""
    sr = sr_mod.get(plan.sr_name)
    if x.dim() not in (1, 2):
        raise ValueError(f"spmm: x must be (n,) or (n, B), got "
                         f"{tuple(x.shape)}")
    cuda_lib.require(x, "x", dtype=sr.dtype)
    p = plan.on(x.device)
    lanes = int(x.shape[1]) if x.dim() == 2 else 1
    out = torch.empty((plan.n_out,) + tuple(x.shape[1:]), dtype=sr.dtype,
                      device=x.device)
    err = cuda_lib.library().coo_spmm(
        _MODE[plan.sr_name], p["src"].data_ptr(), p["w"].data_ptr(),
        p["udst"].data_ptr(), p["seg"].data_ptr(), x.data_ptr(),
        out.data_ptr(), len(plan.udst), plan.n_out, lanes,
        cuda_lib.stream_of(x))
    cuda_lib.check(err, "coo_spmm")
    spmm_cuda.launches += 1
    return out


spmm_cuda.launches = 0
