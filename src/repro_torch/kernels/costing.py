"""Counting hook of the hand-written kernels for a staged cost count.

:func:`repro_torch.launch.hlo_cost.staged_cost` counts a step op by op.
A kernel's dispatcher (B1 ``coo_spmm.spmm``, B2 ``semiring_matmul.
semiring_matmul``, B3 ``coo_segment.segment_reduce``, B4
``ssm_scan.ssm_scan`` and ``scan_backward``, B5 ``flash_attention.
flash_attention``, ``flash_attention_lse`` and ``attention_backward``)
is wrapped by
:func:`counted`: while a count is open the call is reported once, with
the path, operations and bytes its bound reckons (each input read once,
each output written once), and the ops it runs inside — its CUDA
wrapper's or its plain version's — are not counted.  So a CPU step and
a CUDA step price a kernel alike, and a meta step (a dry run's, where
each dispatcher returns empty outputs of the right shapes) too.  With no
count open the wrapper only reads one list.
"""

from __future__ import annotations

import contextlib
import functools

#: the open counts (objects with ``paused`` and ``kernel(name, path,
#: ops, nbytes)``), innermost last.  Read from every thread, not one
#: context: autograd runs a CUDA backward on a thread of its own, and
#: a kernel there reports to the count its forward was staged under.
_OPEN: list = []


def current():
    """The innermost open count, or None."""
    return _OPEN[-1] if _OPEN else None


@contextlib.contextmanager
def open_count(sink):
    """Make ``sink`` the count that kernel calls report to."""
    _OPEN.append(sink)
    try:
        yield
    finally:
        _OPEN.remove(sink)


@contextlib.contextmanager
def _paused(sink):
    """Ops run inside belong to a kernel already reported."""
    sink.paused = True
    try:
        yield
    finally:
        sink.paused = False


def counted(name: str, cost_of):
    """Wrap a kernel's dispatcher; ``cost_of`` takes the dispatcher's
    arguments and gives ``(path, ops, nbytes)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            sink = current()
            if sink is None or sink.paused:
                return fn(*args, **kwargs)
            with _paused(sink):
                sink.kernel(name, *cost_of(*args, **kwargs))
                return fn(*args, **kwargs)
        return call
    return wrap
