"""Counting hook of the hand-written kernels for a staged cost count.

:func:`repro_torch.launch.hlo_cost.staged_cost` counts a step op by op.
A kernel's dispatcher (B1 ``coo_spmm.spmm``, B2 ``semiring_matmul.
semiring_matmul``, B3 ``coo_segment.segment_reduce``) is wrapped by
:func:`counted`: while a count is open the call is reported once, with
the path, operations and bytes its bound reckons (each input read once,
each output written once), and the ops it runs inside — its CUDA
wrapper's or its plain version's — are not counted.  So a CPU step and
a CUDA step price a kernel alike.  With no count open the wrapper only
reads one context variable.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

#: the open count (an object with ``paused`` and ``kernel(name, path,
#: ops, nbytes)``), or None
_SINK: contextvars.ContextVar = contextvars.ContextVar("kernel_cost_sink",
                                                       default=None)


@contextlib.contextmanager
def open_count(sink):
    """Make ``sink`` the count that kernel calls report to."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


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
            sink = _SINK.get()
            if sink is None or sink.paused:
                return fn(*args, **kwargs)
            with _paused(sink):
                sink.kernel(name, *cost_of(*args, **kwargs))
                return fn(*args, **kwargs)
        return call
    return wrap
