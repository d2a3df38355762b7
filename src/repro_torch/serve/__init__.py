"""Continuous-batching serve subsystem.

The counterpart of ``repro/serve``.  :class:`ContinuousServer` runs one
persistent batched fixpoint per program family as a slot pool on the
family's device — admitting queued sources into freed rows, evicting
rows the moment their convergence mask fires, fencing updates
FIFO-per-family, and streaming tail-latency histograms.
``repro_torch.launch.datalog_serve`` is the packed-FIFO server built on
the same family machinery.
"""

from repro_torch.serve.cache import LRUCache
from repro_torch.serve.family import (Family, QueryRequest, UpdateRequest,
                                      build_family, bucket)
from repro_torch.serve.metrics import LatencyHistogram, RequestMetrics
from repro_torch.serve.scheduler import BackpressureError, ContinuousServer
from repro_torch.serve.slots import (BitsetBoolStepper,
                                     LevelSyncTropStepper, SlotPool,
                                     TorchChunkStepper)

__all__ = [
    "BackpressureError", "BitsetBoolStepper", "ContinuousServer",
    "Family", "LRUCache", "LatencyHistogram", "LevelSyncTropStepper",
    "QueryRequest", "RequestMetrics", "SlotPool", "TorchChunkStepper",
    "UpdateRequest", "build_family", "bucket",
]
