"""Streaming latency metrics for the serving subsystem.

The counterpart of ``repro/serve/metrics.py`` (pure Python, the same
code).

Tail latency is the serve loop's SLO currency, but keeping every sample
to sort at quantile time is an unbounded-memory bug in a server.  A
:class:`LatencyHistogram` records each sample into log-spaced buckets —
fixed memory, O(1) record, ~4 % relative quantile error across nine
decades (100 ns … 1000 s) — and reports p50/p95/p99 by walking the
cumulative counts (quantiles interpolate inside the winning bucket's
log-width).

:class:`RequestMetrics` groups the three per-request phases the
scheduler stamps:

* ``queue``   — submit → admitted into a slot (or warm/latency serve);
* ``compute`` — admitted → convergence mask fired;
* ``total``   — submit → answer delivered (includes the FIFO-per-family
  reorder wait, so it is what a client actually observes).
"""

from __future__ import annotations

import math


#: bucket geometry: 9 decades from 100ns, 16 buckets per decade → 4.4%
#: max relative error, 144 int counters per histogram
_LO = 1e-7
_PER_DECADE = 16
_DECADES = 9
_NBUCKETS = _PER_DECADE * _DECADES


class LatencyHistogram:
    """Fixed-size log-bucketed histogram of seconds-valued samples."""

    def __init__(self):
        self.counts = [0] * _NBUCKETS
        self.n = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self.n += 1
        self.sum_s += s
        if s > self.max_s:
            self.max_s = s
        if s <= _LO:
            self.counts[0] += 1
            return
        b = int(math.log10(s / _LO) * _PER_DECADE)
        self.counts[min(b, _NBUCKETS - 1)] += 1

    def quantile(self, q: float) -> float:
        """The q-quantile in seconds (0 when no samples yet)."""
        if self.n == 0:
            return 0.0
        rank = q * self.n
        seen = 0.0
        for b, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = _LO * 10.0 ** (b / _PER_DECADE)
                hi = _LO * 10.0 ** ((b + 1) / _PER_DECADE)
                frac = (rank - seen) / c
                return min(lo + (hi - lo) * frac, self.max_s)
            seen += c
        return self.max_s

    def summary(self) -> dict:
        """The stats() leaf: count, mean and the SLO percentiles (ms)."""
        return {
            "count": self.n,
            "mean_ms": (self.sum_s / self.n * 1e3) if self.n else 0.0,
            "p50_ms": self.quantile(0.50) * 1e3,
            "p95_ms": self.quantile(0.95) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "max_ms": self.max_s * 1e3,
        }


class RequestMetrics:
    """queue/compute/total histograms plus a few scalar counters."""

    def __init__(self):
        self.queue = LatencyHistogram()
        self.compute = LatencyHistogram()
        self.total = LatencyHistogram()

    def summary(self) -> dict:
        return {"queue": self.queue.summary(),
                "compute": self.compute.summary(),
                "total": self.total.summary()}


class FrontierMetrics:
    """Per-family chunk-boundary frontier observations.

    The continuous scheduler records the slot pool's live-Δ count after
    every chunk it steps — the same ``FrontierStats`` signal the
    adaptive executor re-prices runners from — so operators can see a
    family's frontier drift (collapse → hub re-explosion) from
    ``stats()`` without instrumenting the pool.  Fixed memory: scalars
    plus one running sum, no per-chunk history.
    """

    def __init__(self):
        self.chunks = 0
        self.last_nnz = 0
        self.last_density = 0.0
        self.peak_nnz = 0
        self._nnz_sum = 0

    def record(self, nnz: int, density: float) -> None:
        self.chunks += 1
        self.last_nnz = int(nnz)
        self.last_density = float(density)
        self._nnz_sum += int(nnz)
        if nnz > self.peak_nnz:
            self.peak_nnz = int(nnz)

    def summary(self) -> dict:
        return {
            "chunks": self.chunks,
            "last_nnz": self.last_nnz,
            "last_density": self.last_density,
            "peak_nnz": self.peak_nnz,
            "mean_nnz": (self._nnz_sum / self.chunks) if self.chunks
            else 0.0,
        }
