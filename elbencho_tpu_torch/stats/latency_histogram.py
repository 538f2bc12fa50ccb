"""Latency histogram with log2 buckets at quarter-log2 resolution.

Reference: source/LatencyHistogram.{h,cpp} — 112 buckets covering 1 us to
2^28 us (LatencyHistogram.h:14-18); min/avg/max; percentiles including
configurable "number of nines" (``--latpercent9s``); mergeable across
workers (operator+= :185); serializable for the service protocol (:35-37).

Bucket index for a value v (microseconds): floor(4 * log2(v)) for v >= 1,
bucket 0 for v < 1; clamped to the last bucket. This gives 4 buckets per
power of two => ~19% bucket width, matching the reference's quarter-log2
resolution.
"""

from __future__ import annotations

import math

NUM_BUCKETS = 112  # 4 per log2 step, 28 log2 steps
_LOG2_QUARTERS = 4


def bucket_index(micro_secs: float) -> int:
    if micro_secs < 1:
        return 0
    idx = int(_LOG2_QUARTERS * math.log2(micro_secs))
    return min(idx, NUM_BUCKETS - 1)


def bucket_lower_bound(idx: int) -> float:
    """Smallest microsecond value landing in bucket idx."""
    return 2 ** (idx / _LOG2_QUARTERS)


class LatencyHistogram:
    __slots__ = ("buckets", "num_values", "sum_micro", "min_micro",
                 "max_micro")

    def __init__(self):
        self.buckets = [0] * NUM_BUCKETS
        self.num_values = 0
        self.sum_micro = 0
        self.min_micro = 0
        self.max_micro = 0

    def add_latency(self, micro_secs: float) -> None:
        micro_secs = int(micro_secs)
        self.buckets[bucket_index(micro_secs)] += 1
        if not self.num_values or micro_secs < self.min_micro:
            self.min_micro = micro_secs
        if micro_secs > self.max_micro:
            self.max_micro = micro_secs
        self.num_values += 1
        self.sum_micro += micro_secs

    def add_latencies_array(self, micro_secs) -> None:
        """Vectorized bulk insert of a uint64 numpy array (the native
        engine returns per-block latencies in bulk; per-value Python
        add_latency would dominate small-block hot paths)."""
        import numpy as np
        n = len(micro_secs)
        if not n:
            return
        vals = np.asarray(micro_secs, dtype=np.uint64)
        lo = int(vals.min())
        if not self.num_values or lo < self.min_micro:
            self.min_micro = lo
        hi = int(vals.max())
        if hi > self.max_micro:
            self.max_micro = hi
        self.num_values += n
        self.sum_micro += int(vals.sum())
        # bucket = floor(4*log2(v)) for v >= 1 (bucket_index, vectorized)
        clipped = np.maximum(vals, 1).astype(np.float64)
        idx = np.minimum((_LOG2_QUARTERS * np.log2(clipped)).astype(np.int64),
                         NUM_BUCKETS - 1)
        counts = np.bincount(idx, minlength=NUM_BUCKETS)
        for i in np.nonzero(counts)[0]:
            self.buckets[int(i)] += int(counts[i])

    # -- aggregation --------------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """In-place merge (reference operator+=, LatencyHistogram.h:185)."""
        if other.num_values:
            if not self.num_values or other.min_micro < self.min_micro:
                self.min_micro = other.min_micro
            if other.max_micro > self.max_micro:
                self.max_micro = other.max_micro
        self.num_values += other.num_values
        self.sum_micro += other.sum_micro
        for i, count in enumerate(other.buckets):
            self.buckets[i] += count
        return self

    def reset(self) -> None:
        self.__init__()

    # -- queries ------------------------------------------------------------

    @property
    def avg_micro(self) -> float:
        return self.sum_micro / self.num_values if self.num_values else 0.0

    def percentile(self, pct: float) -> float:
        """Latency (us) below which pct% of samples fall (bucket lower bound,
        like the reference's bucket-walk percentile)."""
        if not self.num_values:
            return 0.0
        target = self.num_values * (pct / 100.0)
        running = 0
        for idx, count in enumerate(self.buckets):
            running += count
            if running >= target and count:
                return bucket_lower_bound(idx)
        return float(self.max_micro)

    def percentiles_nines(self, num_nines: int = 2) -> "dict[str, float]":
        """p50/p75/p99 plus p99.9... up to num_nines total nines
        (reference: --latpercent9s)."""
        out = {"p50": self.percentile(50), "p75": self.percentile(75),
               "p99": self.percentile(99)}
        pct = 99.0
        frac = 0.9
        for _ in range(3, num_nines + 1):  # p99 already covers two nines
            pct = pct + frac
            frac /= 10
            out[f"p{pct:g}"] = self.percentile(pct)
        return out

    # -- serialization (service protocol) -----------------------------------

    def to_dict(self, include_buckets: bool = True) -> dict:
        d = {
            "LatMicroSecTotal": self.sum_micro,
            "LatNumValues": self.num_values,
            "LatMinMicroSec": self.min_micro,
            "LatMaxMicroSec": self.max_micro,
        }
        if include_buckets:
            # sparse encoding: only non-zero buckets
            d["LatHistoList"] = {str(i): c for i, c in enumerate(self.buckets) if c}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        histo = cls()
        histo.sum_micro = int(d.get("LatMicroSecTotal", 0))
        histo.num_values = int(d.get("LatNumValues", 0))
        histo.min_micro = int(d.get("LatMinMicroSec", 0))
        histo.max_micro = int(d.get("LatMaxMicroSec", 0))
        for idx_str, count in d.get("LatHistoList", {}).items():
            histo.buckets[int(idx_str)] = int(count)
        return histo

    def to_prometheus_buckets(self) -> "list[tuple[float, int]]":
        """Cumulative (upper_bound_usec, count) pairs over the log2
        buckets for Prometheus histogram exposition (telemetry/registry):
        a value in bucket i is < bucket_lower_bound(i + 1), so that upper
        edge is the bucket's ``le`` bound. Always ends with (+Inf,
        num_values); counts are monotonically non-decreasing by
        construction. Only buckets up to the last non-empty one are
        emitted (the tail would repeat num_values 100+ times)."""
        out: "list[tuple[float, int]]" = []
        running = 0
        last_nonzero = -1
        for idx in range(NUM_BUCKETS - 1, -1, -1):
            if self.buckets[idx]:
                last_nonzero = idx
                break
        for idx in range(last_nonzero + 1):
            running += self.buckets[idx]
            le = bucket_lower_bound(idx + 1)
            if idx == NUM_BUCKETS - 1 and self.max_micro >= le:
                # the top bucket CLAMPS outliers beyond its bound
                # (bucket_index); reporting them under a finite `le`
                # they exceed would cap every derived quantile there —
                # fold the clamp bucket into +Inf instead
                break
            out.append((le, running))
        out.append((float("inf"), self.num_values))
        return out

    def histogram_str(self) -> str:
        """Compact "bucketLowerBound=count" dump for --lathisto."""
        parts = [f"{bucket_lower_bound(i):.0f}us={c}"
                 for i, c in enumerate(self.buckets) if c]
        return ", ".join(parts)
