"""Rate limiting: --limitread/--limitwrite and the --rwmixthrpct balancer.

Reference: elbencho_tpu/toolkits/rate_limiter.py (source/toolkits/
RateLimiter.h, the per-thread bytes/sec limiter that sleeps to the next
second boundary, and RateLimiterRWMixThreads.{h,cpp}, the process-wide
read/write byte-ratio balancer). The port's copy, with two departures
of the per-thread limiter: its first window opens at its first op, not
when it is made (the JAX package makes it at the worker's prepare, so
the first window of the first phase was cut short by the time until the
phase began, and a phase could beat its limit); and it sleeps in
slices of at most ``STOP_SLICE_SECS`` and runs its ``stop`` test before
each, so that a --timelimit or SIGINT ends a throttled phase
within a slice instead of a second. The native engine's limiter does
both too.
"""

from __future__ import annotations

import threading
import time

#: the longest sleep of a limiter between two tests of its stop (the
#: native engine's rate_wait sleeps in slices of this length too)
STOP_SLICE_SECS = 0.1


class RateLimiter:
    """Per-thread bytes-per-second limiter (reference: RateLimiter.h:1-72).

    Tokens refill once per wall-clock second from the first op; wait()
    blocks until the block's bytes fit in the current second's budget.
    """

    def __init__(self, bytes_per_sec: int):
        self.bytes_per_sec = bytes_per_sec
        self._window_start: "float | None" = None  # opened by the first op
        self._bytes_in_window = 0

    def wait(self, num_bytes: int, stop) -> None:
        """Book num_bytes, first sleeping to the next second boundary when
        they do not fit this second's budget. ``stop`` is called before
        each slice of the sleep and ends it by raising."""
        if self.bytes_per_sec <= 0:
            return
        now = time.monotonic()
        if self._window_start is None:
            self._window_start = now
        elapsed = now - self._window_start
        if elapsed >= 1.0:
            self._window_start = now
            self._bytes_in_window = 0
        elif self._bytes_in_window + num_bytes > self.bytes_per_sec:
            # sleep to the next second boundary, then open a fresh window
            remaining = max(0.0, 1.0 - elapsed)
            while remaining > 0:
                stop()
                step = min(remaining, STOP_SLICE_SECS)
                time.sleep(step)
                remaining -= step
            self._window_start = time.monotonic()
            self._bytes_in_window = 0
        self._bytes_in_window += num_bytes


class RateLimiterRWMixThreads:
    """Keeps the read:write *byte ratio* of a mixed-threads phase near the
    requested percentage (``--rwmixthrpct``).

    Process-wide shared counters (the reference uses static atomics +
    condvars, RateLimiterRWMixThreads.h:22-200): readers wait while reads
    are ahead of the target ratio beyond a headroom allowance, writers
    wait in the symmetric case. Waiters are woken whenever the other side
    makes progress, and by interrupt().
    """

    _HEADROOM_BYTES = 16 * 1024 * 1024

    def __init__(self, read_pct: int):
        if not 0 < read_pct < 100:
            raise ValueError("read percentage must be in (0, 100)")
        self.read_pct = read_pct
        self._lock = threading.Condition()
        self._read_bytes = 0
        self._write_bytes = 0
        self._interrupted = False

    def reset(self) -> None:
        with self._lock:
            self._read_bytes = 0
            self._write_bytes = 0
            self._interrupted = False

    def interrupt(self) -> None:
        with self._lock:
            self._interrupted = True
            self._lock.notify_all()

    def _read_target(self) -> int:
        total = self._read_bytes + self._write_bytes
        return int(total * self.read_pct / 100)

    def wait_read(self, num_bytes: int, timeout: float = 0.5) -> None:
        with self._lock:
            while (not self._interrupted
                   and self._read_bytes
                   > self._read_target() + self._HEADROOM_BYTES):
                if not self._lock.wait(timeout):
                    break
            self._read_bytes += num_bytes
            self._lock.notify_all()

    def wait_write(self, num_bytes: int, timeout: float = 0.5) -> None:
        with self._lock:
            while (not self._interrupted
                   and self._write_bytes
                   > (self._read_bytes + self._write_bytes
                      - self._read_target()) + self._HEADROOM_BYTES):
                if not self._lock.wait(timeout):
                    break
            self._write_bytes += num_bytes
            self._lock.notify_all()
