"""Worker base class: per-worker stats container + interruption checks.

Reference: elbencho_tpu/workers/base.py (source/workers/Worker.{h,cpp}):
LiveOps counters, stonewall snapshots for first-done results, latency
histograms, per-phase elapsed time, the interruption flag.
"""

from __future__ import annotations

import ctypes
import time

from ..stats.latency_histogram import LatencyHistogram
from .shared import WorkerInterruptedException, WorkersSharedData

INTERRUPT_CHECK_INTERVAL = 128  # ops between interruption checks


class LiveOps:
    """entries/bytes/iops counter triple (reference: LiveOps, Worker.h)."""

    __slots__ = ("num_entries_done", "num_bytes_done", "num_iops_done")

    def __init__(self):
        self.reset()

    def snapshot(self) -> "LiveOps":
        s = LiveOps()
        s.num_entries_done = self.num_entries_done
        s.num_bytes_done = self.num_bytes_done
        s.num_iops_done = self.num_iops_done
        return s

    def reset(self) -> None:
        self.num_entries_done = 0
        self.num_bytes_done = 0
        self.num_iops_done = 0


class Worker:
    def __init__(self, shared: WorkersSharedData, rank: int):
        self.shared = shared
        self.rank = rank
        self.live_ops = LiveOps()
        self.stonewall_ops = LiveOps()
        self.stonewall_taken = False
        self.iops_latency_histo = LatencyHistogram()
        self.entries_latency_histo = LatencyHistogram()
        self.elapsed_usec_vec: "list[int]" = []
        self.stonewall_elapsed_usec = 0
        self.got_phase_work = True
        self.is_interrupted = False
        # the interruption flag as the native engine polls it
        self._native_interrupt = ctypes.c_int(0)
        self._ops_since_check = 0
        self.gpu_transfer_bytes = 0   # device ingest/egress accounting
        self.gpu_transfer_usec = 0    # copy wall time (submit -> done)
        self.gpu_dispatch_usec = 0    # host-side submit cost (the overhead
                                      # --gpubudget bounds)
        self._reset_slice_counters()

    def _reset_slice_counters(self) -> None:
        """--gpuslice counters (workers/gpuslice.py), owned by the worker
        since the phase runs with or without a device context: shard
        bytes this worker fed onto the mesh, the lead worker's redistributed
        bytes, time and best single-stripe rate, and the per-device
        ingest bytes of a feeder without a context (device index ->
        (bytes, usec)), and those devices. The MiB counters mirror the
        byte totals."""
        self.shard_ingest_mib = 0
        self.ici_redist_mib = 0
        self.ici_redist_usec = 0
        self.ici_gbps_hwm = 0
        self._shard_ingest_bytes = 0
        self._ici_redist_bytes = 0
        self.gpu_per_chip: "dict[int, tuple[int, int]]" = {}
        self.slice_devices: list = []  # the mesh devices this worker fed

    def reset_stats(self) -> None:
        self.is_interrupted = False
        self._native_interrupt.value = 0
        self.live_ops.reset()
        self.stonewall_ops.reset()
        self.stonewall_taken = False
        self.iops_latency_histo.reset()
        self.entries_latency_histo.reset()
        self.elapsed_usec_vec = []
        self.stonewall_elapsed_usec = 0
        self.got_phase_work = True
        self._ops_since_check = 0
        self.gpu_transfer_bytes = 0
        self.gpu_transfer_usec = 0
        self.gpu_dispatch_usec = 0
        self._reset_slice_counters()

    def create_stonewall_stats_if_triggered(self) -> None:
        """Snapshot current counters when the first worker finished
        (reference: createStoneWallStats, Worker.h:203)."""
        if self.stonewall_taken or not self.shared.stonewall_triggered:
            return
        self.stonewall_ops = self.live_ops.snapshot()
        self.stonewall_elapsed_usec = self.phase_elapsed_usec()
        self.stonewall_taken = True

    def finish_phase_stats(self) -> None:
        """Called by the worker when its phase work is complete."""
        if not self.stonewall_taken:
            # first finisher: stonewall stats == final stats
            self.stonewall_ops = self.live_ops.snapshot()
            self.stonewall_elapsed_usec = self.phase_elapsed_usec()
            self.stonewall_taken = True
        self.elapsed_usec_vec.append(self.phase_elapsed_usec())

    def phase_elapsed_usec(self) -> int:
        return int((time.monotonic()
                    - self.shared.phase_start_monotonic) * 1_000_000)

    def interrupt_execution(self) -> None:
        self.is_interrupted = True
        self._native_interrupt.value = 1

    def check_interruption_request(self, force: bool = False) -> None:
        """Cheap periodic check in hot loops; also the stonewall snapshot
        point (reference: checkInterruptionRequest). ``force`` checks now
        (once per dir-mode entry), not only every 128th call."""
        self._ops_since_check += 1
        if not force and self._ops_since_check < INTERRUPT_CHECK_INTERVAL:
            return
        self._ops_since_check = 0
        self.create_stonewall_stats_if_triggered()
        if self.is_interrupted or self.shared.interrupt_requested:
            raise WorkerInterruptedException("worker interruption requested")

    def check_interruption_flag_only(self) -> None:
        """Interruption test without the stonewall snapshot or the op
        count, for threads parked on the slice phase's barrier."""
        if self.is_interrupted or self.shared.interrupt_requested:
            raise WorkerInterruptedException("worker interruption requested")

    def run(self) -> None:
        raise NotImplementedError

    def thread_start(self) -> None:
        try:
            self.run()
        except Exception as err:  # noqa: BLE001 - worker errors are reported
            from ..toolkits import logger
            logger.log_error(f"Worker {self.rank} terminated on error: "
                             f"{type(err).__name__}: {err}")
            self.shared.inc_num_workers_done_with_error(err)
