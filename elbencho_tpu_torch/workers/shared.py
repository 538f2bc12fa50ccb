"""Shared phase state between worker threads and the coordinator.

Reference: elbencho_tpu/workers/shared.py (source/workers/
WorkersSharedData.{h,cpp}): one mutex+condvar, the current bench phase,
the bench UUID acting as the phase-start signal, done counters, the phase
start timestamp, CPU-util snapshots, the interrupt and time-limit flags,
the partial-dataset latch, the GPUs lost to --gpufallback and the
--rwmixthrpct byte-ratio balancer. Also the worker exception types
(source/workers/WorkerException.h).
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod

from ..phases import BenchPhase
from ..stats.cpu_util import CPUUtil
from ..toolkits.rate_limiter import RateLimiterRWMixThreads


class WorkerException(Exception):
    """Fatal worker error; the coordinator interrupts everything."""


class WorkerInterruptedException(Exception):
    """Raised inside a worker when interruption was requested."""


class WorkersSharedData:
    def __init__(self, config):
        self.config = config
        self.cond = threading.Condition()
        self.current_phase: BenchPhase = BenchPhase.IDLE
        self.bench_uuid: str = ""
        self.phase_start_monotonic: float = 0.0
        self.num_workers_done = 0
        self.num_workers_done_with_error = 0
        self.stonewall_triggered = False
        self.interrupt_requested = False
        self.phase_time_expired = False
        # latched when a write phase ends interrupted/errored: later
        # delete phases then tolerate missing entries (a partial dataset
        # is expected after an aborted write)
        self.partial_dataset = False
        # --gpufallback: GPUs a worker declared lost; a lost GPU stays
        # lost for the run, and sibling workers skip it when they pick a
        # failover target
        self.poisoned_gpu_ids: "set[int]" = set()
        # two meters, both baselined at the phase start, as upstream's
        # cpuUtilFirstDone/cpuUtilLastDone: one meter read again at the
        # last done would cover only the time since the first done
        self.cpu_util_first_meter = CPUUtil()
        self.cpu_util_last_meter = CPUUtil()
        self.cpu_util_stonewall: float = 0.0
        self.cpu_util_last_done: float = 0.0
        self.first_error: "Exception | None" = None
        # ((bench uuid, --infloop pass), _SliceState) of the current
        # --gpuslice phase
        self.slice_state = None
        # --rwmixthrpct byte-ratio balancer, shared by all workers
        # (reference: RateLimiterRWMixThreads static atomics)
        self.rwmix_balancer = None
        if config.rwmix_thr_read_pct:
            self.rwmix_balancer = RateLimiterRWMixThreads(
                config.rwmix_thr_read_pct)

    def start_phase(self, phase: BenchPhase) -> str:
        """Set the new phase + a fresh bench UUID and wake all workers
        (reference: WorkerManager::startNextPhase, WorkerManager.cpp:292)."""
        with self.cond:
            # latch BEFORE the flags reset: a write phase that ended by
            # --timelimit expiry, an interrupt or a worker error left a
            # partial dataset behind
            if self.current_phase == BenchPhase.CREATEFILES and (
                    self.phase_time_expired or self.interrupt_requested
                    or self.num_workers_done_with_error):
                self.partial_dataset = True
            self.current_phase = phase
            self.bench_uuid = str(uuid_mod.uuid4())
            self.num_workers_done = 0
            self.num_workers_done_with_error = 0
            self.stonewall_triggered = False
            self.phase_time_expired = False
            self.phase_start_monotonic = time.monotonic()
            self.cpu_util_first_meter.update()  # baselines for the phase
            self.cpu_util_last_meter.update()
            if self.rwmix_balancer is not None:
                self.rwmix_balancer.reset()
            self.cond.notify_all()
            return self.bench_uuid

    def mark_phase_time_expired(self) -> None:
        """Latch --timelimit expiry (callers may already hold the
        condition's reentrant lock)."""
        with self.cond:
            self.phase_time_expired = True
            self.cond.notify_all()

    def wait_for_phase_change(self, last_uuid: str) -> "tuple[BenchPhase, str]":
        with self.cond:
            while self.bench_uuid == last_uuid:
                self.cond.wait()
            return self.current_phase, self.bench_uuid

    def inc_num_workers_done(self) -> None:
        """The first finisher triggers the stonewall: all still-running
        workers snapshot their stats for the "first done" column."""
        with self.cond:
            self.num_workers_done += 1
            if not self.stonewall_triggered:
                self.stonewall_triggered = True
                self.cpu_util_stonewall = self.cpu_util_first_meter.update()
            self.cond.notify_all()

    def inc_num_workers_done_with_error(self, err: Exception) -> None:
        with self.cond:
            if self.first_error is None:
                self.first_error = err
            self.num_workers_done_with_error += 1
            self.cond.notify_all()

    def request_interrupt(self) -> None:
        with self.cond:
            self.interrupt_requested = True
            self.cond.notify_all()
