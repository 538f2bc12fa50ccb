"""Shared phase state between worker threads and the coordinator.

Reference: elbencho_tpu/workers/shared.py (source/workers/
WorkersSharedData.{h,cpp}): one mutex+condvar, the current bench phase,
the bench UUID acting as the phase-start signal, done counters, the phase
start timestamp, CPU-util snapshots and the interrupt flag. Also the
worker exception types (source/workers/WorkerException.h).
"""

from __future__ import annotations

import threading
import time
import uuid as uuid_mod

from ..phases import BenchPhase
from ..stats.cpu_util import CPUUtil


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
        self.cpu_util = CPUUtil()
        self.cpu_util_stonewall: float = 0.0
        self.cpu_util_last_done: float = 0.0
        self.first_error: "Exception | None" = None
        # (bench uuid, _SliceState) of the current --gpuslice phase
        self.slice_state = None

    def start_phase(self, phase: BenchPhase) -> str:
        """Set the new phase + a fresh bench UUID and wake all workers
        (reference: WorkerManager::startNextPhase, WorkerManager.cpp:292)."""
        with self.cond:
            self.current_phase = phase
            self.bench_uuid = str(uuid_mod.uuid4())
            self.num_workers_done = 0
            self.num_workers_done_with_error = 0
            self.stonewall_triggered = False
            self.phase_start_monotonic = time.monotonic()
            self.cpu_util.update()  # baseline for phase CPU util
            self.cond.notify_all()
            return self.bench_uuid

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
                self.cpu_util_stonewall = self.cpu_util.update()
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
