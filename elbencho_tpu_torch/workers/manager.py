"""WorkerManager: owns the worker threads and the phase barrier.

Reference: elbencho_tpu/workers/manager.py (source/workers/
WorkerManager.{h,cpp}), local workers only: prepareThreads() :143,
startNextPhase() :292, waitForWorkersDone() :246 with fail-fast interrupt,
and the slice phase's rank->shard map.
"""

from __future__ import annotations

import os
import threading

from ..phases import BenchPathType, BenchPhase
from .local_worker import LocalWorker
from .shared import WorkerException, WorkersSharedData

WAIT_WAKEUP_SECS = 2.0  # periodic wakeup for the fail-fast check


class WorkerManager:
    def __init__(self, config):
        self.cfg = config
        self.shared = WorkersSharedData(config)
        self.workers: "list[LocalWorker]" = []
        self.threads: "list[threading.Thread]" = []
        self._shared_fds: "list[int]" = []
        self._error_interrupt_sent = False

    def prepare_threads(self) -> None:
        """Create workers + threads; prep acts as a barrier."""
        self._open_shared_path_fds()
        for rank in range(self.cfg.num_threads):
            self.workers.append(LocalWorker(self.shared, rank))
        for worker in self.workers:
            t = threading.Thread(target=worker.thread_start,
                                 name=f"worker-{worker.rank}", daemon=True)
            self.threads.append(t)
            t.start()
        self._wait_for_prep_done()

    def _open_shared_path_fds(self) -> None:
        """Open each file/bdev bench path once, shared across workers
        (reference: prepareBenchPathFDsVec, ProgArgs.cpp:1981). Dir mode
        opens its files per entry, so a directory path gets no fd."""
        cfg = self.cfg
        if cfg.bench_path_type == BenchPathType.DIR:
            return
        flags = os.O_RDWR
        if cfg.run_create_files:
            flags |= os.O_CREAT
        for p in cfg.paths:
            try:
                self._shared_fds.append(os.open(p, flags, 0o644))
            except OSError as err:
                raise WorkerException(
                    f"unable to open benchmark path: {err.filename}: "
                    f"{err.strerror}") from err
        cfg.bench_path_fds = self._shared_fds

    def _wait_for_prep_done(self) -> None:
        shared = self.shared
        with shared.cond:
            while (shared.num_workers_done
                   + shared.num_workers_done_with_error) < len(self.workers):
                shared.cond.wait(WAIT_WAKEUP_SECS)
            if shared.num_workers_done_with_error:
                raise WorkerException(
                    f"worker preparation failed: {shared.first_error}")
            shared.num_workers_done = 0

    def start_next_phase(self, phase: BenchPhase) -> str:
        for worker in self.workers:
            worker.reset_stats()
        self._error_interrupt_sent = False
        return self.shared.start_phase(phase)

    def wait_for_workers_done(self) -> None:
        """Block until all workers finished the phase. The moment one
        worker errors out the survivors are interrupted (fail-fast), and
        the error is raised here."""
        shared = self.shared
        with shared.cond:
            while shared.num_workers_done \
                    + shared.num_workers_done_with_error < len(self.workers):
                if shared.num_workers_done_with_error \
                        and not self._error_interrupt_sent:
                    self._error_interrupt_sent = True
                    self.interrupt_and_notify_workers()
                shared.cond.wait(WAIT_WAKEUP_SECS)
            shared.cpu_util_last_done = shared.cpu_util.update()
            if shared.num_workers_done_with_error:
                raise WorkerException(str(shared.first_error))

    # -- slice rank->shard assignment (--gpuslice) --------------------------

    @staticmethod
    def slice_shard_assignment(n_devices: int, n_workers: int,
                               local_rank: int) -> "list[int]":
        """Mesh device indices fed by the worker at local_rank: devices
        are dealt round-robin over this process's workers (device d ->
        worker d % n_workers), so every device of the mesh has exactly
        one feeder and the per-worker load differs by at most one shard.
        The single authority for the slice phase's rank->shard map —
        workers/gpuslice.py and the tests both read it from here."""
        n_workers = max(n_workers, 1)
        return [d for d in range(n_devices)
                if d % n_workers == local_rank % n_workers]

    def interrupt_and_notify_workers(self) -> None:
        for worker in self.workers:
            worker.interrupt_execution()

    def join_all_threads(self) -> None:
        self.start_next_phase(BenchPhase.TERMINATE)
        for t in self.threads:
            t.join(timeout=30)
        for fd in self._shared_fds:
            os.close(fd)
        self._shared_fds = []
        self.cfg.bench_path_fds = []
