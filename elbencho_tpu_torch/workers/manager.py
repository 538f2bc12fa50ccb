"""WorkerManager: owns the worker threads and the phase barrier.

Reference: elbencho_tpu/workers/manager.py (source/workers/
WorkerManager.{h,cpp}), local workers only: prepareThreads() :143,
startNextPhase() :292, waitForWorkersDone() :246 with the time-limit
check :110 and fail-fast interrupt, the live loop's all-done test,
per-phase work accounting getPhaseNumEntriesAndBytes() :334-489 (for
--dryrun), and the slice phase's rank->shard map.
"""

from __future__ import annotations

import os
import threading
import time

from ..phases import BenchPathType, BenchPhase
from .local_worker import LocalWorker, direct_flag
from .shared import WorkerException, WorkersSharedData

#: periodic wakeup for the time-limit and fail-fast checks, here and in
#: the live statistics loop (the JAX package's live-stats poll interval),
#: so --timelimit overruns by at most this much plus the workers' own
#: reaction time
WAIT_WAKEUP_SECS = 0.02


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
        """Open each file/bdev bench path once, shared across workers,
        with O_DIRECT under --direct (reference: prepareBenchPathFDsVec,
        ProgArgs.cpp:1981). Dir mode opens its files per entry, so a
        directory path gets no fd; under --nofdsharing each worker opens
        its own (LocalWorker._prepare_path_fds)."""
        cfg = self.cfg
        if cfg.bench_path_type == BenchPathType.DIR or cfg.no_fd_sharing:
            return
        flags = os.O_RDWR | direct_flag(cfg)
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

    def check_fail_fast_interrupt(self) -> None:
        """The moment one worker errors out, interrupt the survivors
        instead of letting them run the phase to completion (an --infloop
        phase would otherwise hide the error until the time limit)."""
        if self.shared.num_workers_done_with_error \
                and not self._error_interrupt_sent:
            self._error_interrupt_sent = True
            self.interrupt_and_notify_workers()

    def check_phase_time_limit(self, phase_start: float) -> None:
        """--timelimit enforcement (reference: checkPhaseTimeLimit :110)."""
        limit = self.cfg.time_limit_secs
        if not limit or self.shared.phase_time_expired:
            return
        if (time.monotonic() - phase_start) > limit:
            self.shared.mark_phase_time_expired()
            self.interrupt_and_notify_workers()

    def wait_for_workers_done(self, phase_start: float) -> None:
        """Block until all workers finished the phase; each wakeup checks
        the phase time limit and interrupts the survivors of a worker
        error, which is raised here."""
        shared = self.shared
        with shared.cond:
            while shared.num_workers_done \
                    + shared.num_workers_done_with_error < len(self.workers):
                self.check_phase_time_limit(phase_start)
                self.check_fail_fast_interrupt()
                shared.cond.wait(WAIT_WAKEUP_SECS)
            shared.cpu_util_last_done = shared.cpu_util_last_meter.update()
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

    # -- per-phase work accounting (reference: getPhaseNumEntriesAndBytes) --

    @staticmethod
    def get_phase_num_entries_and_bytes(cfg, phase: BenchPhase
                                        ) -> "tuple[int, int]":
        """The entries and bytes a phase of this config is set to do."""
        nthreads = cfg.num_threads
        if phase == BenchPhase.TPUSLICE:
            # striped over the devices: the whole dataset crosses
            # storage->device once (entries = stripes, unknown until the
            # mesh size is probed — report bytes only)
            return (0, cfg.file_size * max(1, len(cfg.paths)))
        if phase in (BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS,
                     BenchPhase.STATDIRS):
            return (nthreads * cfg.num_dirs, 0)
        if cfg.bench_path_type == BenchPathType.DIR:
            entries = nthreads * cfg.num_dirs * cfg.num_files
            num_bytes = entries * cfg.file_size \
                if phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES) \
                else 0
            return (entries, num_bytes)
        entries = len(cfg.paths)
        if phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES):
            if cfg.use_random_offsets:
                return (entries, cfg.random_amount)
            return (entries, cfg.file_size * entries)
        return (entries, 0)

    def all_workers_done(self) -> bool:
        """Every worker finished the phase, with or without an error (the
        live statistics loop's exit test)."""
        shared = self.shared
        return (shared.num_workers_done
                + shared.num_workers_done_with_error) >= len(self.workers)

    def interrupt_and_notify_workers(self) -> None:
        if self.shared.rwmix_balancer is not None:
            self.shared.rwmix_balancer.interrupt()  # wake blocked waiters
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
