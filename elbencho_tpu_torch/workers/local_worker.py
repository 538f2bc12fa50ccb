"""LocalWorker: one I/O worker thread running the POSIX phase loops.

Reference: elbencho_tpu/workers/local_worker.py (source/workers/
LocalWorker.{h,cpp}), cut to the port's slices: dir mode (the dir/file
namespace, mkdir/stat/rmdir of dirs, write/read/stat/unlink of files),
file mode on one or several files or block devices (striped), integrity
verify, the delete phases, and three block loops (offset gen -> [pre-write
fill] -> positional I/O -> [post-read verify / device ingest] -> latency +
counters), tried in this order:

1. the fused ``--gpustream`` ring (device phases): the native engine
   keeps up to ``--iodepth`` io_uring (or kernel-AIO) ops in flight over
   the staging slots, the GIL released while it reaps, and each
   completed slot goes to the device transfer ring;
2. the native block loop (phases without a device): the whole loop,
   verify included, in the engine;
3. the Python loop (``preadv``/``pwritev``).

Under ``--ioretries`` each loop retries a transient storage error
(workers/io_errors.py): the Python loop and the ring per op, the native
block loop per chunk; ``--iotimeout`` bounds a ring op. A write phase
under ``--rwmixpct`` reads every op whose ``(rank + op index) % 100`` is
below the percentage, in all three loops; under ``--rwmixthr`` the first
ranks run the read workload instead; both book their reads in the
rwmix-read counters. The per-thread ``--limitread``/``--limitwrite``
limits and the ``--rwmixthrpct`` balancer run per op in the Python loop
(the limits also in the native block loop), and ``--blockvarpct``
refills each write block on the host (the device's fill pool is the
source of a device phase's writes, so there it changes nothing). The
per-op features ``--flock`` (a byte-range lock around each op),
``--readinline``/``--verifydirect`` (each written block read straight
back, and verified under ``--verify``) and ``--opslog`` (one JSONL record
per block, and a pre and a post record around each dir-mode entry) keep a
phase off the fused ring; the native block loop serves them at
``--iodepth 1`` on the sync engine (``--opslog`` at any depth), the
Python loop everywhere else. Every call into the device context goes
through ``_gpu_guarded``, which hands a lost GPU to ``--gpufallback``.

Dir mode and custom trees (``--treefile``) go file by file. Without a
device, at ``--iodepth 1`` on the sync engine and with no per-op Python
feature, the engine's per-file loop runs whole chunks of files (open,
blocks and close, or stat, or unlink: the small-file hot path). Else each
file, or each worker's range of a shared tree file, goes through the
block loops above. Under ``--treeroundrob`` a worker's share of a shared
file is every dataset-thread-th block (``OffsetGenStrided``), which only
the block loops take.

Under ``--mmap`` a file (one file or block device in file mode, each
file in dir mode) is mapped and each block is a memcpy between the
mapping and a staging slot: without a device through the engine's mmap
loop, with one through a Python memcpy loop feeding the device's copies.
``--madv`` advises each mapping (and, through the staging pool, the
slab), ``--fadv`` each file after a write and before a read. The other
storage back ends are later slices.

Under ``--direct`` every file the block loops and the engine's loops read
or write is opened with O_DIRECT (the manager's shared fds of file mode,
a worker's own under ``--nofdsharing``, each dir-mode and tree file); a
file system that refuses it, or an op that is not aligned as it needs
(``--nodiocheck``, ``--norandalign``), fails the phase. The offsets come
from the generators of toolkits/offset_gen.py: sequential, ``--backward``,
``--strided`` (file mode), ``--rand`` (aligned, or anywhere under
``--norandalign``, drawn with ``--randalgo``) and the ``--shufflewindow``
permutation of a read; every loop takes them through ``next_batch`` or
iteration, and the engine's per-file loop, which walks each file
forward, leaves a backward or shuffled phase to the block loops.

The file-lifecycle flags act where the JAX package's do: ``--trunc``
adds O_TRUNC to every write open of dir mode, the custom trees and the
engine's per-file loop (file mode's shared fds are opened without it); a
dir-mode write takes ``--statinline``'s fstat, then ``--preallocfile``'s
posix_fallocate, then ``--trunctosize``'s ftruncate, and a read the
fstat after ``--fadv``; a file-mode write truncates each fd to ``-s``
under ``--trunctosize``; ``--nodelerr`` lets every delete pass over a
missing entry. The first three keep a phase out of the engine's per-file
loop. The SYNC and DROPCACHES phases run on the first worker only.

Preparation first binds the worker's thread (``_apply_core_binding``):
under ``--cores`` to one core, else under ``--zones`` to the CPUs and the
memory of one NUMA zone, round-robin by rank, as the JAX package does; a
zone bound so also binds the worker's staging slabs (utils/numa.py,
utils/staging_pool.py). It runs on the worker's own thread, so it binds
that thread only: the ``--gpuslice`` feeders and the ``--gpubench``
workers are bound like any other.

The GPU data path replaces upstream elbencho's CUDA staging
(allocGPUIOBuffer :1427-1537, cudaMemcpy wrappers :2437-2490): workers
map to GPUs by ``rank % len(gpu_ids)`` and move blocks through a
``CudaWorkerContext`` (elbencho_tpu_torch/cuda/device.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import errno
import mmap
import os
import stat as stat_mod
import time
from collections import deque

import numpy as np

from ..ops.fill import fill_verify_pattern_host
from ..phases import GPU_PROFILE_PHASES, BenchPathType, BenchPhase
from ..toolkits import logger
from ..toolkits.file_tk import FileRangeLock
from ..toolkits.offset_gen import (OffsetGenRandom, OffsetGenRandomAligned,
                                   OffsetGenRandomAlignedFullCoverage,
                                   OffsetGenReverseSeq, OffsetGenSequential,
                                   OffsetGenShuffleWindow, OffsetGenStrided)
from ..toolkits.ops_logger import OpsLogger
from ..toolkits.random_algos import RandAlgoGoldenPrime, create_rand_algo
from ..toolkits.rate_limiter import RateLimiter
from ..toolkits.units import parse_flag_list, parse_uint_list
from ..utils.native import (ENGINE_CODES, NativeStreamError,
                            NativeVerifyError, _account_chunk,
                            get_native_engine)
from .base import Worker
from .io_errors import IoRetryBudgetExhausted, ShortIOError, make_io_retrier
from .shared import WorkerException, WorkerInterruptedException

MKFILE_MODE = 0o644  # reference: MKFILE_MODE, Common.h:96
MKDIR_MODE = 0o755
DROP_CACHES_PATH = "/proc/sys/vm/drop_caches"  # the --dropcaches phase


def direct_flag(cfg) -> int:
    """O_DIRECT under --direct, else 0: every open of a file that the
    block loops or the engine's loops read or write takes it. A file
    system that refuses it fails the phase; no open is retried without
    it."""
    return os.O_DIRECT if cfg.use_direct_io else 0


class LocalWorker(Worker):
    def __init__(self, shared, rank: int):
        super().__init__(shared, rank)
        self.cfg = shared.config
        # io_depth staging slots so pipelined device transfers never see a
        # block overwritten while in flight (reference: allocIOBuffer x
        # iodepth, :1386)
        self._staging_pool = None
        self._numa_zone = None  # set when --zones bound this worker
        self._io_bufs: "list[memoryview]" = []
        self._rand_offset_algo = None
        self._block_var_algo = None  # --blockvarpct refill (Python loop)
        self._rate_limiter_read: "RateLimiter | None" = None
        self._rate_limiter_write: "RateLimiter | None" = None
        # the native engine's limiter windows (read, then write), made
        # once per prepare like the RateLimiter objects above, so that a
        # window carries across the engine's chunks and the phases
        self._native_rl_state = (ctypes.c_uint64 * 4)()
        self._rwmix_thread_reader = False  # a --rwmixthr reader's phase
        self._gpu = None  # CudaWorkerContext when --gpuids given
        self._native = None  # the native engine, where it can be built
        self._madvise: "list[int]" = []  # --madv advice for each mapping
        # file mode's path fds: the manager's shared ones, or under
        # --nofdsharing the worker's own, which cleanup() closes
        self._path_fds: "list[int]" = []
        self._own_path_fds: "list[int]" = []
        self._num_iops_submitted = 0
        self._stream_mode_logged = False  # once-per-phase fused-loop note
        self._stream_drain_failed = False  # aborted ring drain: leak bufs
        self._tolerate_note_logged = False  # once-per-phase partial note
        self._io_retrier = None  # --ioretries (workers/io_errors.py)
        self.phase_pass = 0  # the --infloop pass of the current phase

    def reset_stats(self) -> None:
        super().reset_stats()
        self._stream_mode_logged = False
        self._tolerate_note_logged = False
        self.phase_pass = 0
        if self._io_retrier is not None:
            self._io_retrier.reset()  # the backoff budget is per phase
        if self._gpu is not None:
            # path-audit counters are per-phase, like gpu_transfer_bytes
            self._gpu.reset_path_counters()

    # ------------------------------------------------------------------
    # preparation (reference: preparePhase, LocalWorker.cpp:424)
    # ------------------------------------------------------------------

    def prepare(self) -> None:
        cfg = self.cfg
        self._apply_core_binding()
        from ..utils.staging_pool import MADVISE, StagingPool
        self._staging_pool = StagingPool(
            max(cfg.io_depth, 1), max(cfg.block_size, 1),
            fill_algo=RandAlgoGoldenPrime(seed=self.rank + 1),
            madvise_flags=cfg.madvise_flags, numa_zone=self._numa_zone)
        # the configuration refused any other name
        self._madvise = [MADVISE[name]
                         for name in parse_flag_list(cfg.madvise_flags)]
        self._io_bufs = self._staging_pool.views
        self._native = get_native_engine()  # build outside the timed phase
        # None without --ioretries: the loops then take no retry branch
        self._io_retrier = make_io_retrier(self)
        if cfg.gpu_ids:
            from ..cuda.device import CudaWorkerContext
            chip = cfg.gpu_ids[self.rank % len(cfg.gpu_ids)]
            # --gpudepth overrides the iodepth ride-along. Under
            # --gpudirect the depth is clamped to the I/O slot count: the
            # registered slot is the copy's source until the ring drains
            # it, and slot rotation only guarantees that when the ring is
            # no deeper than the rotation period.
            depth = max(cfg.gpu_depth or cfg.io_depth, 1)
            if cfg.use_gpu_direct and depth > max(cfg.io_depth, 1):
                if self.rank % max(1, cfg.num_threads) == 0:
                    logger.log(
                        logger.LOG_NORMAL,
                        f"NOTE: --gpudepth {depth} exceeds --iodepth "
                        f"{cfg.io_depth}; clamped to {max(cfg.io_depth, 1)} "
                        f"under --gpudirect (a host buffer must not be "
                        f"rewritten before its copy completed)")
                depth = max(cfg.io_depth, 1)
            self._gpu = CudaWorkerContext(
                chip_id=chip, block_size=cfg.block_size,
                direct=cfg.use_gpu_direct, verify_on_device=cfg.do_gpu_verify,
                pipeline_depth=depth, hbm_limit_pct=cfg.gpu_hbm_limit_pct,
                dispatch_budget_usec=cfg.gpu_dispatch_budget_usec,
                batch_blocks=max(cfg.gpu_batch_blocks, 1),
                staging_pool=self._staging_pool, device=cfg.device)
            # --gpubench d2h/both draws on the fill pool, h2d/both on the
            # H2D ring: both are built here, outside the timed phase. The
            # JAX package skips the transfer warmup under --tpudirect,
            # where it would pin HBM staging blocks; here it allocates
            # only the device ring slots the first copy would allocate.
            bench = cfg.gpu_bench_pattern if cfg.run_gpu_bench else ""
            if (cfg.run_create_files or bench in ("d2h", "both")) \
                    and not cfg.integrity_check_salt:
                self._gpu.warmup_fill()  # device fill outside timed phase
            if cfg.run_read_files or bench in ("h2d", "both") \
                    or cfg.rwmix_read_pct or cfg.num_rwmix_read_threads:
                self._gpu.warmup_transfer()
            if cfg.gpu_profile_dir:
                self._gpu.profile_warmup()  # its buffers, outside phases
        if cfg.bench_path_type != BenchPathType.DIR:
            self._prepare_path_fds()
        self._rand_offset_algo = create_rand_algo(cfg.rand_offset_algo,
                                                  seed=None)
        if cfg.block_variance_pct:
            self._block_var_algo = create_rand_algo(cfg.block_variance_algo)
        if cfg.limit_read_bps:
            self._rate_limiter_read = RateLimiter(cfg.limit_read_bps)
        if cfg.limit_write_bps:
            self._rate_limiter_write = RateLimiter(cfg.limit_write_bps)
        if cfg.ops_log_path:
            self._ops_log = OpsLogger(cfg.ops_log_path, self.rank,
                                      use_lock=cfg.ops_log_lock)

    def _apply_core_binding(self) -> None:
        """Round-robin worker -> core binding of the calling (worker)
        thread (reference: elbencho_tpu/workers/local_worker.py
        ``_apply_core_binding``): --cores pins it to one core; else
        --zones binds its CPU affinity and memory policy to one NUMA zone,
        kept in ``_numa_zone`` for the staging slabs when the bind
        succeeded. --cores wins when both are given. A list that does not
        parse raises, failing the worker's preparation."""
        cfg = self.cfg
        if cfg.cpu_cores_str:
            cores = parse_uint_list(cfg.cpu_cores_str)
            if cores:
                core = cores[self.rank % len(cores)]
                try:
                    os.sched_setaffinity(0, {core})
                except OSError as err:
                    logger.log_error(f"core binding failed: {err}")
        elif cfg.numa_zones_str:
            from ..utils.numa import bind_to_numa_zone
            zones = parse_uint_list(cfg.numa_zones_str)
            if zones:
                zone = zones[self.rank % len(zones)]
                if bind_to_numa_zone(zone):
                    self._numa_zone = zone

    def _prepare_path_fds(self) -> None:
        """File/blockdev mode fds: the manager's shared ones, or under
        --nofdsharing one of the worker's own per path, opened as the
        manager opens them (reference: prepareBenchPathFDsVec,
        ProgArgs.cpp:1981)."""
        cfg = self.cfg
        if cfg.bench_path_fds and not cfg.no_fd_sharing:
            self._path_fds = cfg.bench_path_fds
            return
        flags = os.O_RDWR | direct_flag(cfg)
        if cfg.run_create_files:
            flags |= os.O_CREAT
        for p in cfg.paths:
            # appended one by one: a failed open leaves the ones before
            # it where cleanup() closes them
            self._own_path_fds.append(os.open(p, flags, MKFILE_MODE))
        self._path_fds = self._own_path_fds

    def cleanup(self) -> None:
        for fd in self._own_path_fds:
            os.close(fd)
        self._own_path_fds = []
        self._path_fds = []
        if self._gpu is not None:
            self._gpu.close()  # drop device tensors before buffer teardown
            self._gpu = None
        self._io_bufs = []
        if self._staging_pool is not None:
            if self._stream_drain_failed:
                # kernel DMA may still target the slots
                self._staging_pool.leak()
            self._staging_pool.close()
            self._staging_pool = None
        if self._ops_log is not None:
            self._ops_log.close()
            self._ops_log = None

    # ------------------------------------------------------------------
    # phase loop (reference: LocalWorker::run, LocalWorker.cpp:193-418)
    # ------------------------------------------------------------------

    def run(self) -> None:
        try:
            self.prepare()
            # capture the current uuid BEFORE signalling prep-done: the
            # coordinator may start the first phase the moment the last
            # worker checks in, and we must notice that uuid change
            last_uuid = self.shared.bench_uuid
            self.shared.inc_num_workers_done()  # prep barrier
            while True:
                phase, last_uuid = self.shared.wait_for_phase_change(last_uuid)
                if phase == BenchPhase.TERMINATE:
                    return
                if phase == BenchPhase.IDLE:
                    continue
                self.reset_stats()
                try:
                    if self.cfg.gpu_profile_dir and self._gpu is not None \
                            and phase in GPU_PROFILE_PHASES:
                        self._gpu.profile_warmup()
                    while True:
                        self._num_iops_submitted = 0
                        self._dispatch_phase(phase)
                        if not self.cfg.do_infinite_io_loop:
                            break
                        self.check_interruption_request(force=True)
                        self.phase_pass += 1
                    self.finish_phase_stats()
                    self.shared.inc_num_workers_done()
                except WorkerInterruptedException:
                    if self._gpu is not None:
                        # the phase ends with no copy in flight: none
                        # still reads a slot the next pass, phase or the
                        # teardown reuses or unregisters
                        self._gpu.drain()
                        self._sync_gpu_usec()
                    self.finish_phase_stats()
                    self.shared.inc_num_workers_done()
                except Exception as err:  # noqa: BLE001
                    logger.log_error(
                        f"Worker {self.rank} phase "
                        f"{phase.name} failed: {type(err).__name__}: {err}")
                    self.shared.inc_num_workers_done_with_error(err)
        finally:
            self.cleanup()

    def _dispatch_phase(self, phase: BenchPhase) -> None:
        """Phase x path type -> loop (reference: the POSIX branches of
        the JAX package's _dispatch_phase_inner). Under --rwmixthr the
        first ranks of each process run the read workload in the write
        phase (reference: the rwmix-threads reader conversion,
        LocalWorker.cpp:1054-1062)."""
        cfg = self.cfg
        if (phase == BenchPhase.CREATEFILES and cfg.num_rwmix_read_threads
                and (self.rank % max(1, cfg.num_threads))
                < cfg.num_rwmix_read_threads):
            self._run_as_rwmix_reader()
            return
        self._dispatch_phase_inner(phase)

    def _run_as_rwmix_reader(self) -> None:
        """Swap the counters, the stonewall snapshots and the histograms
        with their rwmix-read twins, run the read workload, swap back. The
        JAX package leaves the stonewall snapshots out of the swap, so a
        snapshot taken while a reader ran landed in the wrong column."""
        def swap():
            self.live_ops, self.live_ops_rwmix_read = \
                self.live_ops_rwmix_read, self.live_ops
            self.stonewall_ops, self.stonewall_ops_rwmix_read = \
                self.stonewall_ops_rwmix_read, self.stonewall_ops
            self.iops_latency_histo, self.iops_latency_histo_rwmix = \
                self.iops_latency_histo_rwmix, self.iops_latency_histo
            self.entries_latency_histo, self.entries_latency_histo_rwmix = \
                self.entries_latency_histo_rwmix, self.entries_latency_histo

        swap()
        self._rwmix_thread_reader = True
        try:
            self._dispatch_phase_inner(BenchPhase.READFILES)
        finally:
            self._rwmix_thread_reader = False
            swap()

    def _dispatch_phase_inner(self, phase: BenchPhase) -> None:
        if phase == BenchPhase.SYNC:
            self._any_mode_sync()
        elif phase == BenchPhase.DROPCACHES:
            self._any_mode_drop_caches()
        elif phase == BenchPhase.TPUBENCH:
            from .gpubench import run_gpubench_phase
            run_gpubench_phase(self)
        elif phase == BenchPhase.TPUSLICE:
            from .gpuslice import run_gpu_slice_phase
            run_gpu_slice_phase(self)
        elif phase in (BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS,
                       BenchPhase.STATDIRS):
            self._dir_mode_iterate_dirs(phase)
        elif self.cfg.bench_path_type == BenchPathType.DIR:
            if self.cfg.tree_file_path:
                self._custom_tree_iterate_files(phase)
            else:
                self._dir_mode_iterate_files(phase)
        else:
            self._file_mode_phase(phase)

    # ------------------------------------------------------------------
    # sync / dropcaches (reference: anyModeSync :8075 / DropCaches :8118):
    # the first worker of the process does the work and counts one entry,
    # the others report no phase work; neither touches the device
    # ------------------------------------------------------------------

    def _any_mode_sync(self) -> None:
        if self.rank % max(1, self.cfg.num_threads) != 0:
            self.got_phase_work = False
            return
        os.sync()
        self.live_ops.num_entries_done += 1

    def _any_mode_drop_caches(self) -> None:
        if self.rank % max(1, self.cfg.num_threads) != 0:
            self.got_phase_work = False
            return
        try:
            with open(DROP_CACHES_PATH, "w") as f:
                f.write("3")  # the page cache, dentries and inodes
        except PermissionError as err:
            raise WorkerException(
                "dropping caches requires root privileges") from err
        self.live_ops.num_entries_done += 1

    # ------------------------------------------------------------------
    # dir mode (reference: dirModeIterateDirs :2811 / IterateFiles :3055)
    # ------------------------------------------------------------------

    @staticmethod
    def dir_rel_path_for(rank: int, dir_idx: int, dir_sharing: bool) -> str:
        """Namespace: "r<rank>/d<idx>", or shared "d<idx>" with --dirsharing
        (reference: LocalWorker.cpp:3097 + dirsharing)."""
        if dir_sharing:
            return f"d{dir_idx}"
        return f"r{rank}/d{dir_idx}"

    @staticmethod
    def file_rel_path_for(rank: int, dir_idx: int, file_idx: int,
                          dir_sharing: bool) -> str:
        base = LocalWorker.dir_rel_path_for(rank, dir_idx, dir_sharing)
        return f"{base}/r{rank}-f{file_idx}"

    def _bench_path_for_dir(self, dir_idx: int) -> str:
        """Round-robin dirs over bench paths (reference: :3110)."""
        paths = self.cfg.paths
        return paths[(self.rank + dir_idx) % len(paths)]

    def _dir_mode_iterate_dirs(self, phase: BenchPhase) -> None:
        cfg = self.cfg
        if cfg.do_dir_sharing and self.rank % cfg.num_threads != 0 \
                and phase != BenchPhase.STATDIRS:
            # with dirsharing only one local worker creates/deletes the
            # shared dirs (others would collide)
            self.got_phase_work = False
            return
        for dir_idx in range(cfg.num_dirs):
            self.check_interruption_request(force=True)
            path = os.path.join(
                self._bench_path_for_dir(dir_idx),
                self.dir_rel_path_for(self.rank, dir_idx, cfg.do_dir_sharing))
            with self.oplog(phase.name.lower(), path) as op_rec:
                t0 = time.perf_counter_ns()
                if phase == BenchPhase.CREATEDIRS:
                    os.makedirs(path, MKDIR_MODE, exist_ok=True)
                elif phase == BenchPhase.DELETEDIRS:
                    try:
                        os.rmdir(path)
                        parent = os.path.dirname(path)
                        if os.path.basename(parent).startswith("r"):
                            try:
                                os.rmdir(parent)  # remove empty rank dir
                            except OSError:
                                pass
                    except FileNotFoundError:
                        if not self._ignore_delete_errors(phase):
                            raise
                        op_rec.error = True
                else:  # STATDIRS
                    os.stat(path)
                lat_usec = (time.perf_counter_ns() - t0) // 1000
            self.entries_latency_histo.add_latency(lat_usec)
            self.live_ops.num_entries_done += 1

    def _dir_mode_iterate_files(self, phase: BenchPhase) -> None:
        """open -> block loop -> close per file; entry latency histogram
        per file (reference: dirModeIterateFiles :3055-3281,
        unlinkat/fstatat for del/stat :3237-3249). The engine's per-file
        loop serves the phase where it can."""
        cfg = self.cfg
        if self._can_use_native_file_loop(phase):
            self._run_native_file_loop(phase)
            return
        for dir_idx in range(cfg.num_dirs):
            base = self._bench_path_for_dir(dir_idx)
            for file_idx in range(cfg.num_files):
                self.check_interruption_request(force=True)
                path = os.path.join(base, self.file_rel_path_for(
                    self.rank, dir_idx, file_idx, cfg.do_dir_sharing))
                with self.oplog(phase.name.lower(), path) as op_rec:
                    t0 = time.perf_counter_ns()
                    if phase == BenchPhase.CREATEFILES:
                        self._write_one_file(path)
                    elif phase == BenchPhase.READFILES:
                        self._read_one_file(path)
                    elif phase == BenchPhase.STATFILES:
                        os.stat(path)
                    elif phase == BenchPhase.DELETEFILES:
                        try:
                            os.unlink(path)
                        except FileNotFoundError:
                            if not self._ignore_delete_errors(phase):
                                raise
                            op_rec.error = True
                    lat_usec = (time.perf_counter_ns() - t0) // 1000
                self.entries_latency_histo.add_latency(lat_usec)
                self.live_ops.num_entries_done += 1

    def _open_flags_write(self) -> int:
        """A write opens read-write where the same fd also reads: the
        --rwmixpct reads and the --readinline/--verifydirect read-back;
        O_DIRECT under --direct, O_TRUNC under --trunc. Every write open
        of dir mode, of a custom tree and of the engine's per-file loop
        takes these flags; file mode's fds are opened without O_TRUNC, as
        in the JAX package (workers/manager.py, _prepare_path_fds)."""
        cfg = self.cfg
        if cfg.rwmix_read_pct or cfg.do_read_inline or cfg.do_direct_verify:
            flags = os.O_RDWR | os.O_CREAT
        else:
            flags = os.O_WRONLY | os.O_CREAT
        if cfg.do_truncate:
            flags |= os.O_TRUNC
        return flags | direct_flag(cfg)

    def _write_one_file(self, path: str) -> None:
        cfg = self.cfg
        flags = self._open_flags_write()
        if cfg.use_mmap:
            # a writable mapping needs a read-write fd
            flags = (flags & ~os.O_WRONLY) | os.O_RDWR
        try:
            fd = os.open(path, flags, MKFILE_MODE)
        except FileNotFoundError as err:
            if not cfg.run_create_dirs:
                # parity hint (reference: dirModeOpenAndPrepFile :7395)
                raise WorkerException(
                    f"File create/open failed. Did you forget to enable "
                    f"directory creation ('--mkdirs'/-d)? Path: {path}"
                ) from err
            raise
        try:
            # in the JAX package's order: --statinline, then
            # --preallocfile, then --trunctosize
            if cfg.do_stat_inline:
                os.fstat(fd)
            if cfg.do_prealloc_file and cfg.file_size:
                os.posix_fallocate(fd, 0, cfg.file_size)
            if cfg.do_truncate_to_size:
                os.ftruncate(fd, cfg.file_size)
            if cfg.file_size:
                if cfg.use_mmap:
                    self._rw_block_sized_mmap(fd, is_write=True)
                else:
                    self._rw_block_sized(
                        fd, self._make_offset_gen_for_file(is_write=True),
                        is_write=True)
            self._apply_fadvise(fd)  # after the write, as the reference
        finally:
            os.close(fd)

    def _read_one_file(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY | direct_flag(self.cfg))
        try:
            self._apply_fadvise(fd)
            if self.cfg.do_stat_inline:
                os.fstat(fd)
            if self.cfg.file_size:
                if self.cfg.use_mmap:
                    self._rw_block_sized_mmap(fd, is_write=False)
                else:
                    self._rw_block_sized(
                        fd, self._make_offset_gen_for_file(is_write=False),
                        is_write=False)
        finally:
            os.close(fd)

    def _make_shuffle_gen(self, num_bytes: int,
                          start: int = 0) -> OffsetGenShuffleWindow:
        """--shufflewindow: the seeded windowed permutation, dir mode's
        and file mode's alike. The JAX package seeds it with
        ``scenario_epoch * 1_000_003 + rank``, so that its epochs
        scenario shuffles anew each epoch and the workers do not read in
        step; the port has no scenarios yet (ROADMAP A item 10), so its
        epoch is always 0 and the seed is the rank."""
        bs = self.cfg.block_size
        return OffsetGenShuffleWindow(
            num_bytes, bs, max(self.cfg.shuffle_window, bs),
            seed=self.rank, start=start)

    def _make_offset_gen_for_file(self, is_write: bool):
        """Offsets within one dir-mode file: a --shufflewindow read, the
        random offsets, --backward or sequential; --strided has no
        meaning within one worker's file and is ignored, as in the JAX
        package. Random mode reads (or, for writes, covers) the random
        amount divided by the dataset threads, at least one block, per
        file: the reference's per-file split (reference:
        initPhaseRWOffsetGen :1141-1186)."""
        cfg = self.cfg
        size, bs = cfg.file_size, cfg.block_size
        if not is_write and cfg.shuffle_window:
            return self._make_shuffle_gen(size)
        if cfg.use_random_offsets:
            amount = max(cfg.random_amount // max(1, cfg.num_dataset_threads),
                         bs)
            if cfg.no_random_align:
                return OffsetGenRandom(self._rand_offset_algo, amount, bs,
                                       range_len=size)
            if is_write:
                # full-coverage LCG: every block exactly once (default for
                # aligned random writes, reference LocalWorker.cpp:1177)
                return OffsetGenRandomAlignedFullCoverage(
                    self._rand_offset_algo, amount, bs, range_len=size)
            return OffsetGenRandomAligned(self._rand_offset_algo, amount, bs,
                                          range_len=size)
        if cfg.do_reverse_seq_offsets:
            return OffsetGenReverseSeq(size, bs)
        return OffsetGenSequential(size, bs)

    # ------------------------------------------------------------------
    # the engine's per-file loop (phases without a device): open, blocks
    # and close, or stat, or unlink, of a chunk of files per call
    # ------------------------------------------------------------------

    _NATIVE_FILE_OPS = {BenchPhase.CREATEFILES: "write",
                        BenchPhase.READFILES: "read",
                        BenchPhase.STATFILES: "stat",
                        BenchPhase.DELETEFILES: "unlink"}

    def _can_use_native_file_loop(self, phase: BenchPhase) -> bool:
        """The whole per-file loop runs in the engine when no per-op
        Python feature is active. The engine walks each file's blocks
        forward on its sync path, so --rand, --backward, --shufflewindow
        and the asynchronous engines stay in the block loops; the
        dir-mode --opslog entry records, --statinline's fstat,
        --preallocfile, --trunctosize, --fadv and the --mmap mappings
        are made in Python. Under --direct the engine opens each file
        with O_DIRECT, under --trunc with O_TRUNC, and --nodelerr
        reaches its unlinks."""
        cfg = self.cfg
        return (self._native is not None and self._gpu is None
                and self._native_loop_blocker() is None
                and self._ops_log is None
                and phase in self._NATIVE_FILE_OPS
                and cfg.io_engine in ("auto", "sync")
                and cfg.io_depth <= 1
                and not cfg.do_stat_inline
                and not cfg.do_prealloc_file
                and not cfg.do_truncate_to_size
                and not cfg.fadvise_flags
                and not cfg.use_mmap
                and not cfg.use_random_offsets
                and not cfg.do_reverse_seq_offsets
                and not cfg.shuffle_window)

    def _run_native_file_loop(self, phase: BenchPhase) -> None:
        """Dir mode through the engine's per-file loop. A write or read
        chunk holds at most about 8192 blocks and 256 MiB, so that the
        live statistics and the stonewall stay fresh; a stat or unlink
        chunk batches paths only."""
        cfg = self.cfg
        op = self._NATIVE_FILE_OPS[phase]
        if op in ("write", "read") and cfg.file_size:
            blocks_per_file = max(
                (cfg.file_size + cfg.block_size - 1) // cfg.block_size, 1)
            chunk = max(1, min(
                self._NATIVE_CHUNK_MAX_BLOCKS // blocks_per_file,
                self._NATIVE_CHUNK_MAX_BYTES // cfg.file_size))
        else:
            chunk = self._NATIVE_CHUNK_MAX_BLOCKS
        paths: "list[str]" = []
        for dir_idx in range(cfg.num_dirs):
            base = self._bench_path_for_dir(dir_idx)
            for file_idx in range(cfg.num_files):
                paths.append(os.path.join(base, self.file_rel_path_for(
                    self.rank, dir_idx, file_idx, cfg.do_dir_sharing)))
                if len(paths) >= chunk:
                    self._native_file_chunk(phase, paths)
                    paths = []
        if paths:
            self._native_file_chunk(phase, paths)

    def _native_file_chunk(self, phase: BenchPhase, paths: "list[str]",
                           ranges: "tuple[list, list] | None" = None
                           ) -> None:
        """One engine call over `paths`; ``ranges`` (starts, lengths) are
        a custom tree's per-file byte ranges, None for dir mode's whole
        files. Under --ioretries a failed write, read or stat chunk runs
        again whole (it books its counts only when it succeeds); an
        unlink chunk never does, since a second run would miss the files
        the first one removed."""
        cfg = self.cfg
        op = self._NATIVE_FILE_OPS[phase]
        self.check_interruption_request(force=True)

        def call():
            self._native.run_file_loop(
                paths, op, self._open_flags_write() if op == "write"
                else os.O_RDONLY | direct_flag(self.cfg),
                cfg.file_size, cfg.block_size,
                self._staging_pool.slot_addrs[0],
                self._ignore_delete_errors(phase), self,
                self._native_interrupt,
                ranges=ranges if op in ("write", "read") else None,
                verify_salt=cfg.integrity_check_salt,
                block_var_pct=cfg.block_variance_pct,
                block_var_seed=self._block_var_seed(),
                rwmix_pct=cfg.rwmix_read_pct if op == "write" else 0,
                limit_read_bps=cfg.limit_read_bps,
                limit_write_bps=cfg.limit_write_bps,
                rl_state=self._native_rl_state,
                inline_readback=(cfg.do_read_inline
                                 or cfg.do_direct_verify),
                flock_mode=self._flock_mode_code())

        try:
            if op == "unlink":
                call()
            else:
                self._with_retries(call)
        except NativeVerifyError as err:
            # the chunk's global block index, back through the files'
            # ranges; a zero-length file holds no block, as in the engine
            bs = cfg.block_size
            starts, lens = ranges if ranges is not None \
                else ([0] * len(paths), [cfg.file_size] * len(paths))
            blk = err.block_idx
            for path, r_start, r_len in zip(paths, starts, lens):
                n_blocks = (r_len + bs - 1) // bs
                if blk < n_blocks:
                    raise WorkerException(
                        f"data integrity check failed at file offset "
                        f"{r_start + blk * bs + err.word_idx * 8} of "
                        f"{path}: expected {err.want:#x}, got "
                        f"{err.got:#x}{self._verify_fail_hint(err.got)}"
                    ) from None
                blk -= n_blocks
            raise WorkerException(
                f"data integrity check failed (block {err.block_idx}): "
                f"expected {err.want:#x}, got {err.got:#x}"
                f"{self._verify_fail_hint(err.got)}") from None
        except FileNotFoundError as err:
            if ranges is None and phase == BenchPhase.CREATEFILES \
                    and not cfg.run_create_dirs:
                # parity hint (reference: dirModeOpenAndPrepFile :7395);
                # the engine does not say which file, so no "Path:"
                raise WorkerException(
                    "File create/open failed. Did you forget to enable "
                    "directory creation ('--mkdirs'/-d)?") from err
            raise

    @staticmethod
    def _verify_fail_hint(got: int) -> str:
        """An all-zero word most likely comes from a region never
        written, not from corruption."""
        return " (read of an unwritten/sparse region?)" if got == 0 else ""

    # ------------------------------------------------------------------
    # custom tree mode (reference: dirModeIterateCustomDirs :2960/:3294)
    # ------------------------------------------------------------------

    def _custom_tree_iterate_files(self, phase: BenchPhase) -> None:
        """The tree file's files: sorted by path length (or shuffled with
        seed 42 under --treerand, one order on every host), split at
        --sharesize (default: the block size times the dataset threads)
        into whole files, spread over the workers by size, and shared
        files, cut into block ranges. The MKDIRS and RMDIRS phases never
        come here: they make and remove dir mode's -n dirs, so the
        tree's parent directories come from the write (as in the JAX
        package)."""
        from ..toolkits.path_store import PathStore
        cfg = self.cfg
        store = PathStore(block_size=cfg.block_size)
        store.load_files_from_file(cfg.tree_file_path,
                                   round_up_size=cfg.tree_round_up_size)
        if cfg.use_custom_tree_rand:
            store.random_shuffle(seed=42)
        else:
            store.sort_by_path_len()
        ndst = max(1, cfg.num_dataset_threads)
        rank = self.rank % ndst
        non_shared, shared = store.split_by_share_size(
            cfg.file_share_size or (cfg.block_size * ndst))

        def contiguous(elems):
            return [(e, OffsetGenSequential(e.range_len, cfg.block_size,
                                            start=e.range_start))
                    for e in elems]

        # (element, the offsets of its range) of each of the worker's files
        items = contiguous(
            non_shared.get_worker_sublist_non_shared(rank, ndst).elems)
        if cfg.use_custom_tree_round_robin:
            items += [(e, OffsetGenStrided(e.range_len, cfg.block_size,
                                           ndst, start=e.range_start))
                      for e in shared.get_worker_sublist_shared_round_robin(
                          rank, ndst).elems]
        else:
            items += contiguous(
                shared.get_worker_sublist_shared(rank, ndst).elems)
        base = cfg.paths[0]
        if phase == BenchPhase.DELETEFILES:
            # only the worker whose range starts at offset 0 deletes a
            # shared file; a worker left with nothing has no phase work
            items = [(e, gen) for e, gen in items if e.range_start == 0]
            if not items:
                self.got_phase_work = False
                return
        if self._can_use_native_file_loop(phase):
            self._run_native_tree_loop(phase, base, items)
            return
        for elem, gen in items:
            self._tree_entry(phase, os.path.join(base, elem.path), gen)

    def _tree_entry(self, phase: BenchPhase, path: str, gen) -> None:
        """One tree file through the block loops (the fused ring where
        the range is long enough, else the native block loop or the
        Python loop): create with its parent directories and write its
        range, read its range, stat or unlink; one entry latency."""
        self.check_interruption_request(force=True)
        t0 = time.perf_counter_ns()
        if phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES):
            is_write = phase == BenchPhase.CREATEFILES
            if is_write:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                fd = os.open(path, self._open_flags_write(), MKFILE_MODE)
            else:
                fd = os.open(path, os.O_RDONLY | direct_flag(self.cfg))
            try:
                if gen.num_bytes:
                    self._rw_block_sized(fd, gen, is_write=is_write)
            finally:
                os.close(fd)
        elif phase == BenchPhase.STATFILES:
            os.stat(path)
        elif phase == BenchPhase.DELETEFILES:
            try:  # shared files' other ranges were filtered out before
                os.unlink(path)
            except FileNotFoundError:
                if not self._ignore_delete_errors(phase):
                    raise
        self.entries_latency_histo.add_latency(
            (time.perf_counter_ns() - t0) // 1000)
        self.live_ops.num_entries_done += 1

    def _run_native_tree_loop(self, phase: BenchPhase, base: str,
                              items) -> None:
        """Tree files through the engine's per-file loop, each with its
        byte range, in chunks of at most 8192 files and about 256 MiB. A
        write makes the files' directories up front. A --treeroundrob
        share is not one contiguous range: it goes through the block
        loops, in its place in the worker's order."""
        if phase == BenchPhase.CREATEFILES:
            for d in {os.path.dirname(os.path.join(base, e.path))
                      for e, _ in items}:
                os.makedirs(d or ".", exist_ok=True)
        paths: "list[str]" = []
        starts: "list[int]" = []
        lens: "list[int]" = []
        chunk_bytes = 0
        for elem, gen in items:
            path = os.path.join(base, elem.path)
            if isinstance(gen, OffsetGenStrided) and phase in (
                    BenchPhase.CREATEFILES, BenchPhase.READFILES):
                if paths:
                    self._native_file_chunk(phase, paths, (starts, lens))
                    paths, starts, lens, chunk_bytes = [], [], [], 0
                self._tree_entry(phase, path, gen)
                continue
            paths.append(path)
            starts.append(elem.range_start)
            lens.append(elem.range_len)
            chunk_bytes += elem.range_len
            if len(paths) >= self._NATIVE_CHUNK_MAX_BLOCKS \
                    or chunk_bytes >= self._NATIVE_CHUNK_MAX_BYTES:
                self._native_file_chunk(phase, paths, (starts, lens))
                paths, starts, lens, chunk_bytes = [], [], [], 0
        if paths:
            self._native_file_chunk(phase, paths, (starts, lens))

    # ------------------------------------------------------------------
    # file mode (reference: fileModeIterateFilesSeq :3597,
    # fileModeIterateFilesRand :3511, fileModeDeleteFiles :3769)
    # ------------------------------------------------------------------

    def _file_mode_phase(self, phase: BenchPhase) -> None:
        cfg = self.cfg
        if phase == BenchPhase.DELETEFILES:
            # workers round-robin the given files (reference :3769)
            for i, p in enumerate(cfg.paths):
                if i % cfg.num_dataset_threads == \
                        (self.rank % cfg.num_dataset_threads):
                    try:
                        os.unlink(p)
                    except FileNotFoundError:
                        if not self._ignore_delete_errors(phase):
                            raise
                    self.live_ops.num_entries_done += 1
            return
        if phase == BenchPhase.STATFILES:
            for p in cfg.paths:
                os.stat(p)
                self.live_ops.num_entries_done += 1
            return
        is_write = (phase == BenchPhase.CREATEFILES)
        fds = self._path_fds
        gen = self._make_file_mode_offset_gen(is_write,
                                              cfg.file_size * len(fds))
        if gen is None:
            self.got_phase_work = False
            return
        if is_write and cfg.do_truncate_to_size:
            for fd in fds:
                os.ftruncate(fd, cfg.file_size)
        if not is_write:
            # --fadv before a read and after a write, as in dir mode (the
            # JAX package never applies it in file mode)
            for fd in fds:
                self._apply_fadvise(fd)
        if cfg.use_mmap:
            # one file or block device (the configuration refuses more),
            # through one mapping; the worker's share drives the same
            # generator (reference: prepareMmapVec, ProgArgs.cpp:2109)
            self._rw_block_sized_mmap(fds[0], is_write, gen=gen)
        else:
            # several files/bdevs: the worker's offsets run over one range
            # of len(paths) x file size, striped into the files
            # (reference: calcFileIdxAndOffsetStriped, LocalWorker.cpp:2084)
            self._rw_block_sized(
                fds[0], gen, is_write,
                stripe=(fds, cfg.file_size) if len(fds) > 1 else None)
        if is_write:
            for fd in fds:
                self._apply_fadvise(fd)

    def _ignore_delete_errors(self, phase: BenchPhase) -> bool:
        """A delete tolerates a missing entry under --nodelerr, or after a
        cut write (_partial_tolerance, which --nodelerr leaves unasked)."""
        return self.cfg.ignore_delete_errors or self._partial_tolerance(phase)

    def _partial_tolerance(self, phase: BenchPhase) -> bool:
        """Delete phases tolerate missing entries when an earlier write
        phase of this run was cut short (time limit, interrupt or error):
        the dataset is partial by definition. Logged once per phase."""
        if phase not in (BenchPhase.DELETEFILES, BenchPhase.DELETEDIRS):
            return False
        if not self.shared.partial_dataset:
            return False
        if not self._tolerate_note_logged:
            self._tolerate_note_logged = True
            if self.rank % max(1, self.cfg.num_threads) == 0:
                logger.log(
                    logger.LOG_NORMAL,
                    "NOTE: an earlier write phase was aborted; the delete "
                    "phase tolerates entries missing from the partial "
                    "dataset")
        return True

    def _make_file_mode_offset_gen(self, is_write: bool, total_range: int):
        """Per-worker share of the files' range: random mode divides the
        random amount; --strided interleaves the blocks, worker r taking
        every dataset-thread-th block from block r; else each dataset
        thread takes a contiguous slice, read in a --shufflewindow
        permutation, backward or forward (reference: initPhaseRWOffsetGen,
        SURVEY.md section 2.4 "Shared-file striping")."""
        cfg = self.cfg
        bs = cfg.block_size
        ndst = max(1, cfg.num_dataset_threads)
        rank = self.rank % ndst
        if cfg.use_random_offsets:
            amount = cfg.random_amount // ndst
            if amount < bs:
                return None
            if cfg.no_random_align:
                return OffsetGenRandom(self._rand_offset_algo, amount, bs,
                                       range_len=total_range)
            if is_write:
                # full-coverage LCG: every block exactly once (default for
                # aligned random writes, reference LocalWorker.cpp:1177)
                return OffsetGenRandomAlignedFullCoverage(
                    self._rand_offset_algo, amount, bs, range_len=total_range)
            return OffsetGenRandomAligned(self._rand_offset_algo, amount, bs,
                                          range_len=total_range)
        if cfg.do_strided_access:
            num_blocks = total_range // bs
            blocks_per_worker = num_blocks // ndst + \
                (1 if rank < num_blocks % ndst else 0)
            if not blocks_per_worker:
                return None
            return OffsetGenStrided(blocks_per_worker * bs, bs, ndst,
                                    rank=rank)
        slice_len = total_range // ndst
        slice_start = rank * slice_len
        if rank == ndst - 1:
            slice_len = total_range - slice_start  # last takes remainder
        if not slice_len:
            return None
        if not is_write and cfg.shuffle_window:
            # each worker permutes its own contiguous slice
            return self._make_shuffle_gen(slice_len, start=slice_start)
        if cfg.do_reverse_seq_offsets:
            return OffsetGenReverseSeq(slice_len, bs, start=slice_start)
        return OffsetGenSequential(slice_len, bs, start=slice_start)

    # ------------------------------------------------------------------
    # hot loop (reference: rwBlockSized, LocalWorker.cpp:1702-1814)
    # ------------------------------------------------------------------

    def _rw_block_sized(self, fd: int, gen, is_write: bool,
                        stripe: "tuple | None" = None) -> None:
        """offset-gen loop -> [fill buf] -> positional I/O -> [verify /
        device H2D] -> latency + counters. ``stripe=(fds, file_size)``
        maps the generator's offsets over several files: offset o is
        o % file_size in file o // file_size. A device phase takes the
        fused stream ring where it is eligible (``--gpustream auto``
        logs why not, once per phase; ``on`` raises), a phase without a
        device the native block loop, and the rest the Python loop
        below. The device batch is flushed at the end of every call, so
        in dir mode a --gpubatch span never holds blocks of two files."""
        cfg = self.cfg
        native = self._native
        native_blocker = None
        if self._gpu is not None and cfg.gpu_stream != "off":
            blocker = self._gpu_stream_blocker(native, gen)
            if blocker is None:
                if self._run_fused_gpu_stream_loop(native, fd, gen,
                                                   is_write, stripe):
                    return
                blocker = ("stream ring setup failed, or the pinned "
                           "--ioengine is not the ring's actual backend")
            if cfg.gpu_stream == "on":
                raise WorkerException(
                    f"--gpustream on: fused native-stream loop "
                    f"unavailable ({blocker})")
            self._log_stream_mode(
                f"NOTE: fused GPU stream ineligible ({blocker}); "
                f"using the Python loop")
        elif self._gpu is None and native is not None:
            native_blocker = self._native_loop_blocker()
            if native_blocker is None:
                self._run_native_block_loop(native, fd, gen, is_write,
                                            stripe)
                return
        if cfg.io_engine != "auto":
            why = ("incompatible with --gpuids" if self._gpu is not None
                   else f"incompatible with the {native_blocker}"
                   if native_blocker else "native ioengine unavailable")
            raise WorkerException(
                f"--ioengine {cfg.io_engine} only supports the native "
                f"block loop — {why}")
        balancer = self._op_balancer(is_write)
        for off, length in gen:
            # rotate buffers so pipelined transfers never race a reuse
            buf = self.rotated_staging_buf()
            do_read = (not is_write) or self._rwmix_decides_read()
            self._pace_op(do_read, length, balancer)
            if stripe is not None:
                fd, off = stripe[0][off // stripe[1]], off % stripe[1]
            if not do_read:
                self._pre_write_fill(buf, off, length)

            def one_op():
                """One positional I/O attempt; a short transfer raises
                the (transient) ShortIOError, so --ioretries covers it.
                The latency is the successful attempt's, without the
                backoff; under --flock it includes the lock wait, as in
                the engine."""
                t0 = time.perf_counter_ns()
                with (FileRangeLock(fd, cfg.use_file_locks, off, length,
                                    is_write=not do_read)
                      if cfg.use_file_locks else contextlib.nullcontext()):
                    n = (os.preadv if do_read else os.pwritev)(
                        fd, [buf[:length]], off)
                if n != length:
                    raise ShortIOError(do_read, off, n, length)
                return n, (time.perf_counter_ns() - t0) // 1000

            try:
                n, lat_usec = self._with_retries(one_op)
            except ShortIOError as err:
                raise WorkerException(str(err)) from None
            if self._ops_log is not None:
                self._ops_log.log_op("read" if do_read else "write", "",
                                     off, length)
            if do_read:
                self._post_read_actions(buf, off, length)
            elif cfg.do_read_inline or cfg.do_direct_verify:
                self._inline_read_back(fd, buf, off, length)
            self._book_op(is_write and do_read, n, lat_usec)
        if self._gpu is not None:
            # drain pipelined transfers before phase end (guarded: a copy
            # in flight on a lost GPU surfaces here)
            self._gpu_guarded(self._gpu.flush)
            self._sync_gpu_usec()

    def _op_balancer(self, is_write: bool):
        """The --rwmixthrpct byte-ratio balancer of a Python loop, or
        None: it paces the mixed write phase only (its writers and
        converted readers), so that a later READ phase does not wait for
        writer bytes that never come."""
        return self.shared.rwmix_balancer \
            if (is_write or self._rwmix_thread_reader) else None

    def _pace_op(self, do_read: bool, length: int, balancer) -> None:
        """The stop test of one op of a Python loop, with the balancer's
        and the per-thread limiter's waits. Their sleeps can be long: the
        stop is then tested before them, and between the slices of a
        limiter's sleep."""
        limiter = self._rate_limiter_read if do_read \
            else self._rate_limiter_write
        if not (limiter or balancer):
            self.check_interruption_request()
            return
        self.check_interruption_request(force=True)
        if balancer:
            if do_read:
                balancer.wait_read(length)
            else:
                balancer.wait_write(length)
            self.check_interruption_flag_only()  # woken by a stop
        if limiter:
            limiter.wait(length, stop=self.check_interruption_flag_only)

    def _book_op(self, mixed_read: bool, n: int, lat_usec: int) -> None:
        """One done op of a Python loop: its latency and counters, in the
        rwmix-read ones for a --rwmixpct read of a write phase."""
        (self.iops_latency_histo_rwmix if mixed_read
         else self.iops_latency_histo).add_latency(lat_usec)
        ops = self.live_ops_rwmix_read if mixed_read else self.live_ops
        ops.num_bytes_done += n
        ops.num_iops_done += 1
        self._num_iops_submitted += 1

    def _log_stream_mode(self, msg: str) -> None:
        """Once per phase, from the first local worker only."""
        if self._stream_mode_logged:
            return
        self._stream_mode_logged = True
        if self.rank % max(1, self.cfg.num_threads) == 0:
            logger.log(logger.LOG_NORMAL, msg)

    @staticmethod
    def _stripe_offsets(offsets: np.ndarray, stripe_size: int):
        """Vectorized stripe mapping (reference:
        calcFileIdxAndOffsetStriped, LocalWorker.cpp:2084): global block
        offsets -> (per-block file index, or None for one file; in-file
        offsets). Shared by the native block loop and the fused ring."""
        if stripe_size:
            size = np.uint64(stripe_size)
            return (offsets // size).astype(np.uint32), offsets % size
        return None, offsets

    #: bounds for one native engine call, so that interrupts stay
    #: responsive and counters progress between calls
    _NATIVE_CHUNK_MAX_BLOCKS = 8192
    _NATIVE_CHUNK_MAX_BYTES = 256 << 20

    def _native_chunk_blocks(self) -> int:
        """Under a rate limit one engine call must not span minutes of
        throttled I/O (the live statistics refresh between chunks): a
        chunk is capped at about 2 s of the tightest budget."""
        cfg = self.cfg
        max_bytes = self._NATIVE_CHUNK_MAX_BYTES
        limits = [x for x in (cfg.limit_read_bps, cfg.limit_write_bps) if x]
        if limits:
            max_bytes = min(max_bytes, 2 * min(limits))
        by_bytes = max_bytes // max(cfg.block_size, 1)
        return max(1, min(self._NATIVE_CHUNK_MAX_BLOCKS, by_bytes))

    def _python_only_feature(self) -> "str | None":
        """The per-op feature that only the Python loops serve (None =
        none): the engine's block and mmap loops lack both."""
        cfg = self.cfg
        if self.shared.rwmix_balancer is not None:
            return "--rwmixthr byte-ratio balancer"
        if cfg.block_variance_pct and cfg.block_variance_algo != "fast":
            return "non-'fast' --blockvaralgo"
        return None

    def _native_loop_blocker(self) -> "str | None":
        """Why the native block loop cannot serve a phase without a
        device (None = it can): the per-op Python features it lacks.
        Verify, the --rwmixpct split, the "fast" --blockvarpct refill,
        the rate limits and the --opslog block records run inside the
        engine (BlockMod); so do the --flock locks and the read-back of
        --readinline/--verifydirect, in its sync loop only."""
        cfg = self.cfg
        python_only = self._python_only_feature()
        if python_only is not None:
            return python_only
        sync_path = cfg.io_depth <= 1 and cfg.io_engine in ("auto", "sync")
        if not sync_path and (cfg.use_file_locks or cfg.do_read_inline
                              or cfg.do_direct_verify):
            return ("per-op locks and read-back of --flock/--readinline/"
                    "--verifydirect, which need the sync engine")
        return None

    # ------------------------------------------------------------------
    # fused storage->device streaming ring (--gpustream): the engine keeps
    # up to iodepth storage ops in flight over the staging slots (GIL
    # released across the blocking reap), Python reaps completed slots
    # and hands them straight to the device transfer ring: disk DMA in
    # the kernel overlaps the copy dispatch in Python, the cuFileRead
    # overlap of the reference's GPUDirect path (LocalWorker.cpp:
    # 2633-2749) rebuilt on io_uring/AIO + CUDA streams.
    # ------------------------------------------------------------------

    def _gpu_stream_blocker(self, native, gen) -> "str | None":
        """Why the fused native-stream loop cannot serve this phase (None
        = eligible)."""
        cfg = self.cfg
        if native is None:
            return "native ioengine unavailable"
        if cfg.bench_path_type == BenchPathType.DIR:
            # dir mode opens one stream PER FILE: for files only a couple
            # of ring-fills long, the ring setup + registration + teardown
            # would outweigh the overlap it buys
            if gen.num_bytes // max(cfg.block_size, 1) \
                    < 2 * max(len(self._io_bufs), 1):
                return "per-file stream too short to amortize ring setup"
        if not native.stream_supported():
            return "kernel lacks both io_uring and AIO"
        if self._ops_log is not None:
            return "--opslog per-op records"
        if self.shared.rwmix_balancer is not None:
            return "--rwmixthr byte-ratio balancer"
        if cfg.use_file_locks:
            return "--flock per-op locks"
        if cfg.do_read_inline or cfg.do_direct_verify:
            return "--readinline/--verifydirect inline read-back"
        if self._rate_limiter_read or self._rate_limiter_write:
            return "per-op rate limits"
        if cfg.io_engine != "auto" and \
                ENGINE_CODES[cfg.io_engine] != native.stream_backend():
            return (f"--ioengine {cfg.io_engine} pinned but the stream "
                    f"backend is {native.stream_backend_name()}")
        return None

    def _run_fused_gpu_stream_loop(self, native, fd: int, gen,
                                   is_write: bool, stripe) -> bool:
        """Drive the whole block loop through the engine's streaming ring.
        Returns False when the ring cannot be opened, or runs on another
        backend than a pinned --ioengine (the caller logs the fallback
        and runs the Python loop). Accounting goes through
        _account_chunk per drained chunk; the dispatch-vs-copy split
        rides the TransferPipeline counters as in the Python loop."""
        cfg = self.cfg
        fds, stripe_size = (list(stripe[0]), stripe[1]) if stripe \
            else ([fd], 0)
        slot_addrs = self._staging_pool.slot_addrs
        try:
            stream = native.open_stream(fds, slot_addrs,
                                        max(cfg.block_size, 1))
        except NativeStreamError:
            return False
        if cfg.io_engine != "auto" and \
                ENGINE_CODES[cfg.io_engine] != stream.backend:
            # the open may have fallen back (e.g. the ring mmaps failed at
            # this slot count): a pin holds against the ACTUAL backend
            stream.close()
            return False
        self._log_stream_mode(
            f"fused GPU stream engaged (backend={stream.backend_name}, "
            f"slots={len(slot_addrs)}, "
            f"fixed_buffers={int(stream.fixed_buffers)})")
        # slot-reuse discipline: a slot is free, in the engine ring
        # (slot_op), or held back after its H2D until the transfer ring
        # has drained the copy that reads it (holdback_depth, fixed for
        # the phase); only a free slot takes a write's D2H pre-fill
        hold = self._gpu.holdback_depth()
        free = deque(range(len(slot_addrs)))
        held: "deque[int]" = deque()
        # slot -> (index in chunk, fd index, offset, length, is a read,
        # attempts): each op keeps its own direction
        slot_op: "dict[int, tuple[int, int, int, int, bool, int]]" = {}
        chunk = self._native_chunk_blocks()
        try:
            if cfg.io_timeout_secs:
                # --iotimeout: a hung op surfaces as -ETIMEDOUT with its
                # slot re-armed instead of wedging the reap loop
                stream.set_timeout(cfg.io_timeout_secs * 1_000_000)
            fault_spec = os.environ.get("ELBENCHO_TPU_IO_FAULT")
            if fault_spec:
                # test-only fault injection; the configuration refuses
                # the knob outside a test harness
                stream.set_fault_from_spec(fault_spec)
            while True:
                batch = gen.next_batch(chunk)
                if batch is None:
                    break
                self._fused_stream_chunk(stream, batch, is_write,
                                         stripe_size, free, held, slot_op,
                                         hold)
        finally:
            # close() drains outstanding kernel DMA first; a failed drain
            # means the kernel still owns ops that target the slots, so
            # cleanup() keeps them mapped until process exit
            if stream.close() != 0:
                self._stream_drain_failed = True
                logger.log_error(
                    f"worker {self.rank}: stream ring drain failed; "
                    f"keeping I/O buffers mapped until process exit")
        # drain pipelined transfers before phase end, guarded as every
        # other call into the device
        self._gpu_guarded(self._gpu.flush)
        self._sync_gpu_usec()
        return True

    def _fused_stream_chunk(self, stream, batch, is_write: bool,
                            stripe_size: int, free: deque, held: deque,
                            slot_op: dict, hold: int) -> None:
        """One bounded chunk of the fused loop: submit every op (reaping
        for slots as needed), then drain to a chunk barrier so that the
        array-based accounting is exact; an interrupt books the
        completed-prefix estimate before it propagates. A failed op is
        retried on its slot under --ioretries. In a --rwmixpct write
        phase the per-op flags pick the reads: a read is submitted with
        no pre-fill and copied to the device when reaped, as in a READ
        phase."""
        cfg = self.cfg
        ctx = self._gpu
        offsets, lengths = batch
        n = len(offsets)
        fd_idx, real_offs = self._stripe_offsets(offsets, stripe_size)
        flags = self._rwmix_read_flags(n) if is_write else None
        total = int(lengths.sum())
        lat_arr = (ctypes.c_uint64 * n)()
        reaped_bytes = 0

        def retry_or_raise(slot: int, op: tuple, err: OSError) -> None:
            """--ioretries for a failed ring op: backoff, then submit the
            same op on the same slot again, in its own direction (the
            slot still holds a write's source; a read retries into it).
            Its attempts are counted per op in slot_op: the ring
            interleaves many ops, and the retrier's shared consecutive
            count would mix them up. Raises the original error when
            retries are off, spent or do not apply."""
            i, fdi, r_off, length, rd, attempts = op
            retrier = self._io_retrier
            if retrier is None or not retrier.should_retry(
                    err, path=self._retry_path_hint(), attempt=attempts):
                if isinstance(err, ShortIOError):
                    raise WorkerException(str(err)) from None
                raise err
            try:
                retrier.backoff(attempt=attempts)
            except IoRetryBudgetExhausted:
                raise err from None
            slot_op[slot] = (i, fdi, r_off, length, rd, attempts + 1)
            stream.resubmit(slot, fdi, r_off, length, not rd)

        def reap_some(min_complete: int) -> None:
            nonlocal reaped_bytes
            events = stream.reap(min_complete, 1000, self._native_interrupt)
            if not events:
                # timeout or interrupt: surface the interrupt, else go on
                self.check_interruption_request(force=True)
                if cfg.io_timeout_secs and slot_op:
                    # kernel AIO's io_cancel is best effort: an op far
                    # past its deadline with no completion in sight ends
                    # the phase instead of spinning forever (the ring's
                    # close() then keeps the slots mapped)
                    age = stream.oldest_age_usec()
                    limit = cfg.io_timeout_secs * 2_000_000 + 5_000_000
                    if age > limit:
                        raise WorkerException(
                            f"storage op stuck for {age // 1_000_000}s — "
                            f"past --iotimeout {cfg.io_timeout_secs}s and "
                            f"uncancellable on the {stream.backend_name} "
                            f"backend; aborting the phase")
                return
            for slot, lat, res in events:
                op = slot_op.pop(slot)
                i, _fdi, r_off, length, rd, _attempts = op
                if rd:
                    # one completed read's copy and verify can take tens
                    # of ms: a stop takes effect before the next one
                    self.check_interruption_flag_only()
                if res < 0:
                    if -res == errno.ETIMEDOUT:
                        # --iotimeout cancelled a hung op: transient, so
                        # --ioretries may drive it again
                        self.io_timeouts += 1
                    retry_or_raise(slot, op, OSError(-res, os.strerror(-res)))
                    continue
                if res != length:
                    retry_or_raise(slot, op, ShortIOError(
                        rd, r_off, res, length))
                    continue
                lat_arr[i] = lat
                reaped_bytes += res
                ctx.stream_fused_ops += 1
                if not rd:
                    free.append(slot)
                    continue
                # host->device copy + verify (host memcmp or on-device),
                # the Python loop's post-read hook
                self._post_read_actions(self._io_bufs[slot], r_off, length)
                held.append(slot)
                while len(held) > hold:
                    free.append(held.popleft())

        try:
            for i in range(n):
                self.check_interruption_request()
                while not free:
                    if slot_op:
                        reap_some(0)  # harvest anything already done
                        if free:
                            break
                    if held:
                        # release the oldest ingested slot by draining its
                        # copy: after drain_to(len(held)-1) the ring's FIFO
                        # window covers only the newer held slots. Without
                        # this the holdback would cap the engine ring at
                        # n_slots-(depth-1) ops under --gpudirect. Guarded:
                        # the wait is where a lost GPU may surface first.
                        self._gpu_guarded(ctx.drain_to, len(held) - 1)
                        free.append(held.popleft())
                    else:
                        reap_some(1)
                slot = free.popleft()
                length = int(lengths[i])
                r_off = int(real_offs[i])
                rd = bool(flags[i]) if flags is not None else not is_write
                if not rd:
                    # the block originates in device memory: D2H into the
                    # slot, complete before the write is submitted
                    self._pre_write_fill(self._io_bufs[slot], r_off, length)
                fdi = int(fd_idx[i]) if fd_idx is not None else 0
                slot_op[slot] = (i, fdi, r_off, length, rd, 0)
                stream.submit(slot, fdi, r_off, length, not rd)
            while slot_op:  # chunk barrier: exact accounting below
                reap_some(1)
        except WorkerInterruptedException:
            _account_chunk(self, lat_arr, lengths, n, reaped_bytes, total,
                           flags)
            raise
        _account_chunk(self, lat_arr, lengths, n, reaped_bytes, total, flags)

    # ------------------------------------------------------------------
    # native block loop (phases without a device): the whole loop, host
    # --verify included, in the engine, chunk by chunk
    # ------------------------------------------------------------------

    def _run_native_block_loop(self, native, fd: int, gen, is_write: bool,
                               stripe) -> None:
        """Counters and latencies are booked per chunk; the engine polls
        the interrupt flag within a chunk, and the worker checks it
        between chunks."""
        cfg = self.cfg
        fds, stripe_size = (list(stripe[0]), stripe[1]) if stripe \
            else ([fd], 0)
        buf_addr = self._staging_pool.slot_addrs[0]
        chunk = self._native_chunk_blocks()
        while True:
            batch = gen.next_batch(chunk)
            if batch is None:
                return
            self.check_interruption_request(force=True)
            fd_idx, offsets = self._stripe_offsets(batch[0], stripe_size)
            # the --rwmixpct split, vectorized (reference:
            # (workerRank + numIOPSSubmitted) % 100 < pct, :1741-1742)
            flags = self._rwmix_read_flags(len(offsets)) if is_write \
                else None

            def call(fd_idx=fd_idx, offsets=offsets, lengths=batch[1],
                     flags=flags):
                native.run_block_loop(
                    fds, fd_idx, offsets, lengths, is_write, buf_addr,
                    cfg.io_depth, self, self._native_interrupt,
                    engine=cfg.io_engine,
                    verify_salt=cfg.integrity_check_salt, op_is_read=flags,
                    block_var_pct=cfg.block_variance_pct,
                    block_var_seed=self._block_var_seed(),
                    limit_read_bps=cfg.limit_read_bps,
                    limit_write_bps=cfg.limit_write_bps,
                    rl_state=self._native_rl_state,
                    inline_readback=(cfg.do_read_inline
                                     or cfg.do_direct_verify),
                    flock_mode=self._flock_mode_code(),
                    ops_fd=(self._ops_log.fd if self._ops_log is not None
                            else -1),
                    ops_lock=cfg.ops_log_lock)

            try:
                # --ioretries: a transient chunk failure runs the whole
                # chunk again (a chunk books its counts only when it
                # succeeds, so nothing counts twice)
                self._with_retries(call)
            except NativeVerifyError as err:
                raise self._chunk_verify_failure(offsets, err) from None

    def _chunk_verify_failure(self, offsets: np.ndarray,
                              err: NativeVerifyError) -> WorkerException:
        """The failure of an engine chunk's verify, at its file offset."""
        file_off = int(offsets[err.block_idx]) + err.word_idx * 8
        return WorkerException(
            f"data integrity check failed at file offset {file_off}: "
            f"expected {err.want:#x}, got {err.got:#x}"
            f"{self._verify_fail_hint(err.got)}")

    # ------------------------------------------------------------------
    # memory-mapped I/O (--mmap; reference: the mmap wrappers,
    # LocalWorker.cpp:2534+): a memcpy per block between the file's
    # mapping and a staging slot
    # ------------------------------------------------------------------

    def _rw_block_sized_mmap(self, fd: int, is_write: bool,
                             gen=None) -> None:
        """The block loop over a mapping of the file's first -s bytes,
        advised with --madv. A write first truncates a regular file to
        -s (a block device keeps its size) and maps it read-write.
        Without a device the engine's mmap loop serves the phase, unless
        a feature only Python serves needs it (_python_only_feature);
        else the Python loop below does: a read goes mapping ->
        slot -> device copy (and --gpuverify), a write device copy ->
        slot -> mapping. The mmap loops take no --flock lock, --opslog
        block record, --readinline read-back or --ioretries retry, as in
        the JAX package (ROADMAP C)."""
        cfg = self.cfg
        if is_write and stat_mod.S_ISREG(os.fstat(fd).st_mode):
            os.ftruncate(fd, cfg.file_size)
        prot = mmap.PROT_READ | (mmap.PROT_WRITE if is_write else 0)
        mapped = mmap.mmap(fd, cfg.file_size, prot=prot)
        try:
            self._apply_madvise(mapped)
            if gen is None:
                gen = self._make_offset_gen_for_file(is_write)
            if self._gpu is None and self._native is not None \
                    and self._python_only_feature() is None:
                self._run_native_mmap_loop(mapped, gen, is_write)
            else:
                self._run_python_mmap_loop(mapped, gen, is_write)
        finally:
            mapped.close()

    def _run_python_mmap_loop(self, mapped: mmap.mmap, gen,
                              is_write: bool) -> None:
        """The --mmap loop in Python, with the Python block loop's
        --rwmixpct split, limits and balancer (the JAX package's takes
        none of them: a fault not kept), a stop test every op and the
        guarded flush of the device's copies at the end."""
        balancer = self._op_balancer(is_write)
        with memoryview(mapped) as whole:
            for off, length in gen:
                buf = self.rotated_staging_buf()
                do_read = (not is_write) or self._rwmix_decides_read()
                self._pace_op(do_read, length, balancer)
                t0 = time.perf_counter_ns()
                if do_read:
                    buf[:length] = whole[off:off + length]
                else:
                    # the fill is timed with the copy, as in the JAX package
                    self._pre_write_fill(buf, off, length)
                    whole[off:off + length] = buf[:length]
                lat_usec = (time.perf_counter_ns() - t0) // 1000
                if do_read:
                    self._post_read_actions(buf, off, length)
                self._book_op(is_write and do_read, length, lat_usec)
        if self._gpu is not None:
            self._gpu_guarded(self._gpu.flush)
            self._sync_gpu_usec()

    def _run_native_mmap_loop(self, mapped: mmap.mmap, gen,
                              is_write: bool) -> None:
        """The engine's mmap loop, chunk by chunk, with the native block
        loop's block modifiers and accounting. A read of a region never
        written copies zeros (a mapping has no short read), which the
        verify failure's hint names."""
        cfg = self.cfg
        # np.frombuffer serves a read-only mapping too; the address stays
        # valid while the mapping is open
        map_addr = np.frombuffer(mapped, dtype=np.uint8).ctypes.data
        buf_addr = self._staging_pool.slot_addrs[0]
        chunk = self._native_chunk_blocks()
        while True:
            batch = gen.next_batch(chunk)
            if batch is None:
                return
            self.check_interruption_request(force=True)
            offsets, lengths = batch
            try:
                self._native.run_mmap_loop(
                    map_addr, offsets, lengths, is_write, buf_addr, self,
                    self._native_interrupt,
                    op_is_read=self._rwmix_read_flags(len(offsets))
                    if is_write else None,
                    verify_salt=cfg.integrity_check_salt,
                    block_var_pct=cfg.block_variance_pct,
                    block_var_seed=self._block_var_seed(),
                    limit_read_bps=cfg.limit_read_bps,
                    limit_write_bps=cfg.limit_write_bps,
                    rl_state=self._native_rl_state)
            except NativeVerifyError as err:
                raise self._chunk_verify_failure(offsets, err) from None

    #: --fadv names
    _FADVISE = {"seq": os.POSIX_FADV_SEQUENTIAL,
                "rand": os.POSIX_FADV_RANDOM,
                "willneed": os.POSIX_FADV_WILLNEED,
                "dontneed": os.POSIX_FADV_DONTNEED,
                "noreuse": os.POSIX_FADV_NOREUSE}

    def _apply_madvise(self, mapped: mmap.mmap) -> None:
        """--madv on a file's mapping, flag by flag; a refused advice
        fails the phase."""
        for advice in self._madvise:
            mapped.madvise(advice)

    def _apply_fadvise(self, fd: int) -> None:
        """--fadv on a whole file, flag by flag; a refused advice fails
        the phase."""
        for name in parse_flag_list(self.cfg.fadvise_flags):
            if name not in self._FADVISE:
                raise WorkerException(f"unknown fadvise flag: {name}")
            os.posix_fadvise(fd, 0, 0, self._FADVISE[name])

    # ------------------------------------------------------------------
    # data-plane fault tolerance (--ioretries, --iotimeout, --gpufallback;
    # workers/io_errors.py and the failover of cuda/device.py)
    # ------------------------------------------------------------------

    def _retry_path_hint(self) -> str:
        """The path the retry classifier's network-filesystem test looks
        at (EIO is transient on NFS/FUSE/parallel file systems, permanent
        on local media)."""
        paths = self.cfg.paths
        return paths[0] if paths else ""

    def _with_retries(self, op):
        """op() under --ioretries: one storage op, or one native engine
        chunk."""
        if self._io_retrier is None:
            return op()
        return self._io_retrier.run(op, path=self._retry_path_hint())

    def _gpu_guarded(self, fn, *args, **kwargs):
        """Run one call into the device context with --gpufallback: an
        error that is not a lost GPU (a --gpubudget breach, a logic
        error, an integrity error) propagates untouched."""
        from ..cuda.device import is_device_loss_error
        attempts = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except WorkerInterruptedException:
                raise
            except Exception as err:  # noqa: BLE001 - classified below
                if self._gpu is None or not is_device_loss_error(err):
                    raise
                attempts += 1
                if attempts > len(self.cfg.gpu_ids) + 1:
                    raise  # every GPU, and host staging, failed
                self._gpu_handle_device_loss(err)

    def _gpu_handle_device_loss(self, err: Exception) -> None:
        """One lost GPU: poison it for every worker, then end the phase
        (abort, the default), fail over to a surviving --gpuids GPU
        (chip) or degrade to host-memory staging (host)."""
        cfg = self.cfg
        ctx = self._gpu
        with self.shared.cond:
            self.shared.poisoned_gpu_ids.add(ctx.chip_id)
        if cfg.gpu_fallback == "abort":
            from ..cuda.device import GpuDeviceLostError
            # the teardown then makes no call into the lost GPU
            ctx._poison_device_state()
            raise WorkerException(
                str(GpuDeviceLostError(ctx.chip_id, err))) from err
        cause = str(err).splitlines()[0] if str(err) else ""
        logger.log_error(f"worker {self.rank}: GPU {ctx.chip_id} lost "
                         f"mid-phase ({type(err).__name__}: {cause})")
        if cfg.gpu_fallback == "chip":
            with self.shared.cond:
                survivors = [c for c in cfg.gpu_ids
                             if c not in self.shared.poisoned_gpu_ids]
            if survivors:
                ctx.failover_to_chip(survivors[self.rank % len(survivors)])
                return
            logger.log_error(
                "--gpufallback chip: no surviving --gpuids GPU left; "
                "degrading to host-memory staging")
        ctx.failover_to_host()

    def rotated_staging_buf(self) -> memoryview:
        """The staging slot serving the next op under the worker's
        rotation discipline: the slot of the Python loops and of
        --gpubench, so that pipelined copies never race a reuse. The JAX
        package also books the hand-out in its pool's reuse counters,
        which the port's pool does not keep."""
        return self._io_bufs[self._num_iops_submitted % len(self._io_bufs)]

    def _sync_gpu_usec(self) -> None:
        """Mirror the context's split timing counters into this worker's
        phase stats."""
        self.gpu_dispatch_usec = self._gpu.dispatch_usec
        self.gpu_transfer_usec = self._gpu.transfer_usec

    # -- the --rwmixpct split and the --blockvarpct seed ---------------------

    def _rwmix_decides_read(self) -> bool:
        """Per-op modulo split (reference: (workerRank + numIOPSSubmitted)
        % 100 < rwMixReadPercent, LocalWorker.cpp:1741-1742)."""
        pct = self.cfg.rwmix_read_pct
        return bool(pct) and \
            (self.rank + self._num_iops_submitted) % 100 < pct

    def _rwmix_read_flags(self, n: int) -> "np.ndarray | None":
        """The read flags of the next n ops of a write phase (uint8), the
        vectorized _rwmix_decides_read; None without --rwmixpct."""
        pct = self.cfg.rwmix_read_pct
        if not pct:
            return None
        base = np.uint64(self.rank + self._num_iops_submitted)
        return (((base + np.arange(n, dtype=np.uint64)) % np.uint64(100))
                < np.uint64(pct)).astype(np.uint8)

    def _block_var_seed(self) -> int:
        """The engine's --blockvarpct refill seed, per worker and chunk."""
        return (self.rank << 32) ^ self._num_iops_submitted

    def _flock_mode_code(self) -> int:
        """--flock mode for the engine: 0 none, 1 range, 2 full."""
        return {"": 0, "range": 1, "full": 2}[self.cfg.use_file_locks]

    # -- write-side block content -------------------------------------------

    def _pre_write_fill(self, buf: memoryview, offset: int,
                        length: int) -> None:
        cfg = self.cfg
        if self._gpu is not None:
            # block content originates in device memory and is copied
            # device->host into the write buffer (replaces cudaMemcpy D2H
            # pre-write, reference LocalWorker.cpp:2437-2490); with
            # --verify the pattern itself is generated on the device.
            # Guarded: a lost GPU here fails over under --gpufallback.
            self._gpu_guarded(self._gpu.device_to_host, buf, length,
                              verify_salt=cfg.integrity_check_salt,
                              file_offset=offset)
            self._sync_gpu_usec()
            self.gpu_transfer_bytes += length
            return
        if cfg.integrity_check_salt:
            fill_verify_pattern_host(buf, offset, length,
                                     cfg.integrity_check_salt)
        elif cfg.block_variance_pct:
            # refill the first pct % of the slot (reference:
            # preWriteBufRandRefill, LocalWorker.cpp:2242); the rest keeps
            # the slot's pre-fill
            refill = (length * cfg.block_variance_pct) // 100
            if refill:
                buf[:refill] = self._block_var_algo.fill_buffer(refill)

    def _verify_read_buf(self, buf: memoryview, offset: int,
                         length: int) -> None:
        """memcmp + exact mismatch offset report (reference:
        postReadIntegrityCheckVerifyBuf, LocalWorker.cpp:2170)."""
        salt = self.cfg.integrity_check_salt
        n_words = length // 8
        got = np.frombuffer(buf[:n_words * 8], dtype=np.uint64)
        with np.errstate(over="ignore"):
            want = (np.arange(n_words, dtype=np.uint64) * np.uint64(8)
                    + np.uint64(offset) + np.uint64(salt))
        bad = np.nonzero(got != want)[0]
        if bad.size:
            first = int(bad[0])
            raise WorkerException(
                f"data integrity check failed at file offset "
                f"{offset + first * 8}: expected {int(want[first]):#x}, "
                f"got {int(got[first]):#x}")

    def _inline_read_back(self, fd: int, buf: memoryview, offset: int,
                          length: int) -> None:
        """--readinline/--verifydirect: read the block straight back into
        its slot after the write, and verify it on the host under
        --verify (reference: pwriteAndReadWrapper, LocalWorker.cpp:2566).
        Neither counted nor timed, as in the engine. With a device the
        slot was the D2H copy's destination, complete before the write
        was issued, so nothing else reads or writes it here."""
        n = os.preadv(fd, [buf[:length]], offset)
        if n != length:
            raise WorkerException(f"short inline read-back at {offset}")
        if self.cfg.integrity_check_salt:
            self._verify_read_buf(buf, offset, length)

    # -- read-side block actions --------------------------------------------

    def _post_read_actions(self, buf: memoryview, offset: int,
                           length: int) -> None:
        cfg = self.cfg
        if self._gpu is not None:
            # host->device copy of the read block (replaces cudaMemcpy H2D
            # post-read / cuFile read, reference LocalWorker.cpp:2633-2749),
            # guarded for --gpufallback
            self._gpu_guarded(self._gpu.host_to_device, buf, length,
                              verify_salt=cfg.integrity_check_salt
                              if cfg.do_gpu_verify else 0,
                              file_offset=offset)
            self._sync_gpu_usec()
            self.gpu_transfer_bytes += length
            # a failover to host staging clears verify_on_device: the
            # block is then verified on the host below
            if cfg.do_gpu_verify and cfg.integrity_check_salt \
                    and self._gpu.verify_on_device:
                return  # verified on the device by the CUDA kernel
        if cfg.integrity_check_salt:
            self._verify_read_buf(buf, offset, length)
