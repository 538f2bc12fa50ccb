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

The engine's per-file loop, custom trees and the other storage back ends
are later slices.

The GPU data path replaces upstream elbencho's CUDA staging
(allocGPUIOBuffer :1427-1537, cudaMemcpy wrappers :2437-2490): workers
map to GPUs by ``rank % len(gpu_ids)`` and move blocks through a
``CudaWorkerContext`` (elbencho_tpu_torch/cuda/device.py).
"""

from __future__ import annotations

import ctypes
import os
import time
from collections import deque

import numpy as np

from ..phases import GPU_PROFILE_PHASES, BenchPathType, BenchPhase
from ..toolkits import logger
from ..toolkits.offset_gen import (OffsetGenRandomAligned,
                                   OffsetGenRandomAlignedFullCoverage,
                                   OffsetGenSequential)
from ..toolkits.random_algos import RandAlgoGoldenPrime
from ..utils.native import (ENGINE_CODES, NativeStreamError,
                            NativeVerifyError, _account_chunk,
                            get_native_engine)
from .base import Worker
from .shared import WorkerException, WorkerInterruptedException

MKFILE_MODE = 0o644  # reference: MKFILE_MODE, Common.h:96
MKDIR_MODE = 0o755


class LocalWorker(Worker):
    def __init__(self, shared, rank: int):
        super().__init__(shared, rank)
        self.cfg = shared.config
        # io_depth staging slots so pipelined device transfers never see a
        # block overwritten while in flight (reference: allocIOBuffer x
        # iodepth, :1386)
        self._staging_pool = None
        self._io_bufs: "list[memoryview]" = []
        self._rand_offset_algo = None
        self._gpu = None  # CudaWorkerContext when --gpuids given
        self._native = None  # the native engine, where it can be built
        self._num_iops_submitted = 0
        self._stream_mode_logged = False  # once-per-phase fused-loop note
        self._stream_drain_failed = False  # aborted ring drain: leak bufs

    def reset_stats(self) -> None:
        super().reset_stats()
        self._stream_mode_logged = False
        if self._gpu is not None:
            # path-audit counters are per-phase, like gpu_transfer_bytes
            self._gpu.reset_path_counters()

    # ------------------------------------------------------------------
    # preparation (reference: preparePhase, LocalWorker.cpp:424)
    # ------------------------------------------------------------------

    def prepare(self) -> None:
        cfg = self.cfg
        from ..utils.staging_pool import StagingPool
        self._staging_pool = StagingPool(
            max(cfg.io_depth, 1), max(cfg.block_size, 1),
            fill_algo=RandAlgoGoldenPrime(seed=self.rank + 1))
        self._io_bufs = self._staging_pool.views
        self._native = get_native_engine()  # build outside the timed phase
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
            if cfg.run_read_files or bench in ("h2d", "both"):
                self._gpu.warmup_transfer()
            if cfg.gpu_profile_dir:
                self._gpu.profile_warmup()  # its buffers, outside phases
        self._rand_offset_algo = RandAlgoGoldenPrime(seed=None)

    def cleanup(self) -> None:
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
                    self._num_iops_submitted = 0
                    self._dispatch_phase(phase)
                    self.finish_phase_stats()
                    self.shared.inc_num_workers_done()
                except WorkerInterruptedException:
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
        the JAX package's _dispatch_phase_inner)."""
        if phase == BenchPhase.TPUBENCH:
            from .gpubench import run_gpubench_phase
            run_gpubench_phase(self)
        elif phase == BenchPhase.TPUSLICE:
            from .gpuslice import run_gpu_slice_phase
            run_gpu_slice_phase(self)
        elif phase in (BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS,
                       BenchPhase.STATDIRS):
            self._dir_mode_iterate_dirs(phase)
        elif self.cfg.bench_path_type == BenchPathType.DIR:
            self._dir_mode_iterate_files(phase)
        else:
            self._file_mode_phase(phase)

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
            t0 = time.perf_counter_ns()
            if phase == BenchPhase.CREATEDIRS:
                os.makedirs(path, MKDIR_MODE, exist_ok=True)
            elif phase == BenchPhase.DELETEDIRS:
                os.rmdir(path)
                parent = os.path.dirname(path)
                if os.path.basename(parent).startswith("r"):
                    try:
                        os.rmdir(parent)  # remove empty rank dir
                    except OSError:
                        pass
            else:  # STATDIRS
                os.stat(path)
            self.entries_latency_histo.add_latency(
                (time.perf_counter_ns() - t0) // 1000)
            self.live_ops.num_entries_done += 1

    def _dir_mode_iterate_files(self, phase: BenchPhase) -> None:
        """open -> block loop -> close per file; entry latency histogram
        per file (reference: dirModeIterateFiles :3055-3281,
        unlinkat/fstatat for del/stat :3237-3249)."""
        cfg = self.cfg
        for dir_idx in range(cfg.num_dirs):
            base = self._bench_path_for_dir(dir_idx)
            for file_idx in range(cfg.num_files):
                self.check_interruption_request(force=True)
                path = os.path.join(base, self.file_rel_path_for(
                    self.rank, dir_idx, file_idx, cfg.do_dir_sharing))
                t0 = time.perf_counter_ns()
                if phase == BenchPhase.CREATEFILES:
                    self._write_one_file(path)
                elif phase == BenchPhase.READFILES:
                    self._read_one_file(path)
                elif phase == BenchPhase.STATFILES:
                    os.stat(path)
                elif phase == BenchPhase.DELETEFILES:
                    os.unlink(path)
                self.entries_latency_histo.add_latency(
                    (time.perf_counter_ns() - t0) // 1000)
                self.live_ops.num_entries_done += 1

    def _write_one_file(self, path: str) -> None:
        cfg = self.cfg
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, MKFILE_MODE)
        except FileNotFoundError as err:
            if not cfg.run_create_dirs:
                # parity hint (reference: dirModeOpenAndPrepFile :7395)
                raise WorkerException(
                    f"File create/open failed. Did you forget to enable "
                    f"directory creation ('--mkdirs'/-d)? Path: {path}"
                ) from err
            raise
        try:
            if cfg.file_size:
                self._rw_block_sized(
                    fd, self._make_offset_gen_for_file(is_write=True),
                    is_write=True)
        finally:
            os.close(fd)

    def _read_one_file(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            if self.cfg.file_size:
                self._rw_block_sized(
                    fd, self._make_offset_gen_for_file(is_write=False),
                    is_write=False)
        finally:
            os.close(fd)

    def _make_offset_gen_for_file(self, is_write: bool):
        """Offsets within one dir-mode file. Random mode reads (or, for
        writes, covers) the random amount divided by the dataset threads,
        at least one block, per file: the reference's per-file split
        (reference: initPhaseRWOffsetGen :1141-1186)."""
        cfg = self.cfg
        size, bs = cfg.file_size, cfg.block_size
        if cfg.use_random_offsets:
            amount = max(cfg.random_amount // max(1, cfg.num_dataset_threads),
                         bs)
            if is_write:
                # full-coverage LCG: every block exactly once (default for
                # aligned random writes, reference LocalWorker.cpp:1177)
                return OffsetGenRandomAlignedFullCoverage(
                    self._rand_offset_algo, amount, bs, range_len=size)
            return OffsetGenRandomAligned(self._rand_offset_algo, amount, bs,
                                          range_len=size)
        return OffsetGenSequential(size, bs)

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
                    os.unlink(p)
                    self.live_ops.num_entries_done += 1
            return
        if phase == BenchPhase.STATFILES:
            for p in cfg.paths:
                os.stat(p)
                self.live_ops.num_entries_done += 1
            return
        is_write = (phase == BenchPhase.CREATEFILES)
        fds = cfg.bench_path_fds
        gen = self._make_file_mode_offset_gen(is_write,
                                              cfg.file_size * len(fds))
        if gen is None:
            self.got_phase_work = False
            return
        # several files/bdevs: the worker's offsets run over one range of
        # len(paths) x file size, striped into the files (reference:
        # calcFileIdxAndOffsetStriped, LocalWorker.cpp:2084)
        self._rw_block_sized(
            fds[0], gen, is_write,
            stripe=(fds, cfg.file_size) if len(fds) > 1 else None)

    def _make_file_mode_offset_gen(self, is_write: bool, total_range: int):
        """Per-worker share of the file: seq mode slices a contiguous range
        per dataset thread; rand mode divides the random amount."""
        cfg = self.cfg
        bs = cfg.block_size
        ndst = max(1, cfg.num_dataset_threads)
        rank = self.rank % ndst
        if cfg.use_random_offsets:
            amount = cfg.random_amount // ndst
            if amount < bs:
                return None
            if is_write:
                # full-coverage LCG: every block exactly once (default for
                # aligned random writes, reference LocalWorker.cpp:1177)
                return OffsetGenRandomAlignedFullCoverage(
                    self._rand_offset_algo, amount, bs, range_len=total_range)
            return OffsetGenRandomAligned(self._rand_offset_algo, amount, bs,
                                          range_len=total_range)
        slice_len = total_range // ndst
        slice_start = rank * slice_len
        if rank == ndst - 1:
            slice_len = total_range - slice_start  # last takes remainder
        if not slice_len:
            return None
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
            self._run_native_block_loop(native, fd, gen, is_write, stripe)
            return
        if cfg.io_engine != "auto":
            raise WorkerException(
                f"--ioengine {cfg.io_engine} only supports the native "
                f"block loop — " + ("incompatible with --gpuids"
                                    if self._gpu is not None
                                    else "native ioengine unavailable"))
        num_bufs = len(self._io_bufs)
        for off, length in gen:
            # rotate buffers so pipelined transfers never race a reuse
            buf = self._io_bufs[self._num_iops_submitted % num_bufs]
            self.check_interruption_request()
            if stripe is not None:
                fd, off = stripe[0][off // stripe[1]], off % stripe[1]
            if is_write:
                self._pre_write_fill(buf, off, length)
            t0 = time.perf_counter_ns()
            if is_write:
                n = os.pwritev(fd, [buf[:length]], off)
            else:
                n = os.preadv(fd, [buf[:length]], off)
            if n != length:
                raise WorkerException(
                    f"short {'write' if is_write else 'read'} at offset "
                    f"{off}: {n} != {length}")
            lat_usec = (time.perf_counter_ns() - t0) // 1000
            if not is_write:
                self._post_read_actions(buf, off, length)
            self.iops_latency_histo.add_latency(lat_usec)
            self.live_ops.num_bytes_done += n
            self.live_ops.num_iops_done += 1
            self._num_iops_submitted += 1
        if self._gpu is not None:
            self._gpu.flush()  # drain pipelined transfers before phase end
            self._sync_gpu_usec()

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
        by_bytes = self._NATIVE_CHUNK_MAX_BYTES // max(self.cfg.block_size, 1)
        return max(1, min(self._NATIVE_CHUNK_MAX_BLOCKS, by_bytes))

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
        # the phase)
        hold = self._gpu.holdback_depth()
        free = deque(range(len(slot_addrs)))
        held: "deque[int]" = deque()
        slot_op: "dict[int, tuple[int, int, int]]" = {}
        chunk = self._native_chunk_blocks()
        try:
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
        self._gpu.flush()  # drain pipelined transfers before phase end
        self._sync_gpu_usec()
        return True

    def _fused_stream_chunk(self, stream, batch, is_write: bool,
                            stripe_size: int, free: deque, held: deque,
                            slot_op: dict, hold: int) -> None:
        """One bounded chunk of the fused loop: submit every op (reaping
        for slots as needed), then drain to a chunk barrier so that the
        array-based accounting is exact; an interrupt books the
        completed-prefix estimate before it propagates."""
        ctx = self._gpu
        offsets, lengths = batch
        n = len(offsets)
        fd_idx, real_offs = self._stripe_offsets(offsets, stripe_size)
        total = int(lengths.sum())
        lat_arr = (ctypes.c_uint64 * n)()
        reaped_bytes = 0

        def reap_some(min_complete: int) -> None:
            nonlocal reaped_bytes
            events = stream.reap(min_complete, 1000, self._native_interrupt)
            if not events:
                # timeout or interrupt: surface the interrupt, else go on
                self.check_interruption_request(force=True)
                return
            for slot, lat, res in events:
                i, r_off, length = slot_op.pop(slot)
                if res < 0:
                    raise OSError(-res, os.strerror(-res))
                if res != length:
                    raise WorkerException(
                        f"short {'write' if is_write else 'read'} at "
                        f"offset {r_off}: {res} != {length}")
                lat_arr[i] = lat
                reaped_bytes += res
                ctx.stream_fused_ops += 1
                if is_write:
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
                        # n_slots-(depth-1) ops under --gpudirect.
                        ctx.drain_to(len(held) - 1)
                        free.append(held.popleft())
                    else:
                        reap_some(1)
                slot = free.popleft()
                length = int(lengths[i])
                r_off = int(real_offs[i])
                if is_write:
                    # the block originates in device memory: D2H into the
                    # slot, complete before the write is submitted
                    self._pre_write_fill(self._io_bufs[slot], r_off, length)
                slot_op[slot] = (i, r_off, length)
                stream.submit(slot, int(fd_idx[i]) if fd_idx is not None
                              else 0, r_off, length, is_write)
            while slot_op:  # chunk barrier: exact accounting below
                reap_some(1)
        except WorkerInterruptedException:
            _account_chunk(self, lat_arr, n, reaped_bytes, total)
            raise
        _account_chunk(self, lat_arr, n, reaped_bytes, total)

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
            try:
                native.run_block_loop(
                    fds, fd_idx, offsets, batch[1], is_write, buf_addr,
                    cfg.io_depth, self, self._native_interrupt,
                    engine=cfg.io_engine,
                    verify_salt=cfg.integrity_check_salt)
            except NativeVerifyError as err:
                file_off = int(offsets[err.block_idx]) + err.word_idx * 8
                hint = (" (read of an unwritten/sparse region?)"
                        if err.got == 0 else "")
                raise WorkerException(
                    f"data integrity check failed at file offset "
                    f"{file_off}: expected {err.want:#x}, "
                    f"got {err.got:#x}{hint}") from None

    def rotated_staging_buf(self) -> memoryview:
        """The staging slot serving the next op under the worker's
        rotation discipline (the block loops rotate inline); the
        hand-out point of --gpubench. The JAX package also books the
        hand-out in its pool's reuse counters, which the port's pool does
        not keep."""
        return self._io_bufs[self._num_iops_submitted % len(self._io_bufs)]

    def _sync_gpu_usec(self) -> None:
        """Mirror the context's split timing counters into this worker's
        phase stats."""
        self.gpu_dispatch_usec = self._gpu.dispatch_usec
        self.gpu_transfer_usec = self._gpu.transfer_usec

    # -- write-side block content -------------------------------------------

    def _pre_write_fill(self, buf: memoryview, offset: int,
                        length: int) -> None:
        cfg = self.cfg
        if self._gpu is not None:
            # block content originates in device memory and is copied
            # device->host into the write buffer (replaces cudaMemcpy D2H
            # pre-write, reference LocalWorker.cpp:2437-2490); with
            # --verify the pattern itself is generated on the device
            self._gpu.device_to_host(buf, length,
                                     verify_salt=cfg.integrity_check_salt,
                                     file_offset=offset)
            self._sync_gpu_usec()
            self.gpu_transfer_bytes += length
            return
        if cfg.integrity_check_salt:
            self._fill_verify_pattern(buf, offset, length,
                                      cfg.integrity_check_salt)

    @staticmethod
    def _fill_verify_pattern(buf: memoryview, offset: int, length: int,
                             salt: int) -> None:
        """Each 8-byte-aligned word = (file offset of word + salt)
        (reference: preWriteIntegrityCheckFillBuf, LocalWorker.cpp:2124)."""
        n_words = length // 8
        arr = np.frombuffer(buf[:n_words * 8], dtype=np.uint64)
        with np.errstate(over="ignore"):
            arr[:] = (np.arange(n_words, dtype=np.uint64) * np.uint64(8)
                      + np.uint64(offset) + np.uint64(salt))
        tail = length - n_words * 8
        if tail:
            buf[n_words * 8:length] = bytes(tail)

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

    # -- read-side block actions --------------------------------------------

    def _post_read_actions(self, buf: memoryview, offset: int,
                           length: int) -> None:
        cfg = self.cfg
        if self._gpu is not None:
            # host->device copy of the read block (replaces cudaMemcpy H2D
            # post-read / cuFile read, reference LocalWorker.cpp:2633-2749)
            self._gpu.host_to_device(buf, length,
                                     verify_salt=cfg.integrity_check_salt
                                     if cfg.do_gpu_verify else 0,
                                     file_offset=offset)
            self._sync_gpu_usec()
            self.gpu_transfer_bytes += length
            if cfg.do_gpu_verify and cfg.integrity_check_salt:
                return  # verified on the device by the CUDA kernel
        if cfg.integrity_check_salt:
            self._verify_read_buf(buf, offset, length)
