"""LocalWorker: one I/O worker thread running the POSIX phase loops.

Reference: elbencho_tpu/workers/local_worker.py (source/workers/
LocalWorker.{h,cpp}), cut to the port's slices: dir mode (the dir/file
namespace, mkdir/stat/rmdir of dirs, write/read/stat/unlink of files),
file mode on one or several files or block devices (striped), the Python
block loop (offset gen -> [pre-write fill] -> positional I/O ->
[post-read verify / device ingest] -> latency + counters), integrity
verify, and the delete phases. The native C++ engine, the fused
``--tpustream`` ring, custom trees and the other storage back ends are
later slices.

The GPU data path replaces upstream elbencho's CUDA staging
(allocGPUIOBuffer :1427-1537, cudaMemcpy wrappers :2437-2490): workers
map to GPUs by ``rank % len(gpu_ids)`` and move blocks through a
``CudaWorkerContext`` (elbencho_tpu_torch/cuda/device.py).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..phases import BenchPathType, BenchPhase
from ..toolkits import logger
from ..toolkits.offset_gen import (OffsetGenRandomAligned,
                                   OffsetGenRandomAlignedFullCoverage,
                                   OffsetGenSequential)
from ..toolkits.random_algos import RandAlgoGoldenPrime
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
        self._num_iops_submitted = 0

    def reset_stats(self) -> None:
        super().reset_stats()
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
            if cfg.run_create_files and not cfg.integrity_check_salt:
                self._gpu.warmup_fill()  # device fill outside timed phase
            if cfg.run_read_files:
                self._gpu.warmup_transfer()
        self._rand_offset_algo = RandAlgoGoldenPrime(seed=None)

    def cleanup(self) -> None:
        if self._gpu is not None:
            self._gpu.close()  # drop device tensors before buffer teardown
            self._gpu = None
        self._io_bufs = []
        if self._staging_pool is not None:
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
        if phase in (BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS,
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
        o % file_size in file o // file_size. The device batch is flushed
        at the end of every call, so in dir mode a --gpubatch span never
        holds blocks of two files."""
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
