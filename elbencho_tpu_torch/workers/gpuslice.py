"""TPUSLICE under --gpuslice: striped shard ingest + redistribution.

Reference: elbencho_tpu/workers/tpuslice.py. Where --gpubench moves
synthetic bytes and the --gpuids read path feeds ONE device per worker,
this phase runs the data plane of a sharded-checkpoint restore:

  stripe s of the dataset          (file/bdev paths, striped by device)
    -> every worker reads its devices' shards off storage
       (staging slots; the fused --gpustream ring where eligible)
    -> host->device copy through the worker's TransferPipeline
       (one shard per device of the mesh)
    -> redistribution of the assembled stripe to --redistspec
       (parallel/slice_phase.SliceRunner: copies between the devices)
    -> fingerprint of each device's part by the CUDA kernel, folded and
       held against the host fingerprint of the bytes read

with stripe s+1's storage ingest OVERLAPPING stripe s's redistribution:
the lead worker enqueues the redistribution and completes it only after the
next stripe's shards are read.

Roles: every local worker is a FEEDER for the mesh devices
``WorkerManager.slice_shard_assignment`` gives it; the first local
worker is also the LEAD worker that assembles stripes and runs the
redistribution, one process over every device of the mesh, as in the
JAX package. A feeder keeps two device buffers per device it feeds, one
per stripe parity: it refills a buffer only after the lead worker consumed
the stripe after the one that buffer held, whose redistribution
completes before that.

Counters: ShardIngestMiB per feeder, IciRedistMiB/IciRedistUSec sums
and the IciGbpsHwm MAX on the lead worker (JSON keys of the JAX package);
EntriesLast is the number of stripes.

Fault policy: a failed copy, kernel launch or CUDA call ends the phase
as a WorkerException carrying the original text; there is no failover.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..toolkits import logger
from .io_errors import ShortIOError
from .shared import WorkerException, WorkerInterruptedException

#: barrier poll interval; every wait slice re-checks interrupts
_WAIT_SLICE_SECS = 0.2


class SliceAbortError(WorkerException):
    """The slice phase failed on a sibling worker; carriers re-raise a
    quiet interrupt so only the original error reaches the report."""


class _SliceState:
    """Per-phase rendezvous shared by this process's workers: shard
    publication, host-fingerprint folding, and the feed/redistribute
    lockstep. Created lazily by the first worker entering the phase
    (keyed by the phase's bench UUID)."""

    def __init__(self, n_workers: int, n_devices: int):
        self.cond = threading.Condition()
        self.n_workers = n_workers
        self.n_devices = n_devices
        self.shards: "dict[int, object]" = {}
        self.host_sum = 0
        self.host_xor = 0
        self.published = 0
        self.consumed_stripe = -1  # last stripe the lead worker consumed
        self.failed: "Exception | None" = None

    def fail(self, err: Exception) -> None:
        with self.cond:
            if self.failed is None:
                self.failed = err
            self.cond.notify_all()

    def _check(self, worker) -> None:
        worker.check_interruption_flag_only()
        if self.failed is not None:
            raise SliceAbortError(
                f"slice phase aborted by a sibling worker: "
                f"{type(self.failed).__name__}: {self.failed}")

    def publish(self, worker, shards: "dict[int, object]",
                host_sum: int, host_xor: int) -> None:
        with self.cond:
            self._check(worker)
            self.shards.update(shards)
            self.host_sum = (self.host_sum + host_sum) & 0xFFFFFFFF
            self.host_xor ^= host_xor
            self.published += 1
            self.cond.notify_all()

    def wait_all_published(self, worker) -> "tuple[dict, int, int]":
        """Lead worker: block until every worker published its shards of the
        current stripe; returns (shards, host_sum, host_xor) and resets
        the slots for the next stripe."""
        with self.cond:
            while self.published < self.n_workers:
                self._check(worker)
                self.cond.wait(_WAIT_SLICE_SECS)
            self._check(worker)
            shards, s, x = self.shards, self.host_sum, self.host_xor
            self.shards = {}
            self.host_sum = 0
            self.host_xor = 0
            self.published = 0
            return shards, s, x

    def mark_consumed(self, stripe_idx: int) -> None:
        with self.cond:
            self.consumed_stripe = stripe_idx
            self.cond.notify_all()

    def wait_consumed(self, worker, stripe_idx: int) -> None:
        """Feeders: block until the lead worker consumed stripe_idx, keeping
        feed and redistribute in lockstep (at most one stripe of ingest
        ahead of the in-flight redistribution)."""
        with self.cond:
            while self.consumed_stripe < stripe_idx:
                self._check(worker)
                self.cond.wait(_WAIT_SLICE_SECS)
            self._check(worker)


def _get_state(worker, n_workers: int, n_devices: int) -> _SliceState:
    """The rendezvous of the worker's phase and --infloop pass: each pass
    starts from a fresh state, so a feeder never takes the last pass's
    consumed stripes for this pass's (the JAX package keys its state by
    the phase alone, and its second pass then fails the fingerprint
    check or stalls; ROADMAP.md)."""
    shared = worker.shared
    key = (shared.bench_uuid, worker.phase_pass)
    with shared.cond:
        st = shared.slice_state
        if st is None or st[0] != key:
            st = (key, _SliceState(n_workers, n_devices))
            shared.slice_state = st
        return st[1]


# ----------------------------------------------------------------------
# storage shard readers: plain preadv loop vs the fused native stream
# ----------------------------------------------------------------------

class _PreadShardReader:
    """Baseline reader: preadv into rotating staging slots, with per-op
    --ioretries through the worker's retrier (the classifier of the
    Python block loop)."""

    def __init__(self, worker, fds):
        self._worker = worker
        self._fds = fds
        self._slots = worker._staging_pool.views
        self._next = 0

    def read_block(self, fd_idx: int, offset: int,
                   length: int) -> "tuple[np.ndarray, int]":
        slot = self._slots[self._next % len(self._slots)]
        self._next += 1

        def one_op():
            t0 = time.perf_counter_ns()
            n = os.preadv(self._fds[fd_idx], [slot[:length]], offset)
            if n != length:
                raise ShortIOError(True, offset, n, length)
            return (time.perf_counter_ns() - t0) // 1000

        try:
            lat_usec = self._worker._with_retries(one_op)
        except ShortIOError as err:
            raise WorkerException(str(err)) from None
        return np.frombuffer(slot[:length], dtype=np.uint32), lat_usec

    def close(self) -> None:
        pass


class _StreamShardReader:
    """Fused reader: the native engine's streaming ring keeps the shard
    reads of a stripe in flight over the staging slots (io_uring/AIO with
    the GIL released) while the feeder overlaps the device copies — the
    --gpustream ring reused for the slice phase. Reads are submitted for
    the WHOLE stripe up front (bounded by the slot count) and reaped in
    completion order."""

    def __init__(self, worker, fds, native):
        from ..utils.native import NativeStreamError
        self._worker = worker
        self._slots = worker._staging_pool.views
        try:
            self._stream = native.open_stream(
                fds, worker._staging_pool.slot_addrs,
                max(worker.cfg.block_size, 1))
        except NativeStreamError as err:
            raise _StreamUnavailable(str(err)) from err
        if worker.cfg.io_timeout_secs:
            self._stream.set_timeout(worker.cfg.io_timeout_secs * 1_000_000)
        self.backend_name = self._stream.backend_name
        self.fixed_buffers = self._stream.fixed_buffers

    def read_blocks(self, ops: "list[tuple[int, int, int]]"):
        """ops: [(fd_idx, offset, length)] — submit up to slot-count
        reads, yield (op_index, np.uint32 view, lat_usec) in completion
        order. The yielded view is only valid until the slot is
        re-submitted; callers must consume it (copy it out) before the
        next iteration submits more."""
        worker = self._worker
        free = list(range(len(self._slots)))
        slot_op: "dict[int, int]" = {}
        next_op = 0
        while next_op < len(ops) or slot_op:
            worker.check_interruption_request(force=True)
            while free and next_op < len(ops):
                slot = free.pop()
                fd_idx, off, length = ops[next_op]
                self._stream.submit(slot, fd_idx, off, length, False)
                slot_op[slot] = next_op
                next_op += 1
            for slot, lat_usec, res in self._stream.reap(
                    1, 1000, worker._native_interrupt):
                op_idx = slot_op.pop(slot)
                fd_idx, off, length = ops[op_idx]
                if res != length:
                    if res < 0:
                        raise WorkerException(
                            f"slice shard read failed at offset {off}: "
                            f"{os.strerror(-res)}")
                    raise WorkerException(
                        str(ShortIOError(True, off, res, length)))
                view = np.frombuffer(self._slots[slot][:length],
                                     dtype=np.uint32)
                yield op_idx, view, lat_usec
                free.append(slot)

    def close(self) -> None:
        if self._stream.close() != 0:
            self._worker._stream_drain_failed = True
            logger.log_error(
                f"worker {self._worker.rank}: slice stream ring drain "
                f"failed; keeping I/O buffers mapped until process exit")


class _StreamUnavailable(Exception):
    """Stream ring could not be opened; feeder falls back to preadv."""


def _stream_blocker(worker) -> "str | None":
    """Why the fused ring cannot serve the slice feeder (None =
    eligible); LocalWorker._gpu_stream_blocker for the features the port
    has."""
    from ..utils.native import ENGINE_CODES, get_native_engine
    cfg = worker.cfg
    if cfg.gpu_stream == "off":
        return "--gpustream off"
    native = get_native_engine()
    if native is None:
        return "native ioengine unavailable"
    if not native.stream_supported():
        return "kernel lacks both io_uring and AIO"
    if worker._ops_log is not None:
        return "--opslog per-op records"
    if worker._rate_limiter_read or worker._rate_limiter_write:
        return "per-op rate limits"
    if cfg.io_engine != "auto" and \
            ENGINE_CODES[cfg.io_engine] != native.stream_backend():
        return (f"--ioengine {cfg.io_engine} pinned but the stream "
                f"backend is {native.stream_backend_name()}")
    if worker._io_retrier is not None:
        return "--ioretries per-op retry (slice ring has no re-arm)"
    return None


# ----------------------------------------------------------------------
# the phase
# ----------------------------------------------------------------------

def run_gpu_slice_phase(worker) -> None:
    """Entry point from LocalWorker._dispatch_phase. Any error that is
    not already a worker error ends the phase as a WorkerException
    carrying its text; nothing fails over. A lost GPU says so: a stripe
    is one program over every device of the mesh, and the per-worker
    failover of --gpufallback cannot save it."""
    from ..cuda.device import is_device_loss_error
    try:
        _run_slice_phase_inner(worker)
    except (WorkerInterruptedException, WorkerException):
        raise
    except Exception as err:  # noqa: BLE001 - reported with its text
        if is_device_loss_error(err):
            raise WorkerException(
                f"GPU lost during the --gpuslice phase "
                f"({type(err).__name__}: {err}); slice phases abort on "
                f"GPU loss (--gpufallback does not apply to mesh "
                f"phases)") from err
        raise WorkerException(
            f"--gpuslice phase failed ({type(err).__name__}: {err})") \
            from err


def _run_slice_phase_inner(worker) -> None:
    from .gpubench import select_collective_devices

    cfg = worker.cfg
    n_local = max(1, cfg.num_threads)
    local_rank = worker.rank % n_local
    is_lead = local_rank == 0

    devices = select_collective_devices(cfg)
    state = _get_state(worker, n_local, len(devices))
    try:
        _run_slice_phase_guarded(worker, state, devices, is_lead,
                                 local_rank, n_local)
    except (SliceAbortError, WorkerInterruptedException):
        raise
    except BaseException as err:
        state.fail(err)  # wake siblings parked on the barrier
        raise


def _run_slice_phase_guarded(worker, state, devices, is_lead,
                             local_rank, n_local) -> None:
    from ..cuda.device import TransferPipeline
    from ..parallel.mesh import make_ingest_mesh
    from ..parallel.slice_phase import (MeshShapeError, SliceRunner,
                                        host_fingerprint, parse_mesh_shape)
    from .manager import WorkerManager

    cfg = worker.cfg
    n_dev = len(devices)
    bs = cfg.block_size
    if bs % 4:
        raise WorkerException(
            "--gpuslice shards are uint32 arrays: --block must be a "
            "multiple of 4 bytes")

    # dataset geometry: file/bdev mode, one file of file_size per path,
    # striped by device — stripe s places block (s, d) on mesh device d at
    # dataset offset s*stripe_bytes + d*block_size
    fds = cfg.bench_path_fds
    if not fds:
        raise WorkerException(
            "--gpuslice requires file/blockdev bench paths (no open "
            "path fds; directory-tree paths are not striped over chips)")
    dataset_bytes = cfg.file_size * len(fds)
    stripe_bytes = n_dev * bs
    n_stripes = dataset_bytes // stripe_bytes
    if n_stripes == 0:
        raise WorkerException(
            f"--gpuslice dataset too small: {dataset_bytes} bytes is "
            f"less than one stripe ({n_dev} devices x {bs} block bytes "
            f"= {stripe_bytes})")
    trimmed = dataset_bytes - n_stripes * stripe_bytes
    if trimmed and is_lead:
        logger.log(logger.LOG_NORMAL,
                   f"NOTE: --gpuslice dataset trimmed to "
                   f"{n_stripes * stripe_bytes} bytes ({n_stripes} "
                   f"stripes of {stripe_bytes}); the trailing {trimmed} "
                   f"bytes do not fill a whole stripe")

    my_devices = WorkerManager.slice_shard_assignment(n_dev, n_local,
                                                      local_rank)
    worker.got_phase_work = bool(my_devices) or is_lead
    worker.slice_devices = list(dict.fromkeys(devices[d]
                                              for d in my_devices))

    # the lead worker builds the mesh, the destination buffers and the kernel,
    # outside the timed loop via warmup()
    runner = None
    if is_lead:
        shape = None
        if cfg.mesh_shape_str:
            shape = parse_mesh_shape(cfg.mesh_shape_str)
        try:
            mesh = make_ingest_mesh(devices, shape=shape)
        except MeshShapeError as err:
            raise WorkerException(str(err)) from None
        try:
            runner = SliceRunner(mesh, cfg.redist_spec or "alltoall",
                                 bs // 4)
        except ValueError as err:
            raise WorkerException(str(err)) from None
        runner.warmup()
        logger.log(logger.LOG_NORMAL,
                   f"slice mesh {mesh.devices.shape[0]}x"
                   f"{mesh.devices.shape[1]} on {devices[0]}"
                   f"{'' if len(set(devices)) == 1 else ' ...'}, "
                   f"{n_stripes} stripes, redistspec "
                   f"{cfg.redist_spec or 'alltoall'}")

    # per-worker transfer pipeline: device ingest accounting + --gpubudget
    depth = min(max(cfg.gpu_depth or cfg.io_depth, 1),
                max(len(worker._staging_pool.views), 1))
    pipeline = TransferPipeline(depth,
                                budget_usec=cfg.gpu_dispatch_budget_usec)
    feed = _Feeder(worker, my_devices, devices, bs, depth)

    # storage reader: fused native-stream ring where eligible, else the
    # preadv loop — logged once per phase, by the lead worker
    reader = None
    stream_reader = None
    blocker = _stream_blocker(worker)
    if blocker is None:
        from ..utils.native import get_native_engine
        try:
            stream_reader = _StreamShardReader(worker, fds,
                                               get_native_engine())
            if is_lead:
                logger.log(logger.LOG_NORMAL,
                           f"slice ingest ring engaged (backend="
                           f"{stream_reader.backend_name}, fixed_buffers="
                           f"{int(stream_reader.fixed_buffers)})")
        except _StreamUnavailable as err:
            blocker = f"stream ring setup failed ({err})"
    if stream_reader is None:
        if cfg.gpu_stream == "on":
            raise WorkerException(
                f"--gpustream on: fused slice ingest ring unavailable "
                f"({blocker})")
        if is_lead and cfg.gpu_stream != "off":
            logger.log(logger.LOG_NORMAL,
                       f"NOTE: fused slice ingest ineligible ({blocker}); "
                       f"using the preadv loop")
        reader = _PreadShardReader(worker, fds)

    pending = None  # in-flight redistribution of the previous stripe
    per_chip: "dict[int, int]" = {}
    try:
        for s in range(n_stripes):
            shards, host_sum, host_xor = _ingest_stripe(
                worker, s, feed, fds, stripe_bytes, cfg.file_size, pipeline,
                reader, stream_reader, host_fingerprint, per_chip)
            state.publish(worker, shards, host_sum, host_xor)
            if is_lead:
                all_shards, stripe_sum, stripe_xor = \
                    state.wait_all_published(worker)
                stripe = runner.assemble(all_shards)
                if pending is not None:
                    # stripe s-1 was redistributed while stripe s was read
                    # off storage — the overlap this phase measures
                    _complete_redistribution(worker, runner, pending)
                pending = _launch_redistribution(runner, pipeline, stripe,
                                                 s, stripe_sum, stripe_xor)
                state.mark_consumed(s)
            else:
                state.wait_consumed(worker, s)
        if is_lead and pending is not None:
            _complete_redistribution(worker, runner, pending)
    finally:
        if pending is not None:
            # a phase cut short leaves the last redistribution's copies
            # in flight: they read the feeders' shard buffers and write
            # the runner's, which are freed when the phase returns
            runner.wait(pending)
        if stream_reader is not None:
            stream_reader.close()
        elif reader is not None:
            reader.close()
        # drain the transfer ring; --gpubudget covers ingest dispatch +
        # the lead worker's redistribution dispatch — but only on the clean
        # path: a budget breach must never mask the in-flight abort cause
        import sys as _sys
        pipeline.flush(check_budget=_sys.exc_info()[0] is None)
        worker.gpu_dispatch_usec = pipeline.dispatch_usec
        worker.gpu_transfer_usec = pipeline.transfer_usec
        if worker._gpu is None and per_chip:
            # per-device rows for workers without a device context
            # (statistics reads gpu_per_chip when _gpu is None)
            worker.gpu_per_chip = {c: (b, 0) for c, b in per_chip.items()}


class _Feeder:
    """A feeder's device side for one phase: two shard buffers per mesh
    device it feeds (stripe parity), one copy stream per distinct CUDA
    device among them, and ``depth`` host bounce buffers, page-locked on
    CUDA, that the shards are copied through: a slot is free for its next
    read at once, and the pipeline's ring (at most depth-1 copies in
    flight after a submit) completes a bounce's copy before it is
    refilled."""

    def __init__(self, worker, my_devices, devices, block_size, depth):
        self.devices = devices
        words = block_size // 4
        self.bufs = {d: [torch.empty(words, dtype=torch.int32,
                                     device=devices[d]) for _ in range(2)]
                     for d in my_devices}
        self.streams = {}
        for d in my_devices:
            dev = devices[d]
            if dev.type == "cuda" and dev not in self.streams:
                self.streams[dev] = torch.cuda.Stream(dev)
        on_cuda = bool(self.streams)
        self.bounces = [torch.frombuffer(mv, dtype=torch.int32)
                        for mv in worker._staging_pool.alloc_aux(
                            depth, max(block_size, 4), register=on_cuda)] \
            if my_devices else []
        self.my_devices = my_devices
        self.copies = 0

    def copy_in(self, pipeline, d: int, stripe_idx: int, view: np.ndarray):
        """Copy one shard (a uint32 slot view) to its device buffer of the
        stripe's parity through the pipeline; returns (buffer, event)."""
        dst = self.bufs[d][stripe_idx % 2]
        bounce = self.bounces[self.copies % len(self.bounces)]
        self.copies += 1
        stream = self.streams.get(self.devices[d])

        def submit():
            np.copyto(bounce.numpy()[:dst.numel()], view.view(np.int32))
            if stream is None:
                dst.copy_(bounce[:dst.numel()])
                return
            with torch.cuda.stream(stream):
                dst.copy_(bounce[:dst.numel()], non_blocking=True)

        return dst, pipeline.submit(submit, stream=stream)


def _ingest_stripe(worker, stripe_idx, feed, fds, stripe_bytes, file_size,
                   pipeline, reader, stream_reader, host_fingerprint,
                   per_chip):
    """Read this worker's shards of one stripe and place each onto its
    mesh device through the transfer pipeline. Returns
    ({device_idx: (shard tensor, copy event)}, host_sum, host_xor)."""
    bs = worker.cfg.block_size
    my_devices = feed.my_devices
    shards: "dict[int, tuple]" = {}
    host_sum = 0
    host_xor = 0
    ops = []
    for d in my_devices:
        off = stripe_idx * stripe_bytes + d * bs
        ops.append((off // file_size, off % file_size, bs))

    def place(op_idx, view, lat_usec):
        nonlocal host_sum, host_xor
        d = my_devices[op_idx]
        s, x = host_fingerprint(view)
        shards[d] = feed.copy_in(pipeline, d, stripe_idx, view)
        host_sum = (host_sum + s) & 0xFFFFFFFF
        host_xor ^= x
        worker.iops_latency_histo.add_latency(lat_usec)
        worker.live_ops.num_bytes_done += bs
        worker.live_ops.num_iops_done += 1
        worker.gpu_transfer_bytes += bs
        worker._shard_ingest_bytes += bs
        worker.shard_ingest_mib = worker._shard_ingest_bytes >> 20
        per_chip[d] = per_chip.get(d, 0) + bs

    if stream_reader is not None:
        for op_idx, view, lat_usec in stream_reader.read_blocks(ops):
            place(op_idx, view, lat_usec)
    else:
        for op_idx, (fd_idx, off, length) in enumerate(ops):
            worker.check_interruption_request(force=True)
            view, lat_usec = reader.read_block(fd_idx, off, length)
            place(op_idx, view, lat_usec)
    return shards, host_sum, host_xor


def _launch_redistribution(runner, pipeline, stripe, stripe_idx, host_sum,
                           host_xor) -> dict:
    handle = runner.launch(stripe)
    # the redistribution's dispatch cost rides the pipeline's budget
    # accounting so --gpubudget bounds the slice phase's host overhead too
    pipeline.note_dispatch(handle["dispatch_usec"])
    handle["stripe_idx"] = stripe_idx
    handle["host_sum"] = host_sum
    handle["host_xor"] = host_xor
    return handle


def _complete_redistribution(worker, runner, handle) -> None:
    from ..parallel.slice_phase import SliceFingerprintError

    dev_sum, dev_xor, usec = runner.complete(handle)
    stripe_bytes = runner.stripe_bytes
    try:
        runner.verify(dev_sum, dev_xor, handle["host_sum"],
                      handle["host_xor"], handle["stripe_idx"])
    except SliceFingerprintError as err:
        raise WorkerException(str(err)) from None
    worker._ici_redist_bytes += stripe_bytes
    worker.ici_redist_mib = worker._ici_redist_bytes >> 20
    worker.ici_redist_usec += usec
    gbps = round(stripe_bytes * 8 / (usec * 1000), 3)
    worker.ici_gbps_hwm = max(worker.ici_gbps_hwm, gbps)
    worker.live_ops.num_entries_done += 1  # one stripe redistributed
    worker.entries_latency_histo.add_latency(usec)
