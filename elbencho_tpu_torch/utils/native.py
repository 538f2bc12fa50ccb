"""ctypes wrapper of the native C++ I/O engine (csrc/ioengine.cpp).

Reference: elbencho_tpu/utils/native.py, cut to what the port calls: the
streaming ring of the fused ``--gpustream`` loop (``NativeStream``), the
classic block loop of phases without a device (``run_block_loop``), the
per-file loop of dir mode and custom trees without a device
(``run_file_loop``: open, blocks and close, or stat, or unlink, of a
chunk of files in one call), and the ``--mmap`` loop without a device
(``run_mmap_loop``: a memcpy per block between a file's mapping and the
io buffer).
The engine's source is the port's own copy, ``csrc/ioengine.cpp`` (ABI
11), built with g++ at first use into ``_build/`` by
``ops/cuda_build.load_host_library``. The ring's per-op deadline and
its test-only fault injection (``set_timeout``, ``set_fault``) serve
``--iotimeout`` and the ``ELBENCHO_TPU_IO_FAULT`` knob, whose
``first`` schedule (the port's alone) faults no retry. The net and
registered-pool entry points are later slices. The engine differs from
the JAX package's ``csrc/ioengine.cpp`` by one lock: one process-wide
mutex serializes its io_setup and io_destroy syscalls.
"""

from __future__ import annotations

import ctypes
import errno as errno_mod
import os
import threading

import numpy as np

# engine selector values (must match csrc/ioengine.cpp)
ENGINE_CODES = {"auto": 0, "sync": 1, "aio": 2, "uring": 3}
#: reverse map for logs
ENGINE_NAMES = {code: name for name, code in ENGINE_CODES.items()}

#: ABI generation of csrc/ioengine.cpp; ioengine_version() reports
#: "elbencho-tpu ioengine <N> (...)"
EXPECTED_ABI = 11

_EILSEQ = errno_mod.EILSEQ  # engine's verify-mismatch return code

#: ioengine_stream_set_fault kinds (csrc STREAM_FAULT_*; test only: the
#: configuration refuses the env knob outside a test harness)
STREAM_FAULT_KINDS = {"eio": 1, "short": 2, "hang": 3}


def parse_fault_spec(spec: str) -> "tuple[int, int, int, bool]":
    """Parse the ELBENCHO_TPU_IO_FAULT test knob:
    "kind:every_n[:seed[:first]]" (kind in eio|short|hang) -> (seed,
    every_n, kind_code, first_only). With ``first`` the schedule counts
    and faults first submits only, never a retry of an op (see
    NativeStream.resubmit). Raises ValueError on a malformed spec, so a
    typo fails in the harness instead of injecting nothing."""
    parts = spec.split(":")
    if (len(parts) not in (2, 3, 4) or parts[0] not in STREAM_FAULT_KINDS
            or (len(parts) == 4 and parts[3] != "first")):
        raise ValueError(
            f"malformed ELBENCHO_TPU_IO_FAULT {spec!r} (want "
            f"'eio|short|hang:EVERY_N[:SEED]')")
    every_n = int(parts[1])
    seed = int(parts[2]) if len(parts) >= 3 else 0
    if every_n <= 0:
        raise ValueError("ELBENCHO_TPU_IO_FAULT every_n must be > 0")
    return seed, every_n, STREAM_FAULT_KINDS[parts[0]], len(parts) == 4

_lock = threading.Lock()
_engine = None

#: serializes the calls that create or destroy a kernel-AIO context (the
#: stream probe, open and close): on a kernel whose io_destroy unmaps the
#: context's ring page before it retires the context id (the gVisor
#: sandbox of the H100 machine), an io_setup in another thread of the
#: process can map that page again and fail with EINVAL. The engine
#: takes a lock of its own around each io_setup and io_destroy, which
#: also covers the block loop (--ioengine aio without a device) that
#: sets up and destroys its context inside one long call; this one
#: keeps the probe to one run per engine.
_aio_ctx_lock = threading.Lock()


class NativeVerifyError(Exception):
    """In-loop data integrity check failed (ioengine -EILSEQ), with the
    mismatch location, so the caller can report the file offset the way
    the Python loop does."""

    def __init__(self, block_idx: int, word_idx: int, want: int, got: int):
        self.block_idx = block_idx
        self.word_idx = word_idx
        self.want = want
        self.got = got
        super().__init__(f"integrity check failed at block {block_idx} "
                         f"word {word_idx}")


class NativeStreamError(OSError):
    """Stream open/submit/reap failed inside the engine (-errno)."""

    def __init__(self, errno_val: int, what: str):
        super().__init__(errno_val, f"{os.strerror(errno_val)} ({what})")


def _as_ptr(values: np.ndarray, dtype, c_type):
    """Zero-copy ctypes view of a numpy array; the view keeps the array
    alive for the native call."""
    arr = np.ascontiguousarray(values, dtype=dtype)
    ptr = arr.ctypes.data_as(ctypes.POINTER(c_type))
    ptr._keepalive = arr
    return ptr


def _account_chunk(worker, lat_arr, lengths: np.ndarray, n: int,
                   bytes_done: int, total_bytes: int,
                   op_is_read: "np.ndarray | None" = None) -> None:
    """Post-chunk accounting of the block loop and the fused stream: a
    complete chunk books every latency and counter exactly, split into
    the rwmix-read counters where ``op_is_read`` (the per-op flags of a
    --rwmixpct write phase) marks reads; an interrupted one, whose
    completions may be out of order, books the done-prefix estimate and
    no latencies, with the flags of that prefix splitting it."""
    rd = op_is_read.astype(bool) if op_is_read is not None else None
    if bytes_done == total_bytes:
        lat = np.frombuffer(lat_arr, dtype=np.uint64)
        done = n
        if rd is not None:
            worker.iops_latency_histo_rwmix.add_latencies_array(lat[rd])
            lat = lat[~rd]
        worker.iops_latency_histo.add_latencies_array(lat)
    else:
        avg_len = max(total_bytes // n, 1)
        done = min(n, bytes_done // avg_len)
    read_ops = read_bytes = 0
    if rd is not None and done:
        read_ops = int(rd[:done].sum())
        read_bytes = int(lengths[:done][rd[:done]].sum())
        worker.live_ops_rwmix_read.num_iops_done += read_ops
        worker.live_ops_rwmix_read.num_bytes_done += read_bytes
    worker.live_ops.num_iops_done += done - read_ops
    worker.live_ops.num_bytes_done += max(bytes_done - read_bytes, 0)
    worker._num_iops_submitted += n
    worker.create_stonewall_stats_if_triggered()


class NativeStream:
    """Submission/completion ring over the worker's staging slots
    (ioengine_stream_*): up to len(slot_addrs) io_uring (or kernel-AIO)
    reads/writes in flight with the GIL released, reaped slot by slot so
    the caller overlaps storage I/O with device copies. One in-flight op
    per slot: the engine returns -EBUSY on a violation. The stream owns
    its ring and registers the slots as io_uring fixed buffers itself
    (a registration the kernel refuses falls back to the unregistered
    opcodes)."""

    #: reap batch bound (cq depth can reach 2x sq entries)
    _MAX_EVENTS = 64

    def __init__(self, lib: ctypes.CDLL, fds, slot_addrs, slot_size: int):
        self._lib = lib
        self._handle = None
        n_slots = len(slot_addrs)
        self.n_slots = n_slots
        fds_arr = (ctypes.c_int * len(fds))(*fds)
        addr_arr = (ctypes.c_uint64 * n_slots)(*slot_addrs)
        err = ctypes.c_int(0)
        with _aio_ctx_lock:
            handle = lib.ioengine_stream_open(fds_arr, len(fds), addr_arr,
                                              n_slots, slot_size,
                                              ctypes.byref(err))
        if not handle:
            raise NativeStreamError(-err.value or errno_mod.EINVAL,
                                    "stream open")
        self._handle = handle
        #: the slots are io_uring fixed buffers of this ring
        self.fixed_buffers = bool(lib.ioengine_stream_fixed_buffers(handle))
        #: ENGINE_CODES value of the backend THIS ring runs on (the open
        #: may fall back from uring to AIO; pins must check this)
        self.backend = int(lib.ioengine_stream_backend_of(handle))
        self.backend_name = ENGINE_NAMES.get(self.backend, "none")
        max_ev = max(self._MAX_EVENTS, 2 * n_slots)
        self._out_slots = (ctypes.c_uint32 * max_ev)()
        self._out_lat = (ctypes.c_uint64 * max_ev)()
        self._out_res = (ctypes.c_int64 * max_ev)()
        self._max_events = max_ev
        #: (seed, every_n, kind) of a fault schedule that counts first
        #: submits only (the knob's "first"), else None
        self._first_only_fault = None

    def submit(self, slot: int, fd_idx: int, offset: int, length: int,
               is_write: bool) -> None:
        ret = self._lib.ioengine_stream_submit(
            self._handle, slot, fd_idx, offset, length,
            1 if is_write else 0)
        if ret < 0:
            raise NativeStreamError(-ret, f"stream submit slot {slot}")

    def resubmit(self, slot: int, fd_idx: int, offset: int, length: int,
                 is_write: bool) -> None:
        """submit() of a retry of an op that failed (--ioretries). Under a
        "first" fault schedule the retry goes with the schedule disarmed,
        and the engine's submit count, which it advances, is given back
        through the seed: the schedule faults the same first submits as
        without retries."""
        fault = self._first_only_fault
        if fault is None:
            self.submit(slot, fd_idx, offset, length, is_write)
            return
        seed, every_n, kind = fault
        self._set_fault(seed, 0, kind)
        try:
            self.submit(slot, fd_idx, offset, length, is_write)
        finally:
            seed = (seed - 1) % every_n
            self._first_only_fault = (seed, every_n, kind)
            self._set_fault(seed, every_n, kind)

    def reap(self, min_complete: int, timeout_msecs: int,
             interrupt_flag: ctypes.c_int) -> "list[tuple[int, int, int]]":
        """Blocking (bounded, interruptible) harvest, GIL released;
        returns [(slot, lat_usec, res), ...]. res is the raw per-op
        result (bytes moved, or -errno), checked by the caller so a short
        read surfaces with its offset."""
        got = self._lib.ioengine_stream_reap(
            self._handle, min_complete, timeout_msecs, self._out_slots,
            self._out_lat, self._out_res, self._max_events,
            ctypes.byref(interrupt_flag))
        if got < 0:
            raise NativeStreamError(-got, "stream reap")
        return [(self._out_slots[i], self._out_lat[i], self._out_res[i])
                for i in range(got)]

    def inflight(self) -> int:
        return self._lib.ioengine_stream_inflight(self._handle)

    def set_timeout(self, timeout_usec: int) -> None:
        """--iotimeout: per-op deadline. Ops older than this at reap time
        are cancelled and surface as res == -ETIMEDOUT with their slot
        re-armed (0 disarms)."""
        ret = self._lib.ioengine_stream_set_timeout(self._handle,
                                                    max(timeout_usec, 0))
        if ret < 0:
            raise NativeStreamError(-ret, "stream set_timeout")

    def set_fault(self, seed: int, every_n: int, kind: int,
                  first_only: bool = False) -> None:
        """Deterministic fault injection (test only; STREAM_FAULT_KINDS).
        Op k (by submit order) is faulted when (k+seed) % every_n == 0;
        with ``first_only`` k counts first submits only, and a retry
        (resubmit) is never faulted. A hung op is never submitted to the
        kernel, so the hang behaves alike on io_uring and kernel AIO."""
        self._set_fault(seed, every_n, kind)
        self._first_only_fault = ((seed % every_n, every_n, kind)
                                  if first_only and every_n else None)

    def _set_fault(self, seed: int, every_n: int, kind: int) -> None:
        ret = self._lib.ioengine_stream_set_fault(self._handle, seed,
                                                  every_n, kind)
        if ret < 0:
            raise NativeStreamError(-ret, "stream set_fault")

    def set_fault_from_spec(self, spec: str) -> None:
        self.set_fault(*parse_fault_spec(spec))

    def cancel(self, slot: int) -> None:
        """Request cancellation of the slot's in-flight op; its completion
        surfaces via reap (-ECANCELED, or the real result if the op beat
        the cancel). -ENOENT (no in-flight op) is not an error here."""
        ret = self._lib.ioengine_stream_cancel(self._handle, slot)
        if ret < 0 and ret != -errno_mod.ENOENT:
            raise NativeStreamError(-ret, f"stream cancel slot {slot}")

    def oldest_age_usec(self) -> int:
        """Age of the oldest in-flight op (0 = idle)."""
        return int(self._lib.ioengine_stream_oldest_age_usec(self._handle))

    def close(self) -> int:
        """Drain outstanding kernel DMA, then tear the ring down;
        idempotent. Returns 0, or -errno when the drain was aborted with
        ops still kernel-owned: the caller must then keep the slot
        buffers mapped for the life of the process (a late completion
        DMAs into them)."""
        ret = 0
        if self._handle is not None:
            with _aio_ctx_lock:
                ret = self._lib.ioengine_stream_close(self._handle)
            self._handle = None
        return ret

    def __del__(self):  # never leak a kernel ring
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class _NativeEngine:
    """The loaded engine library; see csrc/ioengine.cpp for the ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.ioengine_version.restype = ctypes.c_char_p
        lib.ioengine_version.argtypes = []
        lib.ioengine_run_block_loop4.restype = ctypes.c_int
        lib.ioengine_run_block_loop4.argtypes = [
            ctypes.POINTER(ctypes.c_int),     # fds
            ctypes.POINTER(ctypes.c_uint32),  # per-block fd index (or None)
            u64p,                             # offsets
            u64p,                             # lengths
            ctypes.c_uint64,                  # num_blocks
            ctypes.c_int,                     # is_write
            ctypes.c_void_p,                  # buffer
            ctypes.c_uint64,                  # buffer size
            ctypes.c_int,                     # iodepth
            u64p,                             # out: latencies (usec/block)
            u64p,                             # out: bytes done
            ctypes.POINTER(ctypes.c_int),     # interrupt flag
            ctypes.c_int,                     # engine (ENGINE_CODES)
            ctypes.POINTER(ctypes.c_ubyte),   # rwmix per-op read flags
            ctypes.c_uint64,                  # verify salt
            ctypes.c_int,                     # do_verify
            ctypes.c_int,                     # block variance pct
            ctypes.c_uint64,                  # block variance seed
            u64p,                             # out: verify mismatch info[4]
            ctypes.c_uint64,                  # read rate limit (bytes/s)
            ctypes.c_uint64,                  # write rate limit (bytes/s)
            u64p,                             # in/out rate windows [4]
            ctypes.c_int,                     # inline readback (sync only)
            ctypes.c_int,                     # flock mode 0|1=range|2=full
            ctypes.c_int,                     # opslog fd (-1 = off)
            ctypes.c_int,                     # opslog flock
            ctypes.c_int,                     # worker rank (for records)
        ]
        lib.ioengine_stream_open.restype = ctypes.c_void_p
        lib.ioengine_stream_open.argtypes = [
            ctypes.POINTER(ctypes.c_int),     # fds
            ctypes.c_uint32,                  # num fds
            u64p,                             # slot base addresses
            ctypes.c_uint64,                  # num slots
            ctypes.c_uint64,                  # slot size (bytes)
            ctypes.POINTER(ctypes.c_int),     # out: -errno on failure
        ]
        lib.ioengine_stream_submit.restype = ctypes.c_int
        lib.ioengine_stream_submit.argtypes = [
            ctypes.c_void_p,                  # stream handle
            ctypes.c_uint32,                  # slot index
            ctypes.c_uint32,                  # fd index
            ctypes.c_uint64,                  # file offset
            ctypes.c_uint64,                  # length
            ctypes.c_int,                     # is_write
        ]
        lib.ioengine_stream_reap.restype = ctypes.c_int
        lib.ioengine_stream_reap.argtypes = [
            ctypes.c_void_p,                  # stream handle
            ctypes.c_int,                     # min completions to wait for
            ctypes.c_int,                     # timeout msecs
            ctypes.POINTER(ctypes.c_uint32),  # out: completed slot indices
            u64p,                             # out: latencies (usec)
            ctypes.POINTER(ctypes.c_int64),   # out: raw cqe results
            ctypes.c_int,                     # max events
            ctypes.POINTER(ctypes.c_int),     # interrupt flag
        ]
        for name, restype in (("ioengine_stream_inflight", ctypes.c_int),
                              ("ioengine_stream_close", ctypes.c_int),
                              ("ioengine_stream_oldest_age_usec",
                               ctypes.c_int64),
                              ("ioengine_stream_backend_of", ctypes.c_int),
                              ("ioengine_stream_fixed_buffers",
                               ctypes.c_int)):
            getattr(lib, name).restype = restype
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.ioengine_stream_cancel.restype = ctypes.c_int
        lib.ioengine_stream_cancel.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint32]
        lib.ioengine_stream_set_timeout.restype = ctypes.c_int
        lib.ioengine_stream_set_timeout.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_uint64]
        lib.ioengine_stream_set_fault.restype = ctypes.c_int
        lib.ioengine_stream_set_fault.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
        lib.ioengine_stream_backend.restype = ctypes.c_int
        lib.ioengine_stream_backend.argtypes = []
        self._stream_backend = None  # kernel capability, probed once
        lib.ioengine_run_file_loop3.restype = ctypes.c_int
        lib.ioengine_run_file_loop3.argtypes = [
            ctypes.c_char_p,                  # NUL-separated paths blob
            ctypes.POINTER(ctypes.c_uint32),  # per-path blob offsets
            ctypes.c_uint64,                  # num files
            ctypes.c_int,                     # op (FILE_OPS)
            ctypes.c_int,                     # open flags
            ctypes.c_uint64,                  # file size
            ctypes.c_uint64,                  # block size
            ctypes.c_void_p,                  # io buffer
            u64p,                             # per-file range starts (opt)
            u64p,                             # per-file range lengths (opt)
            ctypes.c_int,                     # ignore delete errors
            u64p,                             # out: entry latencies
            u64p,                             # out: block latencies
            u64p,                             # out: bytes done
            u64p,                             # out: entries done
            u64p,                             # out: failing file index
            ctypes.POINTER(ctypes.c_int),     # interrupt flag
            ctypes.c_uint64,                  # verify salt
            ctypes.c_int,                     # do_verify
            ctypes.c_int,                     # block variance pct
            ctypes.c_uint64,                  # block variance seed
            ctypes.c_int,                     # rwmix read pct (write op)
            ctypes.c_uint64,                  # rwmix base (rank+submitted)
            u64p,                             # out: verify mismatch info[4]
            u64p,                             # out: rwmix {blocks, bytes}
            ctypes.c_uint64,                  # read rate limit (bytes/s)
            ctypes.c_uint64,                  # write rate limit (bytes/s)
            u64p,                             # in/out rate windows [4]
            ctypes.c_int,                     # inline readback (write op)
            ctypes.c_int,                     # flock mode 0|1=range|2=full
        ]
        lib.ioengine_run_mmap_loop3.restype = ctypes.c_int
        lib.ioengine_run_mmap_loop3.argtypes = [
            ctypes.c_void_p,                  # mapping base address
            u64p,                             # offsets
            u64p,                             # lengths
            ctypes.c_uint64,                  # num blocks
            ctypes.c_int,                     # is_write
            ctypes.c_void_p,                  # io buffer
            u64p,                             # out: latencies
            u64p,                             # out: bytes done
            ctypes.POINTER(ctypes.c_int),     # interrupt flag
            ctypes.POINTER(ctypes.c_ubyte),   # rwmix per-op read flags
            ctypes.c_uint64,                  # verify salt
            ctypes.c_int,                     # do_verify
            ctypes.c_int,                     # block variance pct
            ctypes.c_uint64,                  # block variance seed
            u64p,                             # out: verify mismatch info[4]
            ctypes.c_uint64,                  # read rate limit (bytes/s)
            ctypes.c_uint64,                  # write rate limit (bytes/s)
            u64p,                             # in/out rate windows [4]
        ]

    def version(self) -> str:
        return self._lib.ioengine_version().decode()

    def abi_version(self) -> int:
        # "elbencho-tpu ioengine <N> (...)" -> N; 0 if unparseable
        parts = self.version().split()
        try:
            return int(parts[2])
        except (IndexError, ValueError):
            return 0

    def stream_supported(self) -> bool:
        """Streaming producer mode: io_uring primary, kernel-AIO tier."""
        return self.stream_backend() != 0

    def stream_backend(self) -> int:
        """ENGINE_CODES value of the backend a stream would use on this
        kernel: 3 = io_uring, 2 = kernel AIO, 0 = unavailable. Probed
        once (it creates and destroys a ring). A live stream reports the
        backend it actually got via NativeStream.backend."""
        if self._stream_backend is None:
            with _aio_ctx_lock:
                if self._stream_backend is None:
                    self._stream_backend = int(
                        self._lib.ioengine_stream_backend())
        return self._stream_backend

    def stream_backend_name(self) -> str:
        return ENGINE_NAMES.get(self.stream_backend(), "none")

    def open_stream(self, fds, slot_addrs, slot_size: int) -> NativeStream:
        """Open a submission/completion ring over the given staging slots;
        raises NativeStreamError when the kernel cannot provide one."""
        return NativeStream(self._lib, fds, slot_addrs, slot_size)

    def run_block_loop(self, fds: "list[int]", fd_idx, offsets: np.ndarray,
                       lengths: np.ndarray, is_write: bool, buf_addr: int,
                       iodepth: int, worker, interrupt_flag: ctypes.c_int,
                       engine: str = "auto", verify_salt: int = 0,
                       op_is_read: "np.ndarray | None" = None,
                       block_var_pct: int = 0, block_var_seed: int = 0,
                       limit_read_bps: int = 0, limit_write_bps: int = 0,
                       rl_state=None, inline_readback: bool = False,
                       flock_mode: int = 0, ops_fd: int = -1,
                       ops_lock: bool = False) -> None:
        """One chunk of the block loop in C++: fd_idx (uint32 array, or
        None for one file) selects the file of each block, offsets are
        in-file offsets. The engine fills each write slot from buf_addr,
        or with the verify pattern under verify_salt, and checks reads
        against it, raising NativeVerifyError at the first mismatch.
        Its block modifiers: op_is_read, the uint8 per-op read flags of
        a --rwmixpct write phase; block_var_pct/seed, the --blockvarpct
        refill of each write block (the engine's "fast" tier); the
        per-thread limits in bytes/s, whose windows live in rl_state (4
        uint64: read, then write) so that they carry across chunks;
        inline_readback, the --readinline/--verifydirect read of each
        written block straight back (verified under verify_salt);
        flock_mode, the --flock lock around each op (0 none, 1 range, 2
        full); ops_fd, the --opslog file the engine writes one record per
        block to (-1: none), under flock with ops_lock. The engine runs
        the locks and the read-back in its sync loop only, and refuses
        them (EINVAL) on another. Counters and latencies are booked on
        the worker."""
        n = len(offsets)
        lat_arr = (ctypes.c_uint64 * n)()
        bytes_done = ctypes.c_uint64(0)
        verify_info = (ctypes.c_uint64 * 4)()
        ret = self._lib.ioengine_run_block_loop4(
            (ctypes.c_int * len(fds))(*fds),
            None if fd_idx is None
            else _as_ptr(fd_idx, np.uint32, ctypes.c_uint32),
            _as_ptr(offsets, np.uint64, ctypes.c_uint64),
            _as_ptr(lengths, np.uint64, ctypes.c_uint64), n,
            1 if is_write else 0, ctypes.c_void_p(buf_addr),
            int(lengths.max()), iodepth, lat_arr, ctypes.byref(bytes_done),
            ctypes.byref(interrupt_flag), ENGINE_CODES[engine],
            None if op_is_read is None
            else _as_ptr(op_is_read, np.uint8, ctypes.c_ubyte),
            verify_salt, 1 if verify_salt else 0, block_var_pct,
            block_var_seed, verify_info, limit_read_bps, limit_write_bps,
            rl_state, 1 if inline_readback else 0, flock_mode, ops_fd,
            1 if ops_lock else 0, worker.rank)
        if ret == -_EILSEQ:
            raise NativeVerifyError(*(int(v) for v in verify_info))
        if ret < 0:
            raise OSError(-ret, os.strerror(-ret))
        _account_chunk(worker, lat_arr, lengths, n, bytes_done.value,
                       int(lengths.sum()), op_is_read)

    def run_mmap_loop(self, map_addr: int, offsets: np.ndarray,
                      lengths: np.ndarray, is_write: bool, buf_addr: int,
                      worker, interrupt_flag: ctypes.c_int,
                      op_is_read: "np.ndarray | None" = None,
                      verify_salt: int = 0, block_var_pct: int = 0,
                      block_var_seed: int = 0, limit_read_bps: int = 0,
                      limit_write_bps: int = 0, rl_state=None) -> None:
        """One chunk of the --mmap loop in C++: a memcpy between the
        mapping at map_addr and the io buffer per block, at the mapping's
        offsets, with run_block_loop's block modifiers (the verify fill
        and check, the --rwmixpct flags, the "fast" --blockvarpct refill,
        the rate limits) and its accounting; a mismatch raises
        NativeVerifyError."""
        n = len(offsets)
        lat_arr = (ctypes.c_uint64 * n)()
        bytes_done = ctypes.c_uint64(0)
        verify_info = (ctypes.c_uint64 * 4)()
        ret = self._lib.ioengine_run_mmap_loop3(
            ctypes.c_void_p(map_addr),
            _as_ptr(offsets, np.uint64, ctypes.c_uint64),
            _as_ptr(lengths, np.uint64, ctypes.c_uint64), n,
            1 if is_write else 0, ctypes.c_void_p(buf_addr), lat_arr,
            ctypes.byref(bytes_done), ctypes.byref(interrupt_flag),
            None if op_is_read is None
            else _as_ptr(op_is_read, np.uint8, ctypes.c_ubyte),
            verify_salt, 1 if verify_salt else 0, block_var_pct,
            block_var_seed, verify_info, limit_read_bps, limit_write_bps,
            rl_state)
        if ret == -_EILSEQ:
            raise NativeVerifyError(*(int(v) for v in verify_info))
        if ret < 0:
            raise OSError(-ret, os.strerror(-ret))
        _account_chunk(worker, lat_arr, lengths, n, bytes_done.value,
                       int(lengths.sum()), op_is_read)

    #: op codes of ioengine_run_file_loop3 (csrc/ioengine.cpp FILE_OP_*)
    FILE_OPS = {"write": 0, "read": 1, "stat": 2, "unlink": 3}

    def run_file_loop(self, paths: "list[str]", op: str, open_flags: int,
                      file_size: int, block_size: int, buf_addr: int,
                      ignore_delete_errors: bool, worker,
                      interrupt_flag: ctypes.c_int, ranges=None,
                      verify_salt: int = 0, block_var_pct: int = 0,
                      block_var_seed: int = 0, rwmix_pct: int = 0,
                      limit_read_bps: int = 0, limit_write_bps: int = 0,
                      rl_state=None, inline_readback: bool = False,
                      flock_mode: int = 0) -> None:
        """One chunk of the per-file loop in C++: open, blocks and close
        (write, read), or stat, or unlink, of each path. ``ranges`` is
        (starts, lengths) of each file's byte range (a custom tree's
        slices of shared files), else every file is [0, file_size). The
        block modifiers are run_block_loop's; a write's --rwmixpct split
        is (rank + op index) % 100 < rwmix_pct, counted on from the
        worker's submitted ops. A verify mismatch raises
        NativeVerifyError with the chunk's global block index; another
        failure an OSError that names the path. The entry and block
        latencies and the counters are booked on the worker; an
        interrupted chunk books only the files it finished."""
        n = len(paths)
        encoded = [os.fsencode(p) for p in paths]
        blob = b"\0".join(encoded) + b"\0"
        offs = (ctypes.c_uint32 * n)()
        pos = 0
        for i, e in enumerate(encoded):
            offs[i] = pos
            pos += len(e) + 1
        io_op = op in ("write", "read") and block_size
        if ranges is not None:
            starts_arr = _as_ptr(ranges[0], np.uint64, ctypes.c_uint64)
            lens_arr = _as_ptr(ranges[1], np.uint64, ctypes.c_uint64)
            per_file_blocks = (
                (np.asarray(ranges[1], dtype=np.uint64)
                 + np.uint64(block_size - 1)) // np.uint64(block_size)
            ).astype(np.int64) if io_op else None
            total_blocks = int(per_file_blocks.sum()) if io_op else 0
        else:
            starts_arr = lens_arr = per_file_blocks = None
            bpf = (file_size + block_size - 1) // block_size \
                if io_op and file_size else 0
            total_blocks = n * bpf
        entry_lat = (ctypes.c_uint64 * n)()
        block_lat = (ctypes.c_uint64 * max(total_blocks, 1))()
        bytes_done = ctypes.c_uint64(0)
        entries_done = ctypes.c_uint64(0)
        fail_idx = ctypes.c_uint64(0)
        verify_info = (ctypes.c_uint64 * 4)()
        rwmix_out = (ctypes.c_uint64 * 2)()
        rwmix_base = worker.rank + worker._num_iops_submitted
        ret = self._lib.ioengine_run_file_loop3(
            blob, offs, n, self.FILE_OPS[op], open_flags, file_size,
            block_size, ctypes.c_void_p(buf_addr), starts_arr, lens_arr,
            1 if ignore_delete_errors else 0, entry_lat, block_lat,
            ctypes.byref(bytes_done), ctypes.byref(entries_done),
            ctypes.byref(fail_idx), ctypes.byref(interrupt_flag),
            verify_salt, 1 if verify_salt else 0, block_var_pct,
            block_var_seed, rwmix_pct, rwmix_base, verify_info, rwmix_out,
            limit_read_bps, limit_write_bps, rl_state,
            1 if inline_readback else 0, flock_mode)
        if ret == -_EILSEQ:
            raise NativeVerifyError(*(int(v) for v in verify_info))
        if ret < 0:
            failed = paths[min(fail_idx.value, n - 1)]
            raise OSError(-ret, f"{os.strerror(-ret)} ({op}: {failed})",
                          failed)
        done = entries_done.value
        if done:
            worker.entries_latency_histo.add_latencies_array(
                np.frombuffer(entry_lat, dtype=np.uint64)[:done])
        if per_file_blocks is not None:
            num_blocks = int(per_file_blocks[:done].sum())
        else:
            num_blocks = done * (total_blocks // n if n else 0)
        rwmix_blocks, rwmix_bytes = rwmix_out[0], rwmix_out[1]
        if num_blocks:
            lat = np.frombuffer(block_lat, dtype=np.uint64)[:num_blocks]
            if rwmix_pct and op == "write" and rwmix_blocks:
                # the engine's own modulo, so the flags are exact
                rd = (((np.uint64(rwmix_base)
                        + np.arange(num_blocks, dtype=np.uint64))
                       % np.uint64(100)) < np.uint64(rwmix_pct))
                worker.iops_latency_histo_rwmix.add_latencies_array(lat[rd])
                worker.iops_latency_histo.add_latencies_array(lat[~rd])
            else:
                worker.iops_latency_histo.add_latencies_array(lat)
        worker.live_ops.num_entries_done += done
        worker.live_ops.num_iops_done += num_blocks - rwmix_blocks
        worker.live_ops.num_bytes_done += bytes_done.value - rwmix_bytes
        worker.live_ops_rwmix_read.num_iops_done += rwmix_blocks
        worker.live_ops_rwmix_read.num_bytes_done += rwmix_bytes
        worker._num_iops_submitted += num_blocks
        worker.create_stonewall_stats_if_triggered()


def get_native_engine() -> "_NativeEngine | None":
    """The engine, built from the port's csrc/ioengine.cpp on first call;
    None on a machine without g++. A failed build raises."""
    global _engine
    with _lock:
        if _engine is None:
            from ..ops.cuda_build import find_gxx, load_host_library
            if find_gxx() is None:
                return None
            engine = _NativeEngine(load_host_library("ioengine"))
            if engine.abi_version() != EXPECTED_ABI:
                raise RuntimeError(
                    f"csrc/ioengine.cpp reports ABI {engine.abi_version()}, "
                    f"this wrapper expects {EXPECTED_ABI}")
            _engine = engine
        return _engine
