"""ctypes wrapper of the native C++ I/O engine (csrc/ioengine.cpp).

Reference: elbencho_tpu/utils/native.py, cut to what the port calls: the
streaming ring of the fused ``--gpustream`` loop (``NativeStream``) and
the classic block loop of phases without a device (``run_block_loop``).
The engine's source is the port's own copy, ``csrc/ioengine.cpp`` (ABI
11), built with g++ at first use into ``_build/`` by
``ops/cuda_build.load_host_library``. The net, mmap, per-file and
registered-pool entry points are later slices.
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

_lock = threading.Lock()
_engine = None


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


def _account_chunk(worker, lat_arr, n: int, bytes_done: int,
                   total_bytes: int) -> None:
    """Post-chunk accounting of the block loop and the fused stream: a
    complete chunk books every latency and counter exactly; an
    interrupted one, whose completions may be out of order, books the
    done-prefix estimate and no latencies."""
    if bytes_done == total_bytes:
        worker.iops_latency_histo.add_latencies_array(
            np.frombuffer(lat_arr, dtype=np.uint64))
        worker.live_ops.num_iops_done += n
    else:
        avg_len = max(total_bytes // n, 1)
        worker.live_ops.num_iops_done += min(n, bytes_done // avg_len)
    worker.live_ops.num_bytes_done += bytes_done
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

    def submit(self, slot: int, fd_idx: int, offset: int, length: int,
               is_write: bool) -> None:
        ret = self._lib.ioengine_stream_submit(
            self._handle, slot, fd_idx, offset, length,
            1 if is_write else 0)
        if ret < 0:
            raise NativeStreamError(-ret, f"stream submit slot {slot}")

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
        lib.ioengine_stream_backend.restype = ctypes.c_int
        lib.ioengine_stream_backend.argtypes = []
        self._stream_backend = None  # kernel capability, probed once

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
            self._stream_backend = int(self._lib.ioengine_stream_backend())
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
                       engine: str = "auto", verify_salt: int = 0) -> None:
        """One chunk of the block loop in C++: fd_idx (uint32 array, or
        None for one file) selects the file of each block, offsets are
        in-file offsets. The engine fills each write slot from buf_addr,
        or with the verify pattern under verify_salt, and checks reads
        against it, raising NativeVerifyError at the first mismatch.
        Counters and latencies are booked on the worker."""
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
            ctypes.byref(interrupt_flag), ENGINE_CODES[engine], None,
            verify_salt, 1 if verify_salt else 0, 0, 0, verify_info, 0, 0,
            None, 0, 0, -1, 0, worker.rank)
        if ret == -_EILSEQ:
            raise NativeVerifyError(*(int(v) for v in verify_info))
        if ret < 0:
            raise OSError(-ret, os.strerror(-ret))
        _account_chunk(worker, lat_arr, n, bytes_done.value,
                       int(lengths.sum()))


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
