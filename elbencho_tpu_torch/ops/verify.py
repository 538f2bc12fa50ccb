"""On-device integrity verification (--gpuverify).

Reference: elbencho_tpu/ops/verify.py. The host-side verify
(LocalWorker::postReadIntegrityCheckVerifyBuf, LocalWorker.cpp:2170)
compares every 64-bit word against ``offset + salt``. On the GPU a block
already resident in device memory is reduced to a (sum mod 2^32, xor)
fingerprint of its 32-bit words by the hand-written CUDA kernel in
``csrc/fingerprint.cu`` and compared against closed-form expected values
computed on the host, without a device->host copy of the block.

``fingerprint_u32`` is the kernel's wrapper; ``fingerprint_u32_plain`` is
its plain PyTorch version, which the wrapper takes only for a tensor on the
CPU. Both return the (sum, xor) pair as a (2,) int32 tensor holding the
uint32 bit patterns.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch


class LaunchCounter:
    """Kernel launches made by a wrapper (thread-safe: workers are
    threads). chip_smoke.py zeroes it before the main path and reads it
    after, to show the path went through the kernel."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def expected_fingerprint_host(file_offset: int, length: int,
                              salt: int) -> "tuple[int, int]":
    """Closed-form (sum mod 2^32, xor) of the uint32-word view of the
    verify pattern for [file_offset, file_offset+length)."""
    n_words64 = length // 8
    i = np.arange(n_words64, dtype=np.uint64)
    with np.errstate(over="ignore"):
        vals = np.uint64(file_offset) + np.uint64(salt) + i * np.uint64(8)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (vals >> np.uint64(32)).astype(np.uint32)
    s = (int(lo.sum(dtype=np.uint64)) + int(hi.sum(dtype=np.uint64))) \
        & 0xFFFFFFFF
    x = int(np.bitwise_xor.reduce(lo) ^ np.bitwise_xor.reduce(hi)) \
        if n_words64 else 0
    return s, x


def _as_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def fingerprint_u32_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch (sum mod 2^32, xor) of an int32 word tensor: the sum
    in int64 masked to 32 bits (a signed sum differs from the unsigned one
    by multiples of 2^32), the xor as a pairwise fold (torch's uint32 lacks
    add and shifts on the CPU)."""
    s = words.to(torch.int64).sum() & 0xFFFFFFFF
    x = words.reshape(-1)
    if x.numel() == 0:
        x = words.new_zeros(1)
    while x.numel() > 1:
        half = x.numel() // 2
        folded = torch.bitwise_xor(x[:half], x[half:2 * half])
        if x.numel() % 2:
            folded[0] ^= x[-1]
        x = folded
    return torch.stack([_as_int32_bits(s), x[0]])


#: vectors (16 bytes each) that one block of csrc/fingerprint.cu reads per
#: step: kThreads (256) threads times kUnroll (4) loads each. The plan
#: rounds each block's chunk to whole steps, so only the last block has a
#: ragged one; the kernel is exact for any chunk. load_kernel checks that
#: the built library's kTile agrees.
TILE_VECS = 256 * 4


class FingerprintPlan(NamedTuple):
    """How the kernel cuts n words: block 0 adds the ``head`` words before
    the first 16-byte boundary and the ``tail`` words after the body; the
    body's ``n_vec`` 16-byte vectors go to ``grid`` blocks, block b taking
    vectors [b * chunk, min((b + 1) * chunk, n_vec))."""
    head: int
    n_vec: int
    chunk: int
    grid: int
    tail: int


def fingerprint_plan(n_words: int, addr_mod16: int, sm_count: int,
                     blocks_per_sm: int) -> FingerprintPlan:
    """The partition of [0, n_words) for words starting at an address
    that is ``addr_mod16`` modulo 16, on a persistent grid of at most
    ``sm_count * blocks_per_sm`` blocks (as many as fit on the card at
    once), each taking one contiguous chunk of whole steps."""
    if addr_mod16 not in (0, 4, 8, 12):
        raise ValueError(f"fingerprint_plan: words must be 4-byte aligned, "
                         f"address mod 16 is {addr_mod16}")
    if n_words < 0 or sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"fingerprint_plan: bad arguments {n_words}, "
                         f"{sm_count}, {blocks_per_sm}")
    head = min(n_words, ((16 - addr_mod16) & 15) >> 2)
    n_vec = (n_words - head) >> 2
    per_block = -(-n_vec // (sm_count * blocks_per_sm))
    chunk = max(1, -(-per_block // TILE_VECS)) * TILE_VECS
    return FingerprintPlan(head=head, n_vec=n_vec, chunk=chunk,
                           grid=max(1, -(-n_vec // chunk)),
                           tail=n_words - head - 4 * n_vec)


_kernel_lock = threading.Lock()
_kernel = None
#: device index -> (SMs, blocks of the kernel per SM)
_launch_shapes: "dict[int, tuple[int, int]]" = {}
_scratch_lock = threading.Lock()
#: (device index, stream id) -> that stream's scratch (counter + partials)
_scratches: "dict[tuple[int, int], torch.Tensor]" = {}


def load_kernel():
    """Build (first call) and bind the CUDA library; returns the C
    function. Called outside timed loops by the device context."""
    global _kernel
    with _kernel_lock:
        if _kernel is None:
            from .cuda_build import load_library
            lib = load_library("fingerprint")
            lib.fingerprint_u32_tile_vecs.restype = ctypes.c_int
            tile = lib.fingerprint_u32_tile_vecs()
            if tile != TILE_VECS:
                raise RuntimeError(f"fingerprint_u32: the kernel's step is "
                                   f"{tile} vectors, the plan's {TILE_VECS}")
            fn = lib.fingerprint_u32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _kernel = fn
        return _kernel


def launch_shape(device_index: int) -> "tuple[int, int]":
    """(SMs, blocks of the kernel that fit on one SM) of a CUDA device,
    asked once per device."""
    shape = _launch_shapes.get(device_index)
    if shape is None:
        from .cuda_build import load_library
        query = load_library("fingerprint").fingerprint_u32_blocks_per_sm
        query.argtypes = [ctypes.POINTER(ctypes.c_int)]
        query.restype = ctypes.c_int
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device_index):
            err = query(ctypes.byref(blocks))
        if err or blocks.value < 1:
            raise RuntimeError(f"fingerprint_u32: occupancy query failed "
                               f"(cudaError {err}, {blocks.value} blocks)")
        shape = _launch_shapes[device_index] = (sms, blocks.value)
    return shape


def stream_scratch(device_index: int, stream_id: int, make):
    """The kernel's scratch for one (device, stream), made by ``make()``
    at first use and kept. Launches on one stream run in order, so one
    scratch per stream is free of races; two streams never share one."""
    key = (device_index, stream_id)
    with _scratch_lock:
        buf = _scratches.get(key)
        if buf is None:
            buf = _scratches[key] = make()
        return buf


def fingerprint_u32(words: torch.Tensor) -> torch.Tensor:
    """(sum mod 2^32, xor) of a contiguous 1-D int32 tensor of words, as
    a (2,) int32 tensor of uint32 bits. A CUDA tensor goes through the
    CUDA kernel on its device's current stream, one launch and no
    synchronisation (the first call on a stream also zero-fills that
    stream's scratch, once); the tensor's device is made the current one
    for the launch, whichever device the caller left current. A CPU
    tensor goes through the plain version. Any other device raises."""
    if words.dtype != torch.int32 or words.dim() != 1:
        raise ValueError(f"fingerprint_u32 takes a 1-D int32 tensor, got "
                         f"{words.dtype} of shape {tuple(words.shape)}")
    if words.device.type == "cpu":
        return fingerprint_u32_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"fingerprint_u32: unsupported device "
                         f"{words.device}")
    if not words.is_contiguous():
        raise ValueError("fingerprint_u32 takes a contiguous tensor")
    if words.data_ptr() % 4:
        raise ValueError("fingerprint_u32 takes a 4-byte aligned tensor")
    kernel = load_kernel()
    dev = words.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms, per_sm = launch_shape(idx)
    plan = fingerprint_plan(words.numel(), words.data_ptr() % 16, sms, per_sm)
    # a launch into a stream of another device than the current one
    # fails: a caller driving several devices leaves only one current
    with torch.cuda.device(idx):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = stream_scratch(idx, stream, lambda: torch.zeros(
            2 + 2 * sms * per_sm, dtype=torch.int32, device=dev))
        out = torch.empty(2, dtype=torch.int32, device=dev)
        err = kernel(words.data_ptr(), plan.head, plan.n_vec, plan.chunk,
                     plan.grid, plan.tail, out.data_ptr(),
                     scratch.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fingerprint_u32 kernel launch failed "
                           f"(cudaError {err})")
    fingerprint_u32.launches.add()
    return out


fingerprint_u32.launches = LaunchCounter()


def verify_block_on_device(words: torch.Tensor, file_offset: int,
                           length: int, salt: int) -> None:
    """Raise ValueError if the device-resident block (int32 words) does
    not match the verify pattern for its file offset. Reading the result
    synchronises with the device once per block, as the JAX package's
    int() of its fingerprint does."""
    got_sum, got_xor = (v & 0xFFFFFFFF
                        for v in fingerprint_u32(words).tolist())
    want_sum, want_xor = expected_fingerprint_host(file_offset, length, salt)
    if got_sum != want_sum or got_xor != want_xor:
        raise ValueError(
            f"on-device integrity check failed for block at offset "
            f"{file_offset}: fingerprint (sum={got_sum:#x}, xor={got_xor:#x})"
            f" != expected (sum={want_sum:#x}, xor={want_xor:#x})")
