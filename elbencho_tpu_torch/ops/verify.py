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


_kernel_lock = threading.Lock()
_kernel = None
_sm_counts: "dict[int, int]" = {}


def load_kernel():
    """Build (first call) and bind the CUDA library; returns the C
    function. Called outside timed loops by the device context."""
    global _kernel
    with _kernel_lock:
        if _kernel is None:
            from .cuda_build import load_library
            fn = load_library("fingerprint").fingerprint_u32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _kernel = fn
        return _kernel


def _grid_size(device: torch.device, n_words: int) -> int:
    """About 4 blocks per SM, fewer when the block is small (256 threads
    of 4 words each per block)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = _sm_counts.get(idx)
    if sms is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_counts[idx] = sms
    return max(1, min(4 * sms, -(-n_words // 1024)))


def fingerprint_u32(words: torch.Tensor) -> torch.Tensor:
    """(sum mod 2^32, xor) of a contiguous 1-D int32 tensor of words, as
    a (2,) int32 tensor of uint32 bits. A CUDA tensor goes through the
    CUDA kernel on the current stream (no synchronisation); a CPU tensor
    through the plain version. Any other device raises."""
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
    out = torch.zeros(2, dtype=torch.int32, device=words.device)
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = kernel(words.data_ptr(), words.numel(), out.data_ptr(),
                 _grid_size(words.device, words.numel()), stream)
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
