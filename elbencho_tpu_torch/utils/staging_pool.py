"""Page-aligned staging allocator of a worker's host I/O buffers.

Reference: elbencho_tpu/utils/staging_pool.py, cut to what the port's
Python block loop needs: ONE anonymous ``mmap`` slab with one page-aligned
slot per ``--iodepth`` (O_DIRECT-safe), pre-filled with random data, plus
``alloc_aux`` for auxiliary page-aligned buffers with the same lifecycle
(the device context's bounce, ``--gpubatch`` aggregation and host mirror
buffers).

Under ``--gpudirect`` the device context has the slot slab registered
ONCE with the CUDA driver (``cudaHostRegister``, upstream elbencho's
``--cuhostbufreg``): the pages are locked, so an asynchronous copy reads
or writes them by DMA without a bounce buffer. That takes the place of the
JAX package's pool-wide io_uring fixed-buffer registration: the fused
``--gpustream`` ring registers the slots (``slot_addrs``) as fixed
buffers of its own per-phase ring. A ``cudaHostRegister`` that fails
raises: the port has no unregistered fallback. Hugepages, NUMA binding,
the pool-registered persistent ring and SQPOLL are not ported.
"""

from __future__ import annotations

import ctypes
import mmap

#: O_DIRECT-safe slot stride
SLOT_ALIGN = 4096

#: slabs kept mapped for the life of the process after a stream ring's
#: drain failed with kernel-owned ops still in flight: unmapping them
#: would hand a late completion unmapped address space
_LEAKED_SLABS: "list[_Slab]" = []


def _align_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


class _Slab:
    """One anonymous mapping carved into page-aligned views."""

    def __init__(self, count: int, nbytes: int):
        self.stride = stride = _align_up(max(nbytes, 1), SLOT_ALIGN)
        self.mapping = mmap.mmap(-1, stride * count)
        self.base = ctypes.addressof(ctypes.c_char.from_buffer(self.mapping))
        self.registered = False
        self.whole = memoryview(self.mapping)
        self.views = [self.whole[i * stride: i * stride + nbytes]
                      for i in range(count)]

    def register(self) -> None:
        """Page-lock the mapping for DMA; raises if the driver refuses or
        torch does not then see the memory as pinned (a non_blocking copy
        from memory that is not page-locked runs synchronously)."""
        import torch
        err = torch.cuda.cudart().cudaHostRegister(
            self.base, len(self.mapping), 0)
        if int(err) != 0:
            raise RuntimeError(
                f"cudaHostRegister of a {len(self.mapping)}-byte staging "
                f"slab failed (cudaError {int(err)})")
        self.registered = True
        if not torch.frombuffer(self.whole, dtype=torch.uint8).is_pinned():
            raise RuntimeError("cudaHostRegister succeeded, but torch does "
                               "not see the staging slab as pinned")

    def close(self) -> None:
        if self.registered:
            import torch
            torch.cuda.cudart().cudaHostUnregister(self.base)
            self.registered = False
        for mv in self.views + [self.whole]:
            try:
                mv.release()
            except BufferError:
                pass  # exported to a live tensor: the OS reclaims at exit
        try:
            self.mapping.close()
        except BufferError:
            pass


class StagingPool:
    """Per-worker staging slab; the hot loop addresses slots by rotation
    index (``views[i]``, the worker's ``% n_slots`` discipline)."""

    def __init__(self, n_slots: int, slot_size: int, *, fill_algo=None):
        self.n_slots = max(n_slots, 0)
        self.slot_size = max(slot_size, 1)
        self._slabs: "list[_Slab]" = []
        self._slots = None
        self.views: "list[memoryview]" = []
        if self.n_slots:
            self._slots = self._map(self.n_slots, self.slot_size)
            self.views = self._slots.views
        if fill_algo is not None:
            # pre-fill with random data so writes aren't trivially
            # compressible (same contract as the JAX package's pool)
            for mv in self.views:
                mv[:] = fill_algo.fill_buffer(self.slot_size)

    def _map(self, count: int, nbytes: int) -> _Slab:
        slab = _Slab(count, nbytes)
        self._slabs.append(slab)
        return slab

    @property
    def slot_addrs(self) -> "list[int]":
        """The page-aligned base address of each I/O slot."""
        slab = self._slots
        return [slab.base + i * slab.stride for i in range(self.n_slots)]

    @property
    def registered(self) -> bool:
        return self._slots is not None and self._slots.registered

    def register_slots(self) -> None:
        """Page-lock the I/O slots once (idempotent)."""
        if self._slots is not None and not self._slots.registered:
            self._slots.register()

    def alloc_aux(self, count: int, nbytes: int,
                  register: bool = False) -> "list[memoryview]":
        """Carve `count` page-aligned buffers of `nbytes`, page-locked when
        asked; freed by close()."""
        slab = self._map(count, nbytes)
        if register:
            slab.register()
        return slab.views

    def leak(self) -> None:
        """Keep every slab mapped (and registered) until process exit:
        called when kernel DMA may still target the slots after a failed
        stream-ring drain."""
        _LEAKED_SLABS.extend(self._slabs)
        self._slabs = []

    def close(self) -> None:
        """Unregister and unmap every slab."""
        for slab in self._slabs:
            slab.close()
        self._slabs = []
        self._slots = None
        self.views = []
