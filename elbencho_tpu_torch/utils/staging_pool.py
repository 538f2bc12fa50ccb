"""Page-aligned staging allocator of a worker's host I/O buffers.

Reference: elbencho_tpu/utils/staging_pool.py, cut to what the port's
Python block loop needs: ONE anonymous ``mmap`` slab with one page-aligned
slot per ``--iodepth`` (O_DIRECT-safe), pre-filled with random data, plus
``alloc_aux`` for auxiliary page-aligned buffers with the same lifecycle
(the device context's bounce, ``--gpubatch`` aggregation and host mirror
buffers).

The I/O slots' slab takes the JAX package's hugepage ladder: a
``MAP_HUGETLB`` mapping first (its size rounded up to 2 MiB), unless
``--madv nohugepage`` is given; else a normal mapping, advised
``MADV_HUGEPAGE`` under ``--madv hugepage`` and ``MADV_NOHUGEPAGE`` under
``nohugepage`` (advice the kernel refuses is ignored: it is advisory).
``hugepage_backed`` says which mapping the slots got. The auxiliary slabs
are always normal mappings (the JAX package's take the ladder too).

Under ``--gpudirect`` the device context has the slot slab registered
ONCE with the CUDA driver (``cudaHostRegister``, upstream elbencho's
``--cuhostbufreg``): the pages are locked, so an asynchronous copy reads
or writes them by DMA without a bounce buffer. That takes the place of the
JAX package's pool-wide io_uring fixed-buffer registration: the fused
``--gpustream`` ring registers the slots (``slot_addrs``) as fixed
buffers of its own per-phase ring. A ``cudaHostRegister`` that fails
raises: the port has no unregistered fallback, whichever mapping the
slab got. The pool-registered persistent ring and SQPOLL are not ported.

Under ``--zones`` the pool takes the worker's zone (``numa_zone``), and
every slab, the I/O slots' and each ``alloc_aux`` one, is ``mbind``-ed
to it (MPOL_BIND, MPOL_MF_MOVE; utils/numa.py) right after its ``mmap``:
before the fill touches a page, so nothing has to migrate, and before
``cudaHostRegister`` locks the pages, after which they could not move.
The ``MAP_HUGETLB`` slab takes the same bind. A refused bind is logged
and leaves the slab unbound, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import mmap

from ..toolkits.units import parse_flag_list

#: O_DIRECT-safe slot stride
SLOT_ALIGN = 4096

#: hugetlb mappings must be multiples of the huge page size
HUGE_PAGE_BYTES = 2 << 20

_MAP_HUGETLB = getattr(mmap, "MAP_HUGETLB", 0x40000)

#: --madv names and their advice (reference: ARG_MADVISE_FLAG_*_NAME);
#: the slab takes the two hugepage ones, the worker's mappings all
MADVISE = {"seq": mmap.MADV_SEQUENTIAL, "rand": mmap.MADV_RANDOM,
           "willneed": mmap.MADV_WILLNEED, "dontneed": mmap.MADV_DONTNEED,
           "hugepage": getattr(mmap, "MADV_HUGEPAGE", 14),
           "nohugepage": getattr(mmap, "MADV_NOHUGEPAGE", 15)}

#: slabs kept mapped for the life of the process after a stream ring's
#: drain failed with kernel-owned ops still in flight: unmapping them
#: would hand a late completion unmapped address space
_LEAKED_SLABS: "list[_Slab]" = []


def _align_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


def _map_slab(nbytes: int,
              madvise: "set[str]") -> "tuple[mmap.mmap, bool]":
    """The hugepage ladder (reference: StagingPool._map_slab): a
    hugetlb mapping unless nohugepage is asked for, else a normal one
    with the asked transparent-hugepage advice; returns (mapping, whether
    hugetlb backs it)."""
    no_huge = "nohugepage" in madvise
    if not no_huge:
        try:
            return mmap.mmap(-1, _align_up(nbytes, HUGE_PAGE_BYTES),
                             flags=(mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                                    | _MAP_HUGETLB)), True
        except (OSError, ValueError):
            pass  # no reserved hugepages (the common case): map normally
    m = mmap.mmap(-1, nbytes)
    try:
        if no_huge:
            m.madvise(MADVISE["nohugepage"])
        elif "hugepage" in madvise:
            m.madvise(MADVISE["hugepage"])
    except OSError:
        pass  # advice is advisory; a kernel refusing it is fine
    return m, False


class _Slab:
    """One anonymous mapping carved into page-aligned views; the I/O
    slots' slab takes the hugepage ladder (``madvise`` not None)."""

    def __init__(self, count: int, nbytes: int,
                 madvise: "set[str] | None" = None,
                 numa_zone: "int | None" = None):
        self.stride = stride = _align_up(max(nbytes, 1), SLOT_ALIGN)
        if madvise is None:
            self.mapping, self.hugepage_backed = \
                mmap.mmap(-1, stride * count), False
        else:
            self.mapping, self.hugepage_backed = _map_slab(stride * count,
                                                           madvise)
        self.base = ctypes.addressof(ctypes.c_char.from_buffer(self.mapping))
        if numa_zone is not None:
            # before any page is touched or locked (module docstring)
            from .numa import mbind_buffer
            mbind_buffer(self.base, len(self.mapping), numa_zone)
        self.registered = False
        self.whole = memoryview(self.mapping)
        self.views = [self.whole[i * stride: i * stride + nbytes]
                      for i in range(count)]

    def register(self) -> None:
        """Page-lock the mapping for DMA; raises if the driver refuses or
        torch does not then see the memory as pinned (a non_blocking copy
        from memory that is not page-locked runs synchronously). Flags 0
        serve every card of the host: each sees the slab as pinned and
        copies from it asynchronously (chip_multigpu.py's
        register_flags_probe), so a worker that fails over to another GPU
        (--gpufallback chip) uses the same slots without registering them
        again, which the driver refuses."""
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

    def __init__(self, n_slots: int, slot_size: int, *, fill_algo=None,
                 madvise_flags: str = "",
                 numa_zone: "int | None" = None):
        self.n_slots = max(n_slots, 0)
        self.slot_size = max(slot_size, 1)
        #: the --zones zone every slab is bound to, or None
        self.numa_zone = numa_zone
        self._slabs: "list[_Slab]" = []
        self._slots = None
        self.views: "list[memoryview]" = []
        #: the I/O slots lie in a MAP_HUGETLB mapping
        self.hugepage_backed = False
        if self.n_slots:
            self._slots = _Slab(self.n_slots, self.slot_size,
                                madvise=set(parse_flag_list(madvise_flags)),
                                numa_zone=numa_zone)
            self._slabs.append(self._slots)
            self.views = self._slots.views
            self.hugepage_backed = self._slots.hugepage_backed
        if fill_algo is not None:
            # pre-fill with random data so writes aren't trivially
            # compressible (same contract as the JAX package's pool)
            for mv in self.views:
                mv[:] = fill_algo.fill_buffer(self.slot_size)

    def _map(self, count: int, nbytes: int) -> _Slab:
        slab = _Slab(count, nbytes, numa_zone=self.numa_zone)
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
        """Carve `count` page-aligned buffers of `nbytes`, bound to the
        pool's zone and page-locked when asked; freed by close()."""
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
