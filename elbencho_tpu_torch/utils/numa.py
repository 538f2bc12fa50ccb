"""NUMA zone and core binding of the worker threads (``--zones``,
``--cores``).

Reference: elbencho_tpu/utils/numa.py (source/toolkits/NumaTk.h:22-320
of upstream elbencho, via libnuma: bindToNumaZones / setMemPolicy). Two
halves:

- CPU affinity: bind the calling thread to the CPUs of a NUMA node (the
  sysfs ``cpulist`` and ``sched_setaffinity``), the ``--zones``
  round-robin worker binding.
- Memory policy: libnuma is not a dependency, so the set_mempolicy,
  mbind and get_mempolicy syscalls are made directly through ctypes.
  ``bind_to_numa_zone`` applies MPOL_BIND to the thread (all its later
  page faults allocate on the zone), and ``mbind_buffer`` binds an
  mmap'd staging slab to the zone (MPOL_MF_MOVE migrates any page that
  faulted elsewhere first): the slots a worker copies to the card from
  live next to the cores driving them. A slab is bound before it is
  filled and before ``cudaHostRegister`` locks its pages, which can then
  no longer be moved (utils/staging_pool.py).

Every failure is logged with the JAX package's text and degrades to no
binding; none ends the run.
"""

from __future__ import annotations

import ctypes
import os
import platform

from ..toolkits import logger

# mode constants (linux/mempolicy.h)
MPOL_DEFAULT = 0
MPOL_PREFERRED = 1
MPOL_BIND = 2
MPOL_INTERLEAVE = 3
# mbind flags
MPOL_MF_MOVE = 1 << 1
# get_mempolicy flags
MPOL_F_NODE = 1 << 0
MPOL_F_ADDR = 1 << 1

#: syscall numbers differ per arch (no libc wrappers outside libnuma)
_SYSCALLS = {
    "x86_64": {"mbind": 237, "set_mempolicy": 238, "get_mempolicy": 239},
    "aarch64": {"mbind": 235, "set_mempolicy": 237, "get_mempolicy": 236},
}

_MAXNODE = 64  # one u64 nodemask covers every machine this targets


def _syscall_table() -> "dict[str, int] | None":
    return _SYSCALLS.get(platform.machine())


def _libc():
    return ctypes.CDLL(None, use_errno=True)


def _nodemask(zone: int) -> ctypes.c_uint64:
    return ctypes.c_uint64(1 << zone)


def set_thread_mempolicy_bind(zone: int) -> bool:
    """MPOL_BIND the calling thread's allocations to one node
    (reference: NumaTk setMemPolicy / numa_set_membind)."""
    table = _syscall_table()
    if table is None:
        return False
    mask = _nodemask(zone)
    res = _libc().syscall(table["set_mempolicy"], MPOL_BIND,
                          ctypes.byref(mask), _MAXNODE)
    if res != 0:
        logger.log_error(
            f"set_mempolicy(MPOL_BIND, node {zone}) failed: "
            f"{os.strerror(ctypes.get_errno())}")
        return False
    return True


def reset_thread_mempolicy() -> bool:
    """Back to MPOL_DEFAULT."""
    table = _syscall_table()
    if table is None:
        return False
    return _libc().syscall(table["set_mempolicy"], MPOL_DEFAULT,
                           None, _MAXNODE) == 0


def get_thread_mempolicy() -> "tuple[int, int] | None":
    """(mode, nodemask) of the calling thread, or None where the call is
    not supported."""
    table = _syscall_table()
    if table is None:
        return None
    mode = ctypes.c_int(0)
    mask = ctypes.c_uint64(0)
    res = _libc().syscall(table["get_mempolicy"], ctypes.byref(mode),
                          ctypes.byref(mask), _MAXNODE, None, 0)
    if res != 0:
        return None
    return mode.value, mask.value


def mbind_buffer(addr: int, length: int, zone: int) -> bool:
    """MPOL_BIND one mmap'd region to a node, migrating pages that already
    faulted (reference: NumaTk.h mbind of the GPU staging buffers). addr
    must be page-aligned, as an mmap allocation is."""
    table = _syscall_table()
    if table is None:
        return False
    mask = _nodemask(zone)
    res = _libc().syscall(table["mbind"], ctypes.c_void_p(addr),
                          ctypes.c_ulong(length), MPOL_BIND,
                          ctypes.byref(mask), _MAXNODE, MPOL_MF_MOVE)
    if res != 0:
        logger.log_error(
            f"mbind(node {zone}, {length} bytes) failed: "
            f"{os.strerror(ctypes.get_errno())}")
        return False
    return True


def get_buffer_policy(addr: int) -> "tuple[int, int] | None":
    """(mode, nodemask) governing an address (MPOL_F_ADDR), or None."""
    table = _syscall_table()
    if table is None:
        return None
    mode = ctypes.c_int(0)
    mask = ctypes.c_uint64(0)
    res = _libc().syscall(table["get_mempolicy"], ctypes.byref(mode),
                          ctypes.byref(mask), _MAXNODE,
                          ctypes.c_void_p(addr), MPOL_F_ADDR)
    if res != 0:
        return None
    return mode.value, mask.value


def _node_cpus(zone: int) -> "set[int]":
    path = f"/sys/devices/system/node/node{zone}/cpulist"
    try:
        with open(path) as f:
            spec = f.read().strip()
    except OSError:
        return set()
    cpus: "set[int]" = set()
    for part in spec.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            cpus.update(range(int(lo), int(hi) + 1))
        elif part:
            cpus.add(int(part))
    return cpus


def bind_to_numa_zone(zone: int) -> bool:
    """Bind the calling thread's CPU affinity and its memory policy to
    one NUMA zone, as the reference does (numa_run_on_node +
    set_mempolicy). A failed memory bind is logged and leaves the CPU
    binding in place."""
    cpus = _node_cpus(zone)
    if not cpus:
        logger.log_error(f"NUMA zone {zone} not found or empty; "
                         "skipping binding")
        return False
    try:
        os.sched_setaffinity(0, cpus)
    except OSError as err:
        logger.log_error(f"NUMA binding to zone {zone} failed: {err}")
        return False
    set_thread_mempolicy_bind(zone)
    return True


def numa_is_available() -> bool:
    return os.path.isdir("/sys/devices/system/node/node0")
