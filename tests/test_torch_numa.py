"""Worker placement of the port (``--cores``, ``--zones``) against the JAX
package at tolerance 0: the NUMA module's syscall table, constants and
cpulist parse; each worker thread's CPU affinity and memory policy and
its staging slabs' policy after preparation, through both CLIs with and
without a device (``device="cpu"``); the missing zone's log line; the
precedence of ``--cores``; and the failures of lists that do not parse.

The syscalls are real. The tests skip, as the JAX package's
(tests/test_numa_mempolicy.py), only where the environment refuses
them: no NUMA sysfs, no syscall table for the arch, or get_mempolicy
blocked (seccomp)."""

import ctypes
import mmap
import os
import re

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.utils import numa as jax_numa
from elbencho_tpu.utils import staging_pool as jax_sp
from elbencho_tpu.workers import local_worker as jax_lw
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.utils import numa as port_numa
from elbencho_tpu_torch.utils import staging_pool as port_sp
from elbencho_tpu_torch.workers import local_worker as port_lw

torch.set_num_threads(1)

BOUND = (port_numa.MPOL_BIND, 1)      # MPOL_BIND on node 0
DEFAULT = (port_numa.MPOL_DEFAULT, 0)
ZONE_MISSING = "NUMA zone 63 not found or empty; skipping binding"


def require_mempolicy():
    if not port_numa.numa_is_available():
        pytest.skip("no NUMA sysfs on this box")
    if port_numa._syscall_table() is None:
        pytest.skip("no syscall table for this arch")
    if port_numa.get_thread_mempolicy() is None:
        pytest.skip("get_mempolicy blocked (seccomp?)")


# ----------------------------------------------------------------------
# the module: tables, constants, the cpulist parse
# ----------------------------------------------------------------------

def test_syscall_tables_and_constants_equal_the_jax_package():
    assert port_numa._SYSCALLS == jax_numa._SYSCALLS
    assert port_numa._SYSCALLS["x86_64"] == {
        "mbind": 237, "set_mempolicy": 238, "get_mempolicy": 239}
    assert port_numa._SYSCALLS["aarch64"] == {
        "mbind": 235, "set_mempolicy": 237, "get_mempolicy": 236}
    for name in ("MPOL_DEFAULT", "MPOL_PREFERRED", "MPOL_BIND",
                 "MPOL_INTERLEAVE", "MPOL_MF_MOVE", "MPOL_F_NODE",
                 "MPOL_F_ADDR", "_MAXNODE"):
        assert getattr(port_numa, name) == getattr(jax_numa, name), name
    assert port_numa._syscall_table() == jax_numa._syscall_table()
    assert port_numa.numa_is_available() == jax_numa.numa_is_available()


@pytest.mark.parametrize("spec", ["0-7", "0-3,8-11", "5", "", "0,2,4-6\n",
                                  "0-1,3,5-5"])
def test_cpulist_parse_equals_the_jax_package(monkeypatch, spec):
    def fake_open(path, *args, **kwargs):
        assert path == "/sys/devices/system/node/node3/cpulist"
        import io
        return io.StringIO(spec)

    monkeypatch.setattr(port_numa, "open", fake_open, raising=False)
    monkeypatch.setattr(jax_numa, "open", fake_open, raising=False)
    assert port_numa._node_cpus(3) == jax_numa._node_cpus(3)


@pytest.mark.parametrize("zone", [0, 63])
def test_node_cpus_of_this_machine_equal_the_jax_package(zone):
    assert port_numa._node_cpus(zone) == jax_numa._node_cpus(zone)


def test_thread_policy_bind_and_reset_in_both():
    require_mempolicy()
    for mod in (port_numa, jax_numa):
        try:
            assert mod.set_thread_mempolicy_bind(0)
            assert port_numa.get_thread_mempolicy() == BOUND
            assert jax_numa.get_thread_mempolicy() == BOUND
        finally:
            assert mod.reset_thread_mempolicy()
        assert mod.get_thread_mempolicy() == DEFAULT


# ----------------------------------------------------------------------
# the staging slabs: bound right after their mmap, in both packages
# ----------------------------------------------------------------------

def slab_binds(module, numa_module, monkeypatch, served: bool):
    """The mbind calls of one pool of `module` with zone 0 (4 slots of
    5000 bytes, MAP_HUGETLB served by a normal mapping or refused) and
    one alloc_aux: (length, zone, the mapping's first byte at the call)
    each, then the slots' and aux buffers' policies."""
    real_mmap = mmap.mmap
    real_bind = numa_module.mbind_buffer
    calls = []

    def spy_map(fileno, length, **kw):
        if kw.get("flags", 0) & module._MAP_HUGETLB:
            if not served:
                raise OSError(12, "Cannot allocate memory")
            return real_mmap(fileno, length)
        return real_mmap(fileno, length, **kw)

    def spy_bind(addr, length, zone):
        calls.append((length, zone, ctypes.c_ubyte.from_address(addr).value))
        return real_bind(addr, length, zone)

    class Fill:
        def fill_buffer(self, n):
            return b"\xa5" * n

    monkeypatch.setattr(module.mmap, "mmap", spy_map)
    monkeypatch.setattr(numa_module, "mbind_buffer", spy_bind)
    kw = {"register": False, "log_rank": None} if module is jax_sp else {}
    pool = module.StagingPool(4, 5000, numa_zone=0, fill_algo=Fill(), **kw)
    try:
        aux = pool.alloc_aux(2, 16384)
        policies = [numa_module.get_buffer_policy(a)
                    for a in pool.slot_addrs]
        policies += [numa_module.get_buffer_policy(
            ctypes.addressof(ctypes.c_char.from_buffer(mv))) for mv in aux]
        return calls, policies
    finally:
        pool.close()
        monkeypatch.setattr(module.mmap, "mmap", real_mmap)


@pytest.mark.parametrize("served", [True, False], ids=["hugetlb", "plain"])
def test_slabs_are_bound_before_the_fill_as_the_jax_package(monkeypatch,
                                                           served):
    require_mempolicy()
    port = slab_binds(port_sp, port_numa, monkeypatch, served)
    jax = slab_binds(jax_sp, jax_numa, monkeypatch, served)
    calls, policies = port
    # the slot slab (2 MiB when hugetlb serves it), then the aux slab;
    # each bound while its pages still hold the mapping's zeros
    slots = 2 << 20 if served else 4 * 8192
    assert calls == [(slots, 0, 0), (2 * 16384, 0, 0)]
    assert policies == [BOUND] * 6
    if served:
        # the port's aux slabs are normal mappings; the JAX package's
        # take the hugepage ladder too, so its aux bind covers 2 MiB
        assert jax == ([calls[0], (2 << 20, 0, 0)], policies)
    else:
        assert port == jax


class FakeCudart:
    def __init__(self, order):
        self.order = order

    def cudaHostRegister(self, base, nbytes, flags):
        self.order.append(("register", nbytes))
        return 0

    def cudaHostUnregister(self, base):
        return 0


def test_slabs_are_bound_before_they_are_page_locked(monkeypatch):
    """cudaHostRegister locks the pages, which could then not move: every
    slab (slots and a registered aux slab) is bound first."""
    order = []
    real_bind = port_numa.mbind_buffer
    monkeypatch.setattr(torch.cuda, "cudart", lambda: FakeCudart(order))
    monkeypatch.setattr(port_numa, "mbind_buffer", lambda a, n, z: (
        order.append(("mbind", n)), real_bind(a, n, z))[1])
    pool = port_sp.StagingPool(2, 4096, numa_zone=0)
    try:
        with pytest.raises(RuntimeError, match="not see the staging slab"):
            pool.register_slots()  # this box's torch sees nothing pinned
        with pytest.raises(RuntimeError, match="not see the staging slab"):
            pool.alloc_aux(3, 4096, register=True)
    finally:
        pool.close()
    slots = [n for _k, n in order][0]
    assert order == [("mbind", slots), ("register", slots),
                     ("mbind", 3 * 4096), ("register", 3 * 4096)]


def test_a_pool_without_a_zone_binds_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(port_numa, "mbind_buffer",
                        lambda *a: calls.append(a))
    pool = port_sp.StagingPool(2, 4096)
    try:
        pool.alloc_aux(1, 4096)
        assert pool.numa_zone is None and calls == []
    finally:
        pool.close()


# ----------------------------------------------------------------------
# the CLI: each worker thread's placement in both packages
# ----------------------------------------------------------------------

def placements(monkeypatch, lw_module, numa_module, run):
    """Run `run()` with a spy after each worker's preparation, on the
    worker's own thread: its affinity, thread policy and zone, and the
    policies of its I/O slots and of an aux slab carved then; returns
    {rank: placement} (and the port's every slab under "slabs")."""
    seen = {}
    real = lw_module.LocalWorker.prepare

    def spy(self):
        real(self)
        pool = self._staging_pool
        aux = pool.alloc_aux(2, 16384)
        seen[self.rank] = {
            "affinity": sorted(os.sched_getaffinity(0)),
            "thread": numa_module.get_thread_mempolicy(),
            "zone": self._numa_zone,
            "slots": sorted({numa_module.get_buffer_policy(a)
                             for a in pool.slot_addrs}),
            "aux": sorted({numa_module.get_buffer_policy(
                ctypes.addressof(ctypes.c_char.from_buffer(mv)))
                for mv in aux}),
        }
        if lw_module is port_lw:
            seen[self.rank]["slabs"] = sorted(
                {numa_module.get_buffer_policy(s.base) for s in pool._slabs})

    monkeypatch.setattr(lw_module.LocalWorker, "prepare", spy)
    rc = run()
    monkeypatch.setattr(lw_module.LocalWorker, "prepare", real)
    return rc, seen


def both(monkeypatch, tmp_path, flags, device):
    """`flags` through both CLIs at -w -t 4 -s 64K -b 4K, with --gpuids 0
    (--tpuids 0) when `device`; returns ((rc, placements) of the JAX
    package, the same of the port with its "slabs" entries apart)."""
    common = ["-w", "-t", "4", "-s", "64K", "-b", "4K", "--nolive",
              *flags]
    jax = placements(monkeypatch, jax_lw, jax_numa, lambda: jax_main(
        common + (["--tpuids", "0"] if device else [])
        + [str(tmp_path / "jax.bin")]))
    port = placements(monkeypatch, port_lw, port_numa, lambda: port_main(
        common + (["--gpuids", "0"] if device else [])
        + [str(tmp_path / "port.bin")], device="cpu"))
    slabs = {rank: p.pop("slabs") for rank, p in port[1].items()}
    return jax, port, slabs


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("cores", ["0,1", "1"])
def test_cores_give_each_worker_the_jax_packages_affinity(
        monkeypatch, tmp_path, cores, device):
    jax, port, _slabs = both(monkeypatch, tmp_path, ["--cores", cores],
                             device)
    assert port == jax
    rc, seen = port
    assert rc == 0 and sorted(seen) == [0, 1, 2, 3]
    listed = [int(c) for c in cores.split(",")]
    for rank, p in seen.items():
        if set(listed) <= os.sched_getaffinity(0):
            assert p["affinity"] == [listed[rank % len(listed)]]
        assert p["thread"] == DEFAULT and p["zone"] is None
        assert p["slots"] == p["aux"] == [DEFAULT]


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_zones_bind_each_worker_and_its_slabs_as_the_jax_package(
        monkeypatch, tmp_path, device):
    require_mempolicy()
    jax, port, slabs = both(monkeypatch, tmp_path, ["--zones", "0"], device)
    assert port == jax
    rc, seen = port
    assert rc == 0 and sorted(seen) == [0, 1, 2, 3]
    for rank, p in seen.items():
        assert p["affinity"] == sorted(port_numa._node_cpus(0)
                                       & set(p["affinity"]))
        assert p["thread"] == BOUND and p["zone"] == 0
        assert p["slots"] == p["aux"] == [BOUND]
        # the device context's bounce and mirror slabs too
        assert slabs[rank] == [BOUND]


def test_a_missing_zone_logs_the_jax_line_and_exits_0(monkeypatch,
                                                      tmp_path, capfd):
    jax, port, _slabs = both(monkeypatch, tmp_path, ["--zones", "63"],
                             True)
    err = capfd.readouterr().err
    assert err.count(ZONE_MISSING) == 8  # four workers in each package
    assert port == jax
    rc, seen = port
    assert rc == 0
    for p in seen.values():
        assert p["zone"] is None and p["thread"] == DEFAULT


def test_cores_win_over_zones_as_in_the_jax_package(monkeypatch, tmp_path):
    jax, port, slabs = both(monkeypatch, tmp_path,
                            ["--cores", "0", "--zones", "0"], True)
    assert port == jax
    rc, seen = port
    assert rc == 0
    for rank, p in seen.items():
        assert p["affinity"] == [0] and p["thread"] == DEFAULT
        assert p["zone"] is None and slabs[rank] == [DEFAULT]


def error_lines(text: str) -> "list[str]":
    """The ERROR lines without their timestamps, sorted (the workers'
    threads log in any order)."""
    return sorted(re.sub(r"^\S+ \S+ ", "", ln) for ln in text.splitlines()
                  if " ERROR: " in ln)


@pytest.mark.parametrize("flag,value", [
    ("--cores", "abc"), ("--cores", "0x1"), ("--cores", "1,-2"),
    ("--cores", "1,,0"), ("--cores", " "), ("--zones", "zero"),
    ("--zones", "0,,0")])
def test_lists_that_do_not_parse_fail_alike(monkeypatch, tmp_path, capfd,
                                            flag, value):
    args = ["-w", "-t", "2", "-s", "64K", "-b", "4K", "--nolive", flag,
            value]
    jrc = jax_main(args + [str(tmp_path / "jax.bin")])
    jerr = error_lines(capfd.readouterr().err)
    prc = port_main(args + [str(tmp_path / "port.bin")], device="cpu")
    perr = error_lines(capfd.readouterr().err)
    assert (prc, perr) == (jrc, jerr)
    if value in ("abc", "0x1", "zero"):
        assert prc != 0 and any("worker preparation failed: invalid "
                                "literal for int()" in ln for ln in perr)
