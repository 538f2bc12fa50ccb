"""Mixed and rate-shaped traffic of the port (device="cpu") against the
JAX package: --rwmixpct, --rwmixthr/--rwmixthrpct, --limitread/
--limitwrite and --blockvarpct/--blockvaralgo.

Ported from tests/test_tpu_stream_fused.py (the --rwmixpct write with
--verify over a pre-written file) and tests/test_tpubench_rwmixthr.py.
Each workload runs through both packages at -s 512K -b 4K: the port's
fused ring, its Python loop (staged and --gpudirect), its native block
loop and its Python host loop against the JAX package's. The file bytes,
each worker's normal and rwmix-read counts (ops, bytes, entries,
latencies), the device bytes and the fused-ring ops are compared at
tolerance 0; a rate only with its rule (a limited phase lasts at least
its windows). The limiters are held against the JAX classes under one
fake clock; the result rows, the CSV row and the live totals of a mixed
phase are rendered from one set of counts by both packages.
"""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.stats import statistics as jax_stats
from elbencho_tpu.toolkits import random_algos as jax_rand
from elbencho_tpu.toolkits import rate_limiter as jax_rl
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu.workers import local_worker as jax_lw
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.config.args import BenchConfig
from elbencho_tpu_torch.phases import BenchPhase
from elbencho_tpu_torch.stats import statistics as port_stats
from elbencho_tpu_torch.toolkits import random_algos as port_rand
from elbencho_tpu_torch.toolkits import rate_limiter as port_rl
from elbencho_tpu_torch.utils import native as port_native
from elbencho_tpu_torch.workers import local_worker as port_lw
from elbencho_tpu_torch.workers.manager import WorkerManager
from elbencho_tpu_torch.workers.shared import WorkersSharedData
from test_torch_dirmode import jax_args
from test_torch_live import (FakeClock, FakeManager, apply_step,
                             counter_steps, make_stats)
from test_torch_native import jax_engine

torch.set_num_threads(1)

SIZE = ["-s", "512K", "-b", "4K"]
BLOCKS = (512 << 10) // 4096  # 128
#: the block loops: (the port's flags, the JAX package's flags)
LOOPS = {
    "ring": (["--gpuids", "0", "--gpustream", "on"],
             ["--tpuids", "0", "--tpustream", "on"]),
    "ring-direct": (["--gpuids", "0", "--gpustream", "on", "--gpudirect"],
                    ["--tpuids", "0", "--tpustream", "on", "--tpudirect"]),
    "python": (["--gpuids", "0", "--gpustream", "off"],
               ["--tpuids", "0", "--tpustream", "off"]),
    "python-direct": (["--gpuids", "0", "--gpustream", "off",
                       "--gpudirect"],
                      ["--tpuids", "0", "--tpustream", "off",
                       "--tpudirect"]),
    "native": ([], []),
    "host-python": ([], []),
}
DEVICE_LOOPS = [name for name, (flags, _) in LOOPS.items() if flags]
#: the ring where eligible, else the Python loop with a NOTE
AUTO = {"auto": (["--gpuids", "0"], ["--tpuids", "0"])}
RECORD_KEYS = ("Phase", "BytesLast", "EntriesLast", "TpuHbmBytes",
               "TpuStreamFusedOps", "TpuH2dStagedOps", "TpuH2dDirectOps",
               "TpuD2hStagedOps", "TpuD2hDirectOps", "TpuD2hPrefetchHits",
               "TpuD2hPrefetchMisses", "IoRetries")


def worker_counts(w) -> tuple:
    """(ops, bytes, entries, latencies) of the normal and the rwmix-read
    counters."""
    return (w.live_ops.num_iops_done, w.live_ops.num_bytes_done,
            w.live_ops.num_entries_done, w.iops_latency_histo.num_values,
            w.live_ops_rwmix_read.num_iops_done,
            w.live_ops_rwmix_read.num_bytes_done,
            w.live_ops_rwmix_read.num_entries_done,
            w.iops_latency_histo_rwmix.num_values)


def rule_reads(rank: int, ops: int, pct: int = 30) -> int:
    """The rwmix reads of a rank's first `ops` ops: op i reads when
    (rank + i) % 100 < pct (the JAX package's modulo, not a draw)."""
    return sum((rank + i) % 100 < pct for i in range(ops))


class Pair:
    """Runs one package's CLI in a directory of its own and keeps each
    worker's counts at the end of each phase."""

    def __init__(self, tmp_path, monkeypatch):
        self.tmp_path = tmp_path
        self.monkeypatch = monkeypatch
        self.counts = {"port": {}, "jax": {}}
        for pkg, cls in (("port", port_lw.LocalWorker),
                         ("jax", jax_lw.LocalWorker)):
            orig = cls.finish_phase_stats

            def finish(self_w, orig=orig, pkg=pkg):
                orig(self_w)
                self.counts[pkg][(self_w.shared.current_phase.name,
                                  self_w.rank)] = worker_counts(self_w)
            monkeypatch.setattr(cls, "finish_phase_stats", finish)

    def dir(self, pkg):
        d = self.tmp_path / pkg
        d.mkdir(exist_ok=True)
        return d

    def read(self, pkg, name="f") -> bytes:
        return (self.dir(pkg) / name).read_bytes()

    def __call__(self, pkg, args, loop="native", name="f"):
        """-> (rc, records, {(phase, rank): worker counts}); the loop's
        flags are added, "host-python" takes the engine away."""
        json_path = self.dir(pkg) / "res.json"
        if json_path.exists():
            json_path.unlink()
        self.counts[pkg].clear()
        port_flags, jax_flags = {**LOOPS, **AUTO}[loop]
        argv = ["--nolive", "--jsonfile", str(json_path),
                str(self.dir(pkg) / name)]
        with self.monkeypatch.context() as m:
            if loop == "host-python":
                m.setattr(port_lw, "get_native_engine", lambda: None)
                m.setenv("ELBENCHO_TPU_NO_NATIVE", "1")
                jax_native.reset_native_engine_cache()
            if pkg == "port":
                rc = port_main(args + port_flags + argv, device="cpu")
            else:
                rc = jax_main(jax_args(args) + jax_flags + argv)
        jax_native.reset_native_engine_cache()
        recs = []
        if json_path.exists():
            with json_path.open() as f:
                recs = [json.loads(line) for line in f]
        return rc, recs, dict(self.counts[pkg])


@pytest.fixture
def pair(tmp_path, monkeypatch):
    jax_engine(monkeypatch)
    return Pair(tmp_path, monkeypatch)


def summary(recs):
    return [{k: r[k] for k in RECORD_KEYS} for r in recs]


def verify_pattern_ok(data: bytes, salt: int) -> bool:
    words = np.frombuffer(data, dtype=np.uint64)
    return bool((words == np.arange(len(words), dtype=np.uint64) * 8
                 + np.uint64(salt)).all())


# ----------------------------------------------------------------------
# --rwmixpct: the per-op split in every loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_rwmixpct_write_equals_the_jax_package(pair, loop, threads):
    """A --rwmixpct 30 write with --verify 11 (and --gpuverify with a
    device) over a file that holds the pattern: the same bytes, counts
    and device counters as the JAX package, the reads split by the
    rule."""
    device = bool(LOOPS[loop][0])
    t = ["-t", str(threads)]
    verify = ["--verify", "11"] + (["--gpuverify"] if device else [])
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *t, *SIZE, "--verify", "11"])[0] == 0
        rc, recs, counts = pair(pkg, ["-w", *t, *SIZE, *verify,
                                      "--rwmixpct", "30", "--iodepth", "4"],
                                loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, pair.read(pkg))
    assert got["port"] == got["jax"]
    (rec,), counts, data = got["port"]
    per_rank = BLOCKS // threads
    for rank in range(threads):
        reads = rule_reads(rank, per_rank)
        writes = per_rank - reads
        assert counts[("CREATEFILES", rank)] == (
            writes, writes * 4096, 0, writes, reads, reads * 4096, 0, reads)
    assert rec["TpuHbmBytes"] == (512 << 10 if device else 0)
    assert rec["TpuStreamFusedOps"] == \
        (BLOCKS if loop.startswith("ring") else 0)
    assert verify_pattern_ok(data, 11)


@pytest.mark.parametrize("loop", ["native", "auto"])
def test_rwmixpct_dir_mode_equals_the_jax_package(pair, loop):
    """Dir mode: the write opens each file read-write for the rwmix
    reads, and the split runs on across a worker's files (the JAX
    package's engine file loop carries its base the same way)."""
    layout = ["-t", "2", "-n", "1", "-N", "3", "-s", "64K", "-b", "4K",
              "--verify", "9"]
    got = {}
    for pkg in ("port", "jax"):
        _dir_bench(pair, pkg)
        assert pair(pkg, ["-d", "-w", *layout], name="bench")[0] == 0
        rc, recs, counts = pair(
            pkg, ["-w", *layout, "--rwmixpct", "30", "--iodepth", "2"]
            + (["--gpuverify"] if loop == "auto" else []), loop,
            name="bench")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts)
    assert got["port"] == got["jax"]
    for rank in range(2):
        reads = rule_reads(rank, 3 * 16)
        assert got["port"][1][("CREATEFILES", rank)][4] == reads


def test_rwmixpct_counts_of_the_smoke_shape():
    """chip_smoke.py's rwmix pass: 4 GiB at 16 MiB blocks, two workers of
    128 ops, --rwmixpct 30: 116 reads and 140 writes; the port's flags
    are the JAX package's."""
    reads = sum(rule_reads(rank, 128) for rank in range(2))
    assert (reads, 256 - reads) == (116, 140)
    assert reads * (16 << 20) == 1_946_157_056
    assert (256 - reads) * (16 << 20) == 2_348_810_240
    for rank in (0, 1, 7):
        for done in (0, 5, 130):
            flags = {}
            for pkg, cls in (("port", port_lw.LocalWorker),
                             ("jax", jax_lw.LocalWorker)):
                w = types.SimpleNamespace(
                    rank=rank, _num_iops_submitted=done,
                    cfg=types.SimpleNamespace(rwmix_read_pct=30))
                flags[pkg] = cls._rwmix_read_flags(w, 250)
                assert [cls._rwmix_decides_read(types.SimpleNamespace(
                    rank=rank, _num_iops_submitted=done + i, cfg=w.cfg))
                    for i in range(250)] == list(flags[pkg].astype(bool))
            np.testing.assert_array_equal(flags["port"], flags["jax"])


def test_a_retried_op_keeps_its_direction_in_the_ring(pair, monkeypatch):
    """The fused ring re-submits a failed op in that op's own direction.
    Under --rwmixpct 30 --ioretries 3 with every 5th storage op short, a
    retried read must go back as a read: a retry in the phase's
    direction would send a read of a mixed write phase back as a write
    of the slot's bytes. The file equals the clean run's, and the
    counts the JAX package's."""
    monkeypatch.setenv("ELBENCHO_TPU_TESTING", "1")
    submits = []
    orig_submit = port_native.NativeStream.submit

    def submit(self, slot, fdi, off, length, is_write):
        submits.append((off, bool(is_write)))
        return orig_submit(self, slot, fdi, off, length, is_write)

    monkeypatch.setattr(port_native.NativeStream, "submit", submit)
    mixed = ["-w", "-t", "1", *SIZE, "--verify", "11", "--gpuverify",
             "--rwmixpct", "30", "--iodepth", "4"]
    got = {}
    for pkg in ("port", "jax"):
        monkeypatch.delenv("ELBENCHO_TPU_IO_FAULT", raising=False)
        assert pair(pkg, ["-w", "-t", "1", *SIZE, "--verify", "11"])[0] == 0
        rc, clean, _ = pair(pkg, mixed, "ring")
        assert rc == 0
        clean_bytes = pair.read(pkg)
        monkeypatch.setenv("ELBENCHO_TPU_IO_FAULT", "short:5")
        submits.clear()
        rc, recs, counts = pair(pkg, mixed + ["--ioretries", "3"], "ring")
        assert rc == 0, pkg
        assert pair.read(pkg) == clean_bytes
        got[pkg] = (summary(recs), counts)
        if pkg == "port":
            directions = {}
            for off, is_write in submits:
                directions.setdefault(off, set()).add(is_write)
            assert len(submits) > BLOCKS  # the retries
            assert all(len(d) == 1 for d in directions.values())
            reads = {off for off, d in directions.items() if d == {False}}
            assert len(reads) == rule_reads(0, BLOCKS)
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["IoRetries"] >= BLOCKS // 5


# ----------------------------------------------------------------------
# --rwmixthr and the --rwmixthrpct balancer
# ----------------------------------------------------------------------

def _dir_bench(pair, pkg):
    bench = pair.dir(pkg) / "bench"
    bench.mkdir(exist_ok=True)
    return bench


@pytest.mark.parametrize("balance", [False, True],
                         ids=["rwmixthr", "rwmixthrpct"])
@pytest.mark.parametrize("loop", ["native", "python", "auto"])
@pytest.mark.parametrize("mode", ["file", "dir"])
def test_rwmixthr_equals_the_jax_package(pair, capsys, mode, loop, balance):
    """--rwmixthr 1 of -t 2: rank 0 reads its share of the written data,
    booked as rwmix reads only, rank 1 writes; with a device the reader's
    copies count in TpuHbmBytes beside the writer's. With --rwmixthrpct
    the balancer paces both, and a device phase takes the Python loop
    with the JAX package's NOTE."""
    flags = ["--rwmixthr", "1"] + (["--rwmixthrpct", "50"] if balance
                                   else [])
    if mode == "file":
        layout, share = SIZE, 256 << 10
    else:
        layout, share = ["-n", "1", "-N", "2", "-s", "64K", "-b", "16K"], \
            2 * (64 << 10)
    got, notes = {}, {}
    for pkg in ("port", "jax"):
        name = "bench" if mode == "dir" else "f"
        if mode == "dir":
            _dir_bench(pair, pkg)
        pre = ["-w", "-t", "2", *layout, "--verify", "3"] \
            + (["-d"] if mode == "dir" else [])
        assert pair(pkg, pre, name=name)[0] == 0
        capsys.readouterr()
        rc, recs, counts = pair(pkg, ["-w", "-t", "2", *layout, *flags],
                                loop, name=name)
        assert rc == 0, pkg
        notes[pkg] = [line.split(" ", 2)[2] for line in
                      capsys.readouterr().out.splitlines()
                      if "NOTE: fused" in line]
        got[pkg] = (summary(recs), counts)
    assert got["port"] == got["jax"]
    (rec,), counts = got["port"]
    ops = share // (4096 if mode == "file" else 16384)
    entries = 0 if mode == "file" else 2
    assert counts[("CREATEFILES", 0)] == (0, 0, 0, 0, ops, share, entries,
                                          ops)
    assert counts[("CREATEFILES", 1)] == (ops, share, entries, ops, 0, 0, 0,
                                          0)
    assert rec["BytesLast"] == share
    assert rec["TpuHbmBytes"] == (2 * share if loop != "native" else 0)
    port_notes = [n.replace("GPU", "TPU") for n in notes["port"]]
    assert port_notes == notes["jax"]
    if loop == "auto" and balance and mode == "file":
        assert notes["port"] == [
            "NOTE: fused GPU stream ineligible (--rwmixthr byte-ratio "
            "balancer); using the Python loop"]
        assert rec["TpuStreamFusedOps"] == 0


def test_rwmixthr_record_rows(pair, capsys):
    """The result table of a --rwmixthr write holds the two rwmix rows in
    the JAX package's place, and its record the measured rates."""
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", "-t", "2", *SIZE])[0] == 0
        capsys.readouterr()
        rc, (rec,), _ = pair(pkg, ["-w", "-t", "2", *SIZE, "--rwmixthr",
                                   "1"])
        assert rc == 0
        labels = [line[12:].split(":")[0].strip() for line in
                  capsys.readouterr().out.splitlines()
                  if line.startswith(" " * 12)]
        assert labels == ["IOPS", "Throughput MiB/s", "Total MiB",
                          "Read IOPS (rwmix)", "Read MiB/s (rwmix)"], pkg
        last_s = rec["ElapsedUSecLast"] / 1e6
        assert rec["RWMixReadIOPSLast"] == round(64 / last_s, 2)
        assert rec["RWMixReadMiBPerSecLast"] == \
            round((256 << 10) / last_s / (1 << 20), 2)


def test_a_stop_wakes_a_reader_blocked_in_the_balancer():
    """The manager's interrupt (a --timelimit, a SIGINT, a worker's
    error) wakes a reader waiting in the balancer at once, not after
    its wait's timeout; the phase start resets the latch."""
    cfg = BenchConfig(rwmix_thr_read_pct=50)
    manager = WorkerManager(cfg)
    balancer = manager.shared.rwmix_balancer
    balancer.wait_read(40 << 20)  # 40 MiB ahead of 0 written
    done = threading.Event()

    def reader():
        balancer.wait_read(1 << 20, timeout=30)
        done.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    assert not done.wait(0.3)  # blocked: reads are 40 MiB ahead
    t0 = time.monotonic()
    manager.interrupt_and_notify_workers()
    assert done.wait(5)
    assert time.monotonic() - t0 < 1.0
    manager.shared.start_phase(BenchPhase.CREATEFILES)
    assert balancer._read_bytes == 0 and not balancer._interrupted


def test_a_time_limit_ends_a_balanced_phase_within_a_second(pair,
                                                            monkeypatch):
    """--rwmixthrpct 50 with a writer slowed to 0.1 s an op: the reader
    runs 32 MiB ahead and then waits in the balancer; --timelimit 2 ends
    the phase within a second of the limit."""
    real = os.pwritev

    def slow_pwritev(fd, bufs, off):
        time.sleep(0.1)
        return real(fd, bufs, off)

    assert pair("port", ["-w", "-t", "2", "-s", "128M", "-b", "1M"])[0] == 0
    monkeypatch.setattr(os, "pwritev", slow_pwritev)
    t0 = time.monotonic()
    rc, (rec,), counts = pair("port", ["-w", "-t", "2", "-s", "128M", "-b",
                                       "1M", "--rwmixthr", "1",
                                       "--rwmixthrpct", "50",
                                       "--timelimit", "2"])
    secs = time.monotonic() - t0
    assert rc == 0
    assert rec["ElapsedUSecLast"] < 3_000_000 and secs < 4
    reader_bytes = counts[("CREATEFILES", 0)][5]
    writer_bytes = counts[("CREATEFILES", 1)][1]
    # the balancer held the reader near 32 MiB ahead of the writer
    assert 32 << 20 <= reader_bytes - writer_bytes <= 40 << 20


# ----------------------------------------------------------------------
# the limiters
# ----------------------------------------------------------------------

class SleepClock:
    """The ``time`` of a rate_limiter module: monotonic() and a sleep()
    that advances it and records each sleep; `op_secs` pass per wait."""

    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, secs):
        self.sleeps.append(secs)
        self.now += secs


SIZES = [4096] * 300 + [1 << 20, 3 << 20, 65536] * 20 + [700_000] * 9


@pytest.mark.parametrize("bps", [1 << 20, 5 << 20, 10_000_000])
def test_the_limiter_sleeps_as_the_jax_package(monkeypatch, bps):
    """Under one fake clock, where each op takes 7 ms, both limiters
    sleep the same total at the same second boundaries for the same
    blocks; the port's sleeps in slices of at most 0.1 s with a test of
    its stop before each."""
    runs = {}
    for name, mod in (("jax", jax_rl), ("port", port_rl)):
        clock = SleepClock()
        monkeypatch.setattr(mod, "time", clock)
        limiter = mod.RateLimiter(bps)
        stops = []
        boundaries = []
        for size in SIZES:
            before = len(clock.sleeps)
            if mod is port_rl:
                limiter.wait(size, stop=lambda: stops.append(clock.now))
            else:
                limiter.wait(size)
            if len(clock.sleeps) > before:
                boundaries.append(round(sum(clock.sleeps[before:]), 9))
            clock.now += 0.007
        runs[name] = (clock.sleeps, boundaries, stops, clock.now)
    assert runs["jax"][1]
    assert runs["port"][1] == pytest.approx(runs["jax"][1])
    assert runs["port"][3] == pytest.approx(runs["jax"][3])
    assert max(runs["port"][0]) <= port_rl.STOP_SLICE_SECS
    assert len(runs["port"][2]) == len(runs["port"][0])


def test_the_first_window_opens_at_the_first_op(monkeypatch):
    """The departure pinned: the JAX package's limiter opens its first
    window when it is made, the port's at its first op. Made 0.6 s
    before the phase, the JAX package's moves its second window's bytes
    0.4 s after the first op; the port's after a whole second."""
    firsts = {}
    for name, mod in (("jax", jax_rl), ("port", port_rl)):
        clock = SleepClock()
        monkeypatch.setattr(mod, "time", clock)
        limiter = mod.RateLimiter(1 << 20)
        clock.now += 0.6  # the worker's prepare, then the phase starts
        start = clock.now
        kw = {"stop": lambda: None} if mod is port_rl else {}
        limiter.wait(1 << 20, **kw)
        limiter.wait(1 << 20, **kw)
        firsts[name] = round(clock.now - start, 9)
    assert firsts == {"jax": 0.4, "port": 1.0}


def test_a_stop_ends_a_limiter_sleep_within_a_slice():
    """A stop raised during the sleep ends it: the rest of the second is
    not slept."""
    limiter = port_rl.RateLimiter(1 << 20)
    limiter.wait(1 << 20, stop=lambda: None)
    t0 = time.monotonic()
    calls = []

    def stop():
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise InterruptedError

    with pytest.raises(InterruptedError):
        limiter.wait(4096, stop=stop)
    assert time.monotonic() - t0 < 0.3


def test_the_balancer_counts_as_the_jax_package():
    """Without contention the two balancers book the same bytes and pass
    at once."""
    balancers = [port_rl.RateLimiterRWMixThreads(30),
                 jax_rl.RateLimiterRWMixThreads(30)]
    for b in balancers:
        for i in range(50):
            (b.wait_write if i % 3 else b.wait_read)(1 << 20, timeout=0.01)
    assert len({(b._read_bytes, b._write_bytes, b._read_target())
                for b in balancers}) == 1
    for pct in (0, 100):
        with pytest.raises(ValueError,
                           match=r"read percentage must be in \(0, 100\)"):
            port_rl.RateLimiterRWMixThreads(pct)


@pytest.mark.parametrize("op", ["write", "read"])
def test_the_engines_limited_loop_equals_the_jax_package(pair, op):
    """No device: the engine's block loop under --limitwrite or
    --limitread 1M moves 2 MiB in two windows, so a worker takes at least
    a second, with the JAX package's counts. One engine call serves the
    phase: a chunk holds at most 2 s of the limit."""
    flag = "--limitwrite" if op == "write" else "--limitread"
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", "-t", "1", "-s", "2M", "-b", "128K"])[0] == 0
        rc, (rec,), counts = pair(pkg, [f"-{op[0]}", "-t", "1", "-s", "2M",
                                        "-b", "128K", flag, "1M"])
        assert rc == 0
        assert rec["ElapsedUSecLast"] >= 1_000_000, pkg
        got[pkg] = (summary([rec]), counts)
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["BytesLast"] == 2 << 20


@pytest.mark.parametrize("limits,block", [((0, 0), 16 << 20),
                                          ((512 << 20, 0), 16 << 20),
                                          ((0, 1 << 20), 128 << 10),
                                          ((4 << 20, 1 << 20), 4096)])
def test_the_chunk_cap_under_a_limit_equals_the_jax_package(limits, block):
    blocks = []
    for cls in (port_lw.LocalWorker, jax_lw.LocalWorker):
        w = types.SimpleNamespace(cfg=types.SimpleNamespace(
            limit_read_bps=limits[0], limit_write_bps=limits[1],
            block_size=block), _NATIVE_CHUNK_MAX_BLOCKS=8192,
            _NATIVE_CHUNK_MAX_BYTES=256 << 20)
        blocks.append(cls._native_chunk_blocks(w))
    assert blocks[0] == blocks[1]


@pytest.mark.parametrize("loop", ["auto", "native"])
def test_limited_phases_keep_the_rate(pair, capsys, loop):
    """-r --limitread 1M and -w --limitwrite 1M of 2 MiB a worker, with a
    device (the Python loop, its NOTE naming the limits) and without (the
    engine): at least one second, and no more than twice the limit a
    worker."""
    for op, flag in (("-w", "--limitwrite"), ("-r", "--limitread")):
        assert pair("port", ["-w", "-t", "2", "-s", "4M", "-b", "256K"])[0] \
            == 0
        capsys.readouterr()
        rc, (rec,), _ = pair("port", [op, "-t", "2", "-s", "4M", "-b",
                                      "256K", flag, "1M"], loop)
        assert rc == 0
        out = capsys.readouterr().out
        assert rec["ElapsedUSecLast"] >= 1_000_000
        assert rec["MiBPerSecLast"] <= 2 * 2 * 1
        if loop == "auto":
            assert "NOTE: fused GPU stream ineligible (per-op rate limits); " \
                "using the Python loop" in out
        assert rec["TpuHbmBytes"] == (4 << 20 if loop == "auto" else 0)


# ----------------------------------------------------------------------
# --blockvarpct and --blockvaralgo
# ----------------------------------------------------------------------

@pytest.mark.parametrize("algo", port_rand.RAND_ALGO_NAMES)
def test_fill_buffer_equals_the_jax_algorithm(algo):
    for seed in (0, 1, 12345):
        a = port_rand.create_rand_algo(algo, seed)
        b = jax_rand.create_rand_algo(algo, seed)
        for n in (1, 8, 1000, 300_000):
            assert a.fill_buffer(n) == b.fill_buffer(n)
        assert a.next64() == b.next64()
        np.testing.assert_array_equal(a.next64_batch(33),
                                      b.next64_batch(33))


@pytest.mark.parametrize("algo", port_rand.RAND_ALGO_NAMES)
def test_blockvarpct_writes_the_jax_packages_bytes(pair, monkeypatch,
                                                   algo):
    """No device: "fast" takes the engine's block loop, the other three
    the Python loop, in both packages; from the same slot fill and seed
    each writes the JAX package's bytes. The first half of every block
    is new, the second half the slot's fill."""
    for mod in (port_lw, jax_lw):
        real = mod.create_rand_algo
        monkeypatch.setattr(
            mod, "create_rand_algo",
            lambda name, seed=None, real=real: real(
                name, 4321 if seed is None else seed))
    got = {}
    for pkg in ("port", "jax"):
        rc, recs, counts = pair(pkg, ["-w", "-t", "1", *SIZE,
                                      "--blockvarpct", "50",
                                      "--blockvaralgo", algo])
        assert rc == 0
        got[pkg] = (summary(recs), counts, pair.read(pkg))
    assert got["port"] == got["jax"]
    blocks = np.frombuffer(got["port"][2], dtype=np.uint8).reshape(-1, 4096)
    first = {bytes(b[:2048]) for b in blocks}
    second = {bytes(b[2048:]) for b in blocks}
    assert len(first) == BLOCKS and len(second) < BLOCKS


def test_a_non_fast_blockvaralgo_leaves_the_engine(monkeypatch, tmp_path):
    calls = []
    real = port_native._NativeEngine.run_block_loop

    def counted(self, *args, **kwargs):
        calls.append(kwargs.get("block_var_pct"))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(port_native._NativeEngine, "run_block_loop",
                        counted)
    for algo, want in (("fast", [50]), ("strong", [])):
        calls.clear()
        assert port_main(["-w", "-t", "1", *SIZE, "--blockvarpct", "50",
                          "--blockvaralgo", algo, "--nolive",
                          str(tmp_path / "f")], device="cpu") == 0
        assert calls == want


@pytest.mark.parametrize("loop", DEVICE_LOOPS)
def test_blockvarpct_with_a_device_changes_nothing(pair, loop):
    """The quirk kept: with a device, a write's source is the device's
    fill pool, so --blockvarpct changes no byte (the JAX package's
    _pre_write_fill returns first), in both packages (each its own fill
    pool: the two generators differ)."""
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", "-t", "1", *SIZE, "--iodepth", "4"],
                    loop)[0] == 0
        plain = pair.read(pkg)
        assert pair(pkg, ["-w", "-t", "1", *SIZE, "--iodepth", "4",
                          "--blockvarpct", "50"], loop)[0] == 0
        assert pair.read(pkg) == plain, pkg


# ----------------------------------------------------------------------
# the record: rows, CSV, JSON, live totals
# ----------------------------------------------------------------------

ISO = "2026-10-18T12:00:00+0000"


def _results(mod):
    res = mod.PhaseResults()
    res.phase_name = "WRITE"
    res.first_done_usec, res.last_done_usec = 750_000, 1_000_000
    res.elapsed_usec_vec = [750_000, 1_000_000]
    res.num_workers = 2
    res.stonewall = {"entries": 1, "bytes": 40 << 20, "iops": 10}
    res.final = {"entries": 2, "bytes": 70 << 20, "iops": 70}
    res.stonewall_rwmix = {"entries": 0, "bytes": 20 << 20, "iops": 20}
    res.final_rwmix = {"entries": 0, "bytes": 58 << 20, "iops": 58}
    for i in range(70):
        res.iops_histo.add_latency(100 + i)
    for i in range(58):
        res.iops_histo_rwmix.add_latency(300 + i)
    return res


def _stats(mod, args_cfg, **cfg):
    stats = mod.Statistics.__new__(mod.Statistics)
    stats.cfg = args_cfg(**cfg)
    stats.manager = types.SimpleNamespace(
        shared=types.SimpleNamespace(tracer=None), workers=[])
    stats.telemetry = None
    return stats


@pytest.mark.parametrize("base10", [False, True])
def test_result_rows_equal_the_jax_package(capsys, tmp_path, base10):
    """The rows of a mixed phase, the two rwmix rows in the JAX
    package's place, byte for byte (the IO latency rows hold the writes'
    histogram in both)."""
    from elbencho_tpu.config.args import BenchConfig as JaxConfig
    out = {}
    for pkg, mod, cfg_cls in (("jax", jax_stats, JaxConfig),
                              ("port", port_stats, BenchConfig)):
        stats = _stats(mod, cfg_cls, use_base10_units=base10,
                       show_latency=True, show_latency_percentiles=True)
        capsys.readouterr()
        stats._render_result_rows(_results(mod))
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    unit = "MB" if base10 else "MiB"
    assert f"Read {unit}/s (rwmix) :" in out["port"]
    assert "Read IOPS (rwmix) :" in out["port"]


def test_csv_row_and_json_keys_equal_the_jax_package(tmp_path,
                                                     monkeypatch):
    """The CSV row's fixed columns, RWMixReadIOPSLast and
    RWMixReadMiBPerSecLast among them, equal the JAX package's for the
    same counts; the JSON record carries both keys."""
    from elbencho_tpu.config.args import BenchConfig as JaxConfig
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: ISO)
    rows, recs = {}, {}
    for pkg, mod, cfg_cls in (("jax", jax_stats, JaxConfig),
                              ("port", port_stats, BenchConfig)):
        path = tmp_path / f"{pkg}.csv"
        stats = _stats(mod, cfg_cls, csv_file_path=str(path),
                       no_csv_labels=True)
        res = _results(mod)
        if pkg == "jax":
            from elbencho_tpu.service.fault_tolerance import \
                CONTROL_AUDIT_COUNTERS
            res.control_counters = {key: 0 for _attr, key, _mode
                                    in CONTROL_AUDIT_COUNTERS}
            stats._write_csv(res)
        else:
            stats._write_csv(stats._result_record(res))
        recs[pkg] = stats._result_record(res)
        header, row = path.read_text().splitlines()
        rows[pkg] = dict(zip(header.split(","), row.split(","),
                             strict=True))
    assert rows["port"] == rows["jax"]
    assert rows["port"]["RWMixReadIOPSLast"] == "58.0"
    assert rows["port"]["RWMixReadMiBPerSecLast"] == "58.0"
    for key in ("RWMixReadIOPSLast", "RWMixReadMiBPerSecLast"):
        assert recs["port"][key] == recs["jax"][key]
        assert key not in port_stats.CSV_FEATURE_OFF_COLUMNS


def test_live_totals_add_the_rwmix_counters(tmp_path, monkeypatch):
    """A live row's totals hold the rwmix reads in both packages; the
    port's per-worker counters of --livejsonex hold them too, so that
    they add up to the totals (the JAX package's leave them out)."""
    out = {}
    steps = counter_steps(11, 3, 2)
    mixed = counter_steps(12, 3, 2)
    for pkg in ("jax", "port"):
        manager = FakeManager(pkg, 2)
        json_path = tmp_path / f"{pkg}.json"
        stats = make_stats(pkg, manager, monkeypatch, FakeClock(),
                           live_json_file_path=str(json_path),
                           live_csv_file_path=str(tmp_path / f"{pkg}.csv"),
                           live_json_extended=True)
        for i in range(3):
            apply_step(manager, steps[i])
            for w, (e, b, n) in zip(manager.workers, mixed[i], strict=True):
                w.live_ops_rwmix_read.num_entries_done += int(e)
                w.live_ops_rwmix_read.num_bytes_done += int(b)
                w.live_ops_rwmix_read.num_iops_done += int(n)
            entries, num_bytes, iops, _done, *per_worker = \
                stats._sum_live_ops()
            stats._write_live_files(BenchPhase.CREATEFILES, entries,
                                    num_bytes, iops, i, *per_worker)
        stats.close()
        rows = [json.loads(line) for line in json_path.open()]
        out[pkg] = ([{k: r[k] for k in ("Entries", "Bytes", "IOPS")}
                     for r in rows],
                    (tmp_path / f"{pkg}.csv").read_text(), rows)
    assert out["port"][:2] == out["jax"][:2]
    want = (steps + mixed).cumsum(axis=0).sum(axis=1)
    assert [list(r.values()) for r in out["port"][0]] == \
        [[int(v) for v in row] for row in want]
    for row in out["port"][2]:
        assert sum(w["NumBytesDone"] for w in row["Workers"]) == row["Bytes"]
    # the fullscreen footer folds the rwmix latencies into the IO ones
    manager = FakeManager("port", 2)
    manager.workers[0].iops_latency_histo.add_latency(10)
    manager.workers[1].iops_latency_histo_rwmix.add_latency(20)
    io_histo, _ = port_stats.merge_live_latency_histos(manager.workers)
    assert io_histo.num_values == 2


def test_a_readers_stonewall_lands_in_the_rwmix_column():
    """A fault of the JAX package not kept: a --rwmixthr reader swaps its
    counters for the phase, but not its stonewall snapshots, so a
    snapshot taken while it ran put its reads in the normal first-done
    column. The port swaps both."""
    got = {}
    for pkg, cls in (("port", port_lw.LocalWorker),
                     ("jax", jax_lw.LocalWorker)):
        if pkg == "port":
            shared = WorkersSharedData(BenchConfig())
        else:
            from elbencho_tpu.config.args import BenchConfig as JaxConfig
            from elbencho_tpu.workers.shared import \
                WorkersSharedData as JaxShared
            shared = JaxShared(JaxConfig())
        w = cls(shared, 0)

        def read_phase(phase, w=w, shared=shared):
            w.live_ops.num_iops_done += 5
            w.live_ops.num_bytes_done += 5 << 12
            shared.stonewall_triggered = True
            w.create_stonewall_stats_if_triggered()

        w._dispatch_phase_inner = read_phase
        w._run_as_rwmix_reader()
        w.finish_phase_stats()
        got[pkg] = (w.stonewall_ops.num_iops_done,
                    w.stonewall_ops_rwmix_read.num_iops_done,
                    w.live_ops_rwmix_read.num_iops_done)
    assert got["port"] == (0, 5, 5)
    assert got["jax"] == (5, 0, 5)


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------

CONFIG_ERRORS = {
    "rwmixthr-without-w": (["-r", "--rwmixthr", "1", "-t", "2"],
                           "--rwmixthr requires the write phase (-w)"),
    "rwmixpct-range": (["-w", "--rwmixpct", "101"],
                       "--rwmixpct must be in 0..100"),
    "blockvarpct-range": (["-w", "--blockvarpct", "101"],
                          "--blockvarpct must be in 0..100"),
    "rwmixthr-threads": (["-w", "--rwmixthr", "2", "-t", "2"],
                         "--rwmixthr must be < number of threads"),
    "verify-blockvar": (["-w", "--verify", "1", "--blockvarpct", "10"],
                        "--verify and --blockvarpct are incompatible"),
}


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_config_errors_equal_the_jax_packages(tmp_path, capsys, case):
    argv, want = CONFIG_ERRORS[case]
    path = str(tmp_path / "f")
    capsys.readouterr()
    assert jax_main(argv + ["-s", "64K", "--nolive", path]) == 1
    jax_err = capsys.readouterr().err
    assert port_main(argv + ["-s", "64K", "--nolive", path],
                     device="cpu") == 1
    port_err = capsys.readouterr().err
    assert want in jax_err and want in port_err


def test_an_unknown_blockvaralgo_fails_at_config_time(tmp_path, capsys):
    """The JAX package fails at the first worker's prepare; the port
    refuses the configuration, with the JAX package's text."""
    argv = ["-w", "-s", "64K", "--blockvarpct", "10", "--blockvaralgo",
            "bogus", "--nolive"]
    capsys.readouterr()
    assert jax_main(argv + [str(tmp_path / "jax")]) != 0
    jax_err = capsys.readouterr().err
    assert port_main(argv + [str(tmp_path / "port")], device="cpu") == 1
    port_err = capsys.readouterr().err
    want = ("unknown random algorithm: 'bogus' (choose from strong, "
            "balanced_single, balanced, fast)")
    assert want in jax_err and want in port_err
    assert not (tmp_path / "port").exists()  # refused before any phase


def test_the_config_file_takes_the_new_flags(tmp_path):
    from elbencho_tpu_torch.config.args import parse_cli
    conf = tmp_path / "c.conf"
    conf.write_text("rwmixpct = 30\nrwmixthr = 1\nrwmixthrpct = 40\n"
                    "limitread = 2M\nlimitwrite = 1M\nblockvarpct = 20\n"
                    "blockvaralgo = balanced\n")
    cfg, _ = parse_cli(["-c", str(conf), "-w", "-t", "2", "f"])
    assert (cfg.rwmix_read_pct, cfg.num_rwmix_read_threads,
            cfg.rwmix_thr_read_pct, cfg.limit_read_bps, cfg.limit_write_bps,
            cfg.block_variance_pct, cfg.block_variance_algo) == \
        (30, 1, 40, 2 << 20, 1 << 20, 20, "balanced")


def test_transient_retries_of_the_python_loop_keep_the_split(
        pair, monkeypatch):
    """--ioretries in the Python loop under --rwmixpct: a short read is
    retried as a read and booked once, as in the JAX package."""
    real = os.preadv
    state = {"short": 3}

    def preadv(fd, bufs, off):
        n = real(fd, bufs, off)
        if state["short"]:
            state["short"] -= 1
            return n - 512
        return n

    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", "-t", "1", *SIZE, "--verify", "5"])[0] == 0
        state["short"] = 3
        monkeypatch.setattr(os, "preadv", preadv)
        rc, recs, counts = pair(pkg, ["-w", "-t", "1", *SIZE, "--verify",
                                      "5", "--rwmixpct", "30",
                                      "--ioretries", "3"], "python")
        monkeypatch.setattr(os, "preadv", real)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, pair.read(pkg))
    assert got["port"] == got["jax"]
    assert got["port"][0][0]["IoRetries"] == 3
