"""The engine's last per-op features in the port (device="cpu") against
the JAX package: --flock range|full, --opslog/--opsloglock, --readinline
and --verifydirect.

Each workload runs through both packages at -s 512K -b 4K, in every loop
the port has: the fused ring, which turns these phases away with the JAX
package's reasons (the Python loop then serves them, staged and
--gpudirect), the Python loop chosen with --gpustream off, the native
block loop without a device (at --iodepth 1 on the sync engine, where it
takes the locks and the read-back itself; at --iodepth 4, where only
--opslog stays in it), and the Python host loop (the engine taken away).
The file bytes, the records, each worker's counts and the ops-log
records (with ``date`` left out) are compared at tolerance 0; a spy on
each package's ``run_block_loop`` shows that the features reach the
port's engine exactly where they reach the JAX package's. Also pinned:
the slice phase's blocker (ROADMAP.md fault C8), the failure texts, the
lock's lockf arguments and the read-write open of a dir-mode write.
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.config.args import parse_cli as jax_parse_cli
from elbencho_tpu.toolkits import file_tk as jax_file_tk
from elbencho_tpu.toolkits import ops_logger as jax_ops_logger
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.config.args import parse_cli as port_parse_cli
from elbencho_tpu_torch.toolkits import file_tk as port_file_tk
from elbencho_tpu_torch.toolkits import ops_logger as port_ops_logger
from elbencho_tpu_torch.utils import native as port_native
from test_torch_dirmode import jax_args
from test_torch_native import jax_engine
from test_torch_rwmix import BLOCKS, SIZE, Pair, summary, verify_pattern_ok
from test_torch_slice import assert_same_slice_record, run_both, slice_record

torch.set_num_threads(1)

#: the five flags: (port flag, dest, the value given in a test)
FLAGS = (("--flock", "use_file_locks", "range"),
         ("--verifydirect", "do_direct_verify", None),
         ("--readinline", "do_read_inline", None),
         ("--opslog", "ops_log_path", "ops.jsonl"),
         ("--opsloglock", "ops_log_lock", None))
#: the workloads: name -> (phases, flags); "OPSLOG" is the ops-log path.
#: All but one write the verify pattern: a device phase's plain write
#: takes its bytes from the device's random fill pool, whose bits differ
#: between torch and JAX, so only a --verify write's bytes compare.
CASES = {
    "flock-range": (["-w", "-r"], ["--flock", "range", "--verify", "7"]),
    "flock-full": (["-w", "-r"], ["--flock", "full", "--verify", "7"]),
    "readinline": (["-w", "-r"], ["--readinline"]),
    "verifydirect": (["-w", "-r"], ["--verifydirect", "--verify", "7"]),
    "opslog": (["-w", "-r"], ["--opslog", "OPSLOG", "--verify", "7"]),
    "opslog-lock": (["-w", "-r"], ["--opslog", "OPSLOG", "--opsloglock",
                                   "--verify", "7"]),
}
#: the loops: name -> (the Pair loop, extra flags of both packages)
LOOPS = {
    "ring": ("auto", []),
    "ring-direct": ("auto", ["--gpudirect"]),
    "python": ("python", []),
    "python-direct": ("python-direct", []),
    "native-depth1": ("native", ["--iodepth", "1"]),
    "native-depth4": ("native", ["--iodepth", "4"]),
    "host-python": ("host-python", []),
}
#: the ring's reason for each workload, in the JAX package's words
RING_REASONS = {
    "flock-range": "--flock per-op locks",
    "flock-full": "--flock per-op locks",
    "readinline": "--readinline/--verifydirect inline read-back",
    "verifydirect": "--readinline/--verifydirect inline read-back",
    "opslog": "--opslog per-op records",
    "opslog-lock": "--opslog per-op records",
}
DATE = re.compile(r"^\d{8}T\d{6}\.\d{9}$")


@pytest.fixture
def pair(tmp_path, monkeypatch):
    jax_engine(monkeypatch)
    return Pair(tmp_path, monkeypatch)


def case_args(pair, pkg, case):
    """The workload's flags with the ops log in the package's own
    directory (removed first: the logger appends)."""
    phases, flags = CASES[case]
    log = pair.dir(pkg) / "ops.jsonl"
    if log.exists():
        log.unlink()
    return phases, [str(log) if f == "OPSLOG" else f for f in flags]


def ops_records(path, prefix=""):
    """The ops log's records in written order, `date` checked against
    the JAX format and left out, `prefix` cut from the entry names."""
    recs = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            assert DATE.match(rec.pop("date")), rec
            rec["entry_name"] = rec["entry_name"].replace(prefix, "")
            recs.append(rec)
    return recs


def sorted_records(recs):
    return sorted(recs, key=lambda r: (r["worker_rank"], r["offset"],
                                       r["op_name"], r["entry_name"],
                                       r["is_finished"]))


# ----------------------------------------------------------------------
# the flags
# ----------------------------------------------------------------------

def test_the_flags_parse_as_in_the_jax_package(tmp_path):
    path = str(tmp_path / "f")
    defaults = (port_parse_cli([path])[0], jax_parse_cli([path])[0])
    for flag, dest, value in FLAGS:
        assert getattr(defaults[0], dest) == getattr(defaults[1], dest)
        argv = [flag] + ([value] if value else []) + [path]
        port_cfg, jax_cfg = port_parse_cli(argv)[0], jax_parse_cli(argv)[0]
        assert getattr(port_cfg, dest) == getattr(jax_cfg, dest) \
            == (value or True)
    for mode in ("range", "full"):
        assert port_parse_cli(["--flock", mode, path])[0].use_file_locks \
            == mode


def test_a_bogus_flock_mode_fails_with_the_jax_text(tmp_path, capsys):
    path = str(tmp_path / "f")
    errs = []
    for run in (lambda a: port_main(a, device="cpu"), jax_main):
        capsys.readouterr()
        assert run(["-w", "-s", "64K", "--flock", "bogus", "--nolive",
                    path]) != 0
        errs.append(capsys.readouterr().err)
    for err in errs:
        assert "--flock must be range or full" in err


# ----------------------------------------------------------------------
# bytes, records and counts in every loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("case", list(CASES))
def test_each_feature_equals_the_jax_package(pair, capsys, case, loop):
    """-w -r of -t 2 with the feature: the same file bytes, records,
    per-worker counts and ops-log records as the JAX package; the ring
    turns the phases away with the JAX package's NOTE."""
    pair_loop, extra = LOOPS[loop]
    got, notes = {}, {}
    for pkg in ("port", "jax"):
        phases, flags = case_args(pair, pkg, case)
        capsys.readouterr()
        rc, recs, counts = pair(pkg, [*phases, "-t", "2", *SIZE, *flags,
                                      *extra], pair_loop)
        assert rc == 0, pkg
        out = capsys.readouterr().out
        notes[pkg] = [line.split(" NOTE: ")[1].replace("TPU", "GPU")
                      for line in out.splitlines() if " NOTE: fused" in line]
        log = pair.dir(pkg) / "ops.jsonl"
        ops = sorted_records(ops_records(log)) if log.exists() else None
        data = pair.read(pkg)
        if case == "readinline" and pair_loop in ("auto", "python",
                                                  "python-direct"):
            data = len(data)  # the device's fill pool: see CASES
        got[pkg] = (summary(recs), counts, data, ops)
    for i in range(4):  # one by one: a byte diff of 512 KiB is slow to show
        assert got["port"][i] == got["jax"][i], i
    recs, counts, data, ops = got["port"]
    assert [r["Phase"] for r in recs] == ["WRITE", "READ"]
    assert all(r["BytesLast"] == 512 << 10 for r in recs)
    for phase in ("CREATEFILES", "READFILES"):
        for rank in (0, 1):
            assert counts[(phase, rank)][:4] == \
                (BLOCKS // 2, (BLOCKS // 2) * 4096, 0, BLOCKS // 2)
    if case != "readinline":
        assert verify_pattern_ok(data, 7)
    if case.startswith("opslog"):
        assert len(ops) == 2 * BLOCKS
        for op in ("write", "read"):
            assert sorted(r["offset"] for r in ops if r["op_name"] == op) \
                == [i * 4096 for i in range(BLOCKS)]
        assert {(r["worker_rank"], r["entry_name"], r["length"],
                 r["is_finished"], r["is_error"]) for r in ops} == \
            {(0, "", 4096, True, False), (1, "", 4096, True, False)}
        assert list(ops[0]) == ["worker_rank", "op_name", "entry_name",
                                "offset", "length", "is_finished",
                                "is_error"]
    device = pair_loop in ("auto", "python", "python-direct")
    assert all(r["TpuHbmBytes"] == (512 << 10 if device else 0)
               for r in recs)
    assert all(r["TpuStreamFusedOps"] == 0 for r in recs)
    if pair_loop == "auto":
        note = (f"fused GPU stream ineligible ({RING_REASONS[case]}); "
                f"using the Python loop")
        assert notes["port"] == notes["jax"] == [note, note]
    else:
        assert notes["port"] == notes["jax"] == []


@pytest.mark.parametrize("loop", ["native-depth1", "ring", "host-python"])
def test_dir_mode_entry_records_equal_the_jax_packages(pair, loop):
    """Dir mode (-d -w -r -F -D -n 1 -N 2): a pre and a post record
    around each entry, the block records of each file between them, as
    the JAX package writes them."""
    pair_loop, extra = LOOPS[loop]
    layout = ["-t", "2", "-n", "1", "-N", "2", "-s", "16K", "-b", "4K"]
    got = {}
    for pkg in ("port", "jax"):
        bench = pair.dir(pkg) / "bench"
        bench.mkdir(exist_ok=True)
        _, flags = case_args(pair, pkg, "opslog")
        rc, recs, counts = pair(pkg, ["-d", "-w", "-r", "-F", "-D", *layout,
                                      *flags, *extra], pair_loop,
                                name="bench")
        assert rc == 0, pkg
        log = ops_records(pair.dir(pkg) / "ops.jsonl", str(bench))
        got[pkg] = (summary(recs), counts, sorted_records(log))
        if pkg == "port":
            port_log = log
    assert got["port"] == got["jax"]
    for rank in (0, 1):
        seq = [(r["op_name"], r["entry_name"], r["is_finished"])
               for r in port_log if r["worker_rank"] == rank]
        d = f"/r{rank}/d0"
        files = [f"{d}/r{rank}-f{i}" for i in range(2)]
        want = [("createdirs", d, False), ("createdirs", d, True)]
        for phase, op in (("createfiles", "write"), ("readfiles", "read")):
            for f in files:
                want += [(phase, f, False), *[(op, "", True)] * 4,
                         (phase, f, True)]
        for f in files:
            want += [("deletefiles", f, False), ("deletefiles", f, True)]
        want += [("deletedirs", d, False), ("deletedirs", d, True)]
        assert seq == want, rank
    assert not any(r["is_error"] for r in port_log)


def test_a_tolerated_missing_entry_is_an_error_record(pair, monkeypatch):
    """A delete of a missing entry that the phase tolerates (an earlier
    write phase was cut) gets is_error in its post record, as in the JAX
    package."""
    from elbencho_tpu_torch.workers import local_worker as port_lw
    monkeypatch.setattr(port_lw.LocalWorker, "_partial_tolerance",
                        lambda self, phase: True)
    bench = pair.dir("port") / "bench"
    bench.mkdir()
    _, flags = case_args(pair, "port", "opslog")
    rc, _, _ = pair("port", ["-F", "-t", "1", "-n", "1", "-N", "1", "-s",
                             "4K", *flags], name="bench")
    assert rc == 0
    recs = ops_records(pair.dir("port") / "ops.jsonl", str(bench))
    assert [(r["op_name"], r["is_finished"], r["is_error"])
            for r in recs] == [("deletefiles", False, False),
                               ("deletefiles", True, True)]


@pytest.mark.parametrize("loop", ["ring", "python-direct", "native-depth1"])
def test_a_dir_mode_readinline_write_opens_read_write(pair, loop):
    """A dir-mode write with --readinline reads each block back through
    the file's own fd: the file is opened read-write, with a device as
    without one (an O_WRONLY open fails the read-back with EBADF)."""
    pair_loop, extra = LOOPS[loop]
    layout = ["-t", "2", "-n", "1", "-N", "2", "-s", "64K", "-b", "4K",
              "--verify", "5", "--readinline"]
    got = {}
    for pkg in ("port", "jax"):
        (pair.dir(pkg) / "bench").mkdir(exist_ok=True)
        rc, recs, counts = pair(pkg, ["-d", "-w", *layout, *extra],
                                pair_loop, name="bench")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts)
    assert got["port"] == got["jax"]
    assert got["port"][0][1]["BytesLast"] == 4 * (64 << 10)


# ----------------------------------------------------------------------
# which loop served: the features at the port's engine
# ----------------------------------------------------------------------

SPY_CASES = (
    (["-w", "-r"], ["--flock", "range"]),
    (["-w", "-r"], ["--flock", "full", "--ioengine", "sync"]),
    (["-w"], ["--flock", "full", "--iodepth", "4"]),
    (["-w", "-r"], ["--verifydirect", "--verify", "7"]),
    (["-w"], ["--readinline", "--iodepth", "4"]),
    (["-w", "-r"], ["--opslog", "OPSLOG", "--iodepth", "4"]),
    (["-w"], ["--opslog", "OPSLOG", "--opsloglock", "--flock", "range",
              "--readinline"]),
)


@pytest.mark.parametrize("phases,flags", SPY_CASES)
def test_the_features_reach_the_engine_where_the_jax_ones_do(
        pair, monkeypatch, phases, flags):
    """A spy on each package's run_block_loop: flock_mode,
    inline_readback, ops_fd and ops_lock reach the port's engine in the
    same calls, with the same values, as the JAX package's."""
    calls = {"port": [], "jax": []}
    for pkg, cls in (("port", port_native._NativeEngine),
                     ("jax", type(jax_native.get_native_engine()))):
        real = cls.run_block_loop

        def spy(self, *args, real=real, pkg=pkg, **kw):
            calls[pkg].append((kw.get("flock_mode"),
                               bool(kw.get("inline_readback")),
                               kw.get("ops_fd", -1) >= 0,
                               bool(kw.get("ops_lock"))))
            return real(self, *args, **kw)

        monkeypatch.setattr(cls, "run_block_loop", spy)
    for pkg in ("port", "jax"):
        log = pair.dir(pkg) / "ops.jsonl"
        if log.exists():
            log.unlink()
        argv = [str(log) if f == "OPSLOG" else f for f in flags]
        rc, recs, _ = pair(pkg, [*phases, "-t", "1", *SIZE, *argv])
        assert rc == 0, pkg
    assert calls["port"] == calls["jax"]
    depth4 = "4" in flags
    sync_only = "--flock" in flags or "--readinline" in flags
    assert bool(calls["port"]) == (not depth4 or not sync_only)


@pytest.mark.parametrize("loop", ["python", "host-python",
                                  "native-depth1"])
@pytest.mark.parametrize("mode", ["range", "full"])
def test_the_python_loops_lock_each_op_as_the_jax_package(
        pair, monkeypatch, loop, mode):
    """-w -r --flock of -t 2: the Python loops take one FileRangeLock per
    op, with the JAX package's range and direction; the engine's sync
    loop takes its locks itself and none through the Python class."""
    pair_loop, extra = LOOPS[loop]
    locks = {"port": [], "jax": []}
    for pkg, mod in (("port", port_file_tk), ("jax", jax_file_tk)):
        real = mod.FileRangeLock.__enter__

        def enter(self, real=real, pkg=pkg):
            locks[pkg].append((self.offset, self.length, self.is_write))
            return real(self)

        monkeypatch.setattr(mod.FileRangeLock, "__enter__", enter)
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", "-r", "-t", "2", *SIZE, "--flock", mode,
                          "--verify", "7", *extra], pair_loop)[0] == 0
    assert sorted(locks["port"]) == sorted(locks["jax"])
    if loop == "native-depth1":
        assert locks["port"] == []
        return
    want = {(i * 4096, 4096) if mode == "range" else (0, 0)
            for i in range(BLOCKS)}
    assert len(locks["port"]) == 2 * BLOCKS
    assert {lock[:2] for lock in locks["port"]} == want
    assert sum(lock[2] for lock in locks["port"]) == BLOCKS


def test_a_pinned_async_engine_refuses_the_sync_features(pair, capsys):
    """--flock at --iodepth 4 --ioengine aio: the native block loop
    cannot take the locks, so both packages fail with their --ioengine
    error, the port's naming the features."""
    errs = {}
    for pkg in ("port", "jax"):
        capsys.readouterr()
        rc, _, _ = pair(pkg, ["-w", "-t", "1", *SIZE, "--flock", "range",
                              "--iodepth", "4", "--ioengine", "aio"])
        assert rc != 0, pkg
        errs[pkg] = capsys.readouterr().err
    assert "--ioengine aio only supports the native block loop" \
        in errs["port"] and "--ioengine aio only supports the native " \
        "block loop" in errs["jax"]
    assert "--flock/--readinline/--verifydirect, which need the sync " \
        "engine" in errs["port"]


# ----------------------------------------------------------------------
# failure texts
# ----------------------------------------------------------------------

def unavailable(err: str) -> "list[str]":
    return re.findall(r"stream on: fused native-stream loop unavailable "
                      r"\(([^)]*)\)", err)


@pytest.mark.parametrize("flags,reason", [
    (["--flock", "full"], "--flock per-op locks"),
    (["--verifydirect"], "--readinline/--verifydirect inline read-back"),
    (["--readinline", "--flock", "range"], "--flock per-op locks"),
    (["--opslog", "OPSLOG", "--flock", "range", "--verifydirect"],
     "--opslog per-op records"),
])
def test_gpustream_on_fails_naming_the_jax_blocker(pair, capsys, flags,
                                                   reason):
    errs = {}
    for pkg in ("port", "jax"):
        log = pair.dir(pkg) / "ops.jsonl"
        argv = [str(log) if f == "OPSLOG" else f for f in flags]
        capsys.readouterr()
        rc, _, _ = pair(pkg, ["-w", "-t", "1", *SIZE, *argv], "ring")
        assert rc != 0, pkg
        # the port repeats a worker's error at the end of the run
        errs[pkg] = sorted(set(unavailable(capsys.readouterr().err)))
    assert errs["port"] == errs["jax"] == [reason]


def corrupt_readback(monkeypatch, at: int):
    """os.preadv, patched: a read at file offset `at` comes back with its
    first word's low byte flipped (a file system that lost the write)."""
    real = os.preadv

    def preadv(fd, bufs, offset, *args):
        n = real(fd, bufs, offset, *args)
        if offset == at:
            bufs[0][0] ^= 0x5A
        return n

    monkeypatch.setattr(os, "preadv", preadv)


@pytest.mark.parametrize("loop", ["ring", "python-direct", "host-python"])
def test_a_corrupted_readback_fails_with_the_jax_text(pair, capsys,
                                                      monkeypatch, loop):
    """--verifydirect --verify 7 with the read-back of the block at 64 KiB
    corrupted: both packages fail with the same "data integrity check
    failed at file offset 65536" text."""
    pair_loop, extra = LOOPS[loop]
    corrupt_readback(monkeypatch, 64 << 10)
    errs = {}
    for pkg in ("port", "jax"):
        capsys.readouterr()
        rc, _, _ = pair(pkg, ["-w", "-t", "1", *SIZE, "--verifydirect",
                              "--verify", "7", *extra], pair_loop)
        assert rc != 0, pkg
        errs[pkg] = sorted(set(re.findall(
            r"data integrity check failed at file offset \d+: expected "
            r"\w+, got \w+", capsys.readouterr().err)))
    want = 65536 + 7
    assert errs["port"] == errs["jax"] == [
        f"data integrity check failed at file offset 65536: expected "
        f"{want:#x}, got {want ^ 0x5A:#x}"]


def test_a_short_readback_fails_with_the_jax_text(pair, capsys,
                                                  monkeypatch):
    real = os.preadv
    monkeypatch.setattr(os, "preadv",
                        lambda fd, bufs, offset: real(fd, bufs, offset) - 1
                        if offset == 8192 else real(fd, bufs, offset))
    errs = {}
    for pkg in ("port", "jax"):
        capsys.readouterr()
        rc, _, _ = pair(pkg, ["-w", "-t", "1", *SIZE, "--readinline"],
                        "python")
        assert rc != 0, pkg
        errs[pkg] = "short inline read-back at 8192" \
            in capsys.readouterr().err
    assert errs == {"port": True, "jax": True}


# ----------------------------------------------------------------------
# the lock and the logger themselves
# ----------------------------------------------------------------------

def test_file_range_lock_calls_lockf_as_the_jax_package(monkeypatch):
    calls = {"port": [], "jax": []}
    for pkg, mod in (("port", port_file_tk), ("jax", jax_file_tk)):
        monkeypatch.setattr(
            mod.fcntl, "lockf",
            lambda *a, pkg=pkg: calls[pkg].append(a))
        for mode in ("range", "full"):
            for is_write in (True, False):
                with mod.FileRangeLock(3, mode, 8192, 4096, is_write):
                    pass
    assert calls["port"] == calls["jax"]
    import fcntl
    assert calls["port"][:4] == [(3, fcntl.LOCK_EX, 4096, 8192, 0),
                                 (3, fcntl.LOCK_UN, 4096, 8192, 0),
                                 (3, fcntl.LOCK_SH, 4096, 8192, 0),
                                 (3, fcntl.LOCK_UN, 4096, 8192, 0)]
    assert calls["port"][4] == (3, fcntl.LOCK_EX, 0, 0, 0)


@pytest.mark.parametrize("use_lock", [False, True])
def test_ops_logger_writes_the_jax_records(tmp_path, monkeypatch,
                                           use_lock):
    """The same lines, byte for byte under one clock, and the same flock
    calls under --opsloglock; a failing body marks its post record."""
    monkeypatch.setattr(
        "time.strftime", lambda fmt, *a: "20261018T061500")
    monkeypatch.setattr("time.time_ns", lambda: 1_234_567_891)
    flocks = {"port": [], "jax": []}
    real = port_ops_logger.fcntl.flock  # one fcntl module for both
    for pkg, mod in (("port", port_ops_logger), ("jax", jax_ops_logger)):
        monkeypatch.setattr(
            mod.fcntl, "flock",
            lambda fd, op, pkg=pkg: (flocks[pkg].append(op), real(fd, op)))
        log = mod.OpsLogger(str(tmp_path / pkg), 3, use_lock=use_lock)
        log.log_op("write", "", 4096, 4096)
        with log.logged_op("createfiles", "/d/f") as rec:
            rec.error = True
        with pytest.raises(OSError), log.logged_op("readfiles", "/d/g"):
            raise OSError("gone")
        with mod.null_logged_op("x", "y"):
            pass
        assert log.fd >= 0
        log.close()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    lines = (tmp_path / "port").read_text().splitlines()
    assert len(lines) == 5
    assert json.loads(lines[0]) == {
        "date": "20261018T061500.234567891", "worker_rank": 3,
        "op_name": "write", "entry_name": "", "offset": 4096,
        "length": 4096, "is_finished": True, "is_error": False}
    assert [json.loads(x)["is_error"] for x in lines] == \
        [False, False, True, False, True]
    assert flocks["port"] == flocks["jax"] == \
        ([2, 8] * 5 if use_lock else [])


def test_the_engines_records_have_the_loggers_keys(pair):
    """No device, --iodepth 1: the engine writes the block records, with
    the keys of the Python logger's records, in the order of the JAX
    package's engine (the same engine source)."""
    got = {}
    for pkg in ("port", "jax"):
        _, flags = case_args(pair, pkg, "opslog")
        assert pair(pkg, ["-w", "-t", "1", *SIZE, *flags])[0] == 0
        got[pkg] = ops_records(pair.dir(pkg) / "ops.jsonl")
    assert got["port"] == got["jax"]
    assert [r["offset"] for r in got["port"]] == \
        [i * 4096 for i in range(BLOCKS)]
    log = port_ops_logger.OpsLogger.__new__(port_ops_logger.OpsLogger)
    log.worker_rank = 0
    keys = list(log._record("write", "", 0, 0, True, False))
    assert ["date"] + list(got["port"][0]) == keys


# ----------------------------------------------------------------------
# the slice phase's blocker (C8)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("flags,reason", [
    (["--limitread", "100"], "per-op rate limits"),
    (["--opslog", "OPSLOG"], "--opslog per-op records"),
])
def test_the_slice_takes_the_preadv_reader_as_the_jax_package(
        tmp_path, capsys, monkeypatch, flags, reason):
    """-w --gpuslice -t 2 -s 2M -b 64K --iodepth 2 with --limitread 100 or
    --opslog: both packages take the preadv reader with the same NOTE
    (the port engaged its ring here before), with equal records."""
    jax_engine(monkeypatch)
    argv = [str(tmp_path / "ops.jsonl") if f == "OPSLOG" else f
            for f in flags]
    capsys.readouterr()
    jrc, prc, jrecs, precs = run_both(
        ["-w", "--gpuslice", "-t", "2", "-s", "2M", "-b", "64K",
         "--iodepth", "2", *argv], tmp_path)
    out = capsys.readouterr().out
    assert jrc == prc == 0
    note = (f"NOTE: fused slice ingest ineligible ({reason}); using the "
            f"preadv loop")
    assert out.count(note) == 2
    assert "slice ingest ring engaged" not in out
    assert_same_slice_record(slice_record(jrecs), slice_record(precs))
    assert [summary([r]) for r in precs if r["Phase"] == "WRITE"] == \
        [summary([r]) for r in jrecs if r["Phase"] == "WRITE"]


def test_the_feature_flags_of_a_worker_map_as_the_jax_ones():
    """_flock_mode_code and the write open flags of both packages."""
    from elbencho_tpu.workers import local_worker as jax_lw
    from elbencho_tpu_torch.workers import local_worker as port_lw
    for mode in ("", "range", "full"):
        w = types.SimpleNamespace(cfg=types.SimpleNamespace(
            use_file_locks=mode))
        assert port_lw.LocalWorker._flock_mode_code(w) == \
            jax_lw.LocalWorker._flock_mode_code(w)
    for rwmix, inline, direct in np.ndindex(2, 2, 2):
        cfg = types.SimpleNamespace(
            rwmix_read_pct=30 * rwmix, do_read_inline=bool(inline),
            do_direct_verify=bool(direct), use_direct_io=False,
            do_truncate=False)
        w = types.SimpleNamespace(cfg=cfg)
        assert port_lw.LocalWorker._open_flags_write(w) == \
            jax_lw.LocalWorker._open_flags_write(w)
