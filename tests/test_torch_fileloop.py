"""The engine's per-file loop in the port (no device) against the JAX
package.

Dir-mode runs without a device go through both CLIs into two trees: the
file bytes, the phase counts of LAST_COUNT_KEYS and the numbers of entry
and IO latencies are compared at tolerance 0. A spy on each package's
``run_file_loop`` shows that the port hands the engine the same chunks
(op and number of paths) as the JAX package does: at --iodepth 1 with
--verify, --rwmixpct, --flock range and --readinline, and not at all at
--iodepth 2, under --opslog or under --rand. The failure texts of a
flipped byte, of a write without -d and of a missing file under RMFILES
are the JAX package's.
"""

import json
import os
import re

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.utils import native as port_native
from test_torch_dirmode import LAST_COUNT_KEYS, tree
from test_torch_native import jax_engine

torch.set_num_threads(1)

LAYOUT = ["-t", "2", "-n", "2", "-N", "5", "-s", "12K", "-b", "4K"]
#: name -> (flags of the first run, flags of the second run)
CASES = {
    "plain": (["-d", "-w", "--stat", "-r"], ["-F", "-D"]),
    "verify": (["-d", "-w", "--stat", "-r", "--verify", "7"],
               ["-r", "-F", "-D", "--verify", "7"]),
    "rwmixpct": (["-d", "-w", "--verify", "9"],
                 ["-w", "--rwmixpct", "30", "--verify", "9"]),
    "flock-range": (["-d", "-w", "-r", "--flock", "range", "--verify", "7"],
                    ["-F", "-D"]),
    "readinline": (["-d", "-w", "--readinline", "--verify", "7"],
                   ["-w", "-r", "--readinline"]),
    # one worker of 40 files of 256 blocks: chunks of 32 and 8 files
    "chunked": (["-d", "-w", "-r", "-t", "1", "-n", "1", "-N", "40", "-s",
                 "1M", "--verify", "3"], ["-F", "-D", "-t", "1", "-n", "1",
                                          "-N", "40", "-s", "1M"]),
}


@pytest.fixture
def spies(monkeypatch):
    """{package: [(op, number of paths), ...]} of every call into each
    package's per-file loop."""
    jax_engine(monkeypatch)
    calls = {"port": [], "jax": []}
    for pkg, cls in (("port", port_native._NativeEngine),
                     ("jax", jax_native._NativeEngine)):
        real = cls.run_file_loop

        def spy(self, paths, op, *args, real=real, pkg=pkg, **kwargs):
            calls[pkg].append((op, len(paths)))
            return real(self, paths, op, *args, **kwargs)

        monkeypatch.setattr(cls, "run_file_loop", spy)
    return calls


def run(pkg, args, bench, json_path):
    """One CLI run without a device; returns (rc, records)."""
    if json_path.exists():
        json_path.unlink()
    argv = args + ["--nolive", "--jsonfile", str(json_path), str(bench)]
    rc = jax_main(argv) if pkg == "jax" else port_main(argv, device="cpu")
    recs = []
    if json_path.exists():
        recs = [json.loads(x) for x in json_path.read_text().splitlines()]
    return rc, recs


def counts(recs):
    return [({k: r[k] for k in LAST_COUNT_KEYS},
             r["IOLatHisto"]["LatNumValues"],
             r["EntLatHisto"]["LatNumValues"],
             r["RWMixReadIOPSLast"] > 0) for r in recs]


def run_both(tmp_path, first, second, extra=()):
    """Both runs of a case through both packages; returns ({package:
    (counts of run 1, tree after run 1, counts of run 2, tree after
    run 2)})."""
    got = {}
    for pkg in ("port", "jax"):
        bench = tmp_path / pkg
        bench.mkdir()
        out = []
        for args in (first, second):
            rc, recs = run(pkg, [*LAYOUT, *args, *extra], bench,
                           tmp_path / f"{pkg}.json")
            assert rc == 0, (pkg, args)
            out += [counts(recs), tree(bench)]
        got[pkg] = out
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_dir_mode_through_the_file_loop_equals_the_jax_package(
        tmp_path, spies, case):
    first, second = CASES[case]
    got = run_both(tmp_path, first, second)
    assert got["port"] == got["jax"]
    assert sorted(spies["port"]) == sorted(spies["jax"])
    assert spies["port"], "the engine's per-file loop never ran"
    phases = {"-w": "write", "-r": "read", "--stat": "stat", "-F": "unlink"}
    want = {op for flag, op in phases.items() if flag in first + second}
    assert {op for op, _ in spies["port"]} == want
    if case == "chunked":
        assert [n for op, n in spies["port"] if op == "write"] == [32, 8]
    if case == "rwmixpct":
        assert got["port"][2][0][3], "no rwmix read was booked"


#: workloads that keep a phase out of the per-file loop in both packages
TURNED_AWAY = {
    "iodepth-2": ["--iodepth", "2"],
    "opslog": ["--opslog", "OPSLOG"],
    # one worker: with two, each writes only its share of a file's blocks
    "rand": ["--rand", "-t", "1"],
    "ioengine-aio": ["--ioengine", "aio", "--iodepth", "2"],
}


@pytest.mark.parametrize("case", list(TURNED_AWAY))
def test_the_file_loop_is_turned_away_where_the_jax_ones_is(
        tmp_path, spies, case):
    extra = [str(tmp_path / "ops.jsonl") if a == "OPSLOG" else a
             for a in TURNED_AWAY[case]]
    got = run_both(tmp_path, ["-d", "-w", "-r", "--verify", "5"],
                   ["--stat", "-F", "-D"], extra)
    assert got["port"] == got["jax"]
    assert spies["port"] == spies["jax"] == []


def failure_lines(text, *paths):
    """The ERROR lines of a run, time stamps cut and paths named."""
    out = []
    for line in text.splitlines():
        if "ERROR" not in line:
            continue
        line = re.sub(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d ", "", line)
        for i, p in enumerate(paths):
            line = line.replace(str(p), f"<bench{i}>")
        out.append(line)
    return out


def failing_both(tmp_path, capsys, prepare, args, setup=None):
    """A failing run of `args` through both packages after `prepare`, one
    worker (with two, the order of the lines and the other worker's
    fate depend on timing); returns {package: the run's ERROR lines}."""
    got = {}
    for pkg in ("port", "jax"):
        bench = tmp_path / pkg
        bench.mkdir()
        if prepare:
            assert run(pkg, [*LAYOUT, "-t", "1", *prepare], bench,
                       tmp_path / f"{pkg}.json")[0] == 0
        if setup:
            setup(bench)
        capsys.readouterr()
        rc, _ = run(pkg, [*LAYOUT, "-t", "1", *args], bench,
                    tmp_path / f"{pkg}.json")
        assert rc != 0, pkg
        got[pkg] = failure_lines(capsys.readouterr().err, bench)
    return got


def test_a_flipped_byte_fails_with_the_jax_text(tmp_path, capsys, spies):
    def flip(bench):
        victim = bench / "r0" / "d1" / "r0-f3"
        data = bytearray(victim.read_bytes())
        data[5000] ^= 0x20
        victim.write_bytes(bytes(data))

    got = failing_both(tmp_path, capsys, ["-d", "-w", "--verify", "7"],
                       ["-r", "--verify", "7"], flip)
    assert got["port"] == got["jax"]
    assert any("data integrity check failed at file offset 5000 of "
               "<bench0>/r0/d1/r0-f3: expected" in x for x in got["port"])
    assert ("read", 10) in spies["port"]


def test_a_write_without_mkdirs_gives_the_jax_hint(tmp_path, capsys,
                                                    spies):
    got = failing_both(tmp_path, capsys, None, ["-w"])
    assert got["port"] == got["jax"]
    assert any(x.endswith("File create/open failed. Did you forget to "
                          "enable directory creation ('--mkdirs'/-d)?")
               for x in got["port"]), got["port"]


def test_a_missing_file_under_rmfiles_fails_as_in_the_jax_package(
        tmp_path, capsys, spies):
    def remove(bench):
        os.unlink(bench / "r0" / "d0" / "r0-f2")

    got = failing_both(tmp_path, capsys, ["-d", "-w"], ["-F"], remove)
    assert got["port"] == got["jax"]
    assert any("No such file or directory (unlink: <bench0>/r0/d0/r0-f2)"
               in x for x in got["port"]), got["port"]
