"""Dir mode of the port's CLI (device="cpu") against the JAX package's CLI.

The same dir-mode workload runs through both packages into two trees: the
trees must hold the same relative paths and the same file bytes, the
phase records of MKDIRS, STATDIRS, WRITE, STAT, READ, RMFILES and RMDIRS
the same counts, and each package must read the other's tree under
--verify. Tolerance 0 throughout. The helpers here are shared with
tests/test_torch_stripe.py and tests/test_torch_batch.py.
"""

import json
import os

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu_torch.cli import main as port_main
from test_torch_e2e import COUNT_KEYS, _jax_python_loop  # noqa: F401

torch.set_num_threads(1)

#: the counts of COUNT_KEYS that do not depend on timing: the "First"
#: numbers are a snapshot taken when the first worker finished, so with
#: several workers they depend on how far the others had got
LAST_COUNT_KEYS = tuple(k for k in COUNT_KEYS if not k.endswith("First"))

ENTRY_PHASES = ("MKDIRS", "STATDIRS", "STAT", "RMFILES", "RMDIRS")


def jax_args(args):
    """The port's --gpu* flags as the JAX package's --tpu* flags."""
    return [a.replace("--gpu", "--tpu") if a.startswith("--gpu") else a
            for a in args]


def run_jax(args, paths, json_path=None):
    extra = ["--jsonfile", str(json_path)] if json_path else []
    return jax_main(jax_args(args) + ["--tpuids", "0", "--tpustream", "off",
                                      "--nolive"] + extra
                    + [str(p) for p in paths])


def run_port(args, paths, json_path=None):
    extra = ["--jsonfile", str(json_path)] if json_path else []
    return port_main(args + ["--gpuids", "0", "--nolive"] + extra
                     + [str(p) for p in paths], device="cpu")


def records(json_path):
    with open(json_path) as f:
        return [json.loads(line) for line in f]


def run_both(args, jax_paths, port_paths, tmp_path, name):
    """Run `args` through both CLIs; returns (jax records, port records)."""
    jax_json, port_json = tmp_path / f"{name}.jax.json", \
        tmp_path / f"{name}.port.json"
    assert run_jax(args, jax_paths, jax_json) == 0
    assert run_port(args, port_paths, port_json) == 0
    return records(jax_json), records(port_json)


#: counters that follow the order of the offsets: --rand seeds its offset
#: generator afresh in every run, in both packages
RANDOM_ORDER_KEYS = ("TpuD2hPrefetchHits", "TpuD2hPrefetchMisses")


def assert_same_counts(jax_recs, port_recs, threads, rand=False):
    """Phase by phase: the same count keys (the stonewall "First" ones
    only with one worker, the prefetch ones only without --rand) and the
    same number of op and entry latencies."""
    keys = [k for k in (COUNT_KEYS if threads == 1 else LAST_COUNT_KEYS)
            if not (rand and k in RANDOM_ORDER_KEYS)]
    assert [r["Phase"] for r in port_recs] == [r["Phase"] for r in jax_recs]
    for jr, pr in zip(jax_recs, port_recs, strict=True):
        assert {k: pr[k] for k in keys} == {k: jr[k] for k in keys}, \
            pr["Phase"]
        for histo in ("IOLatHisto", "EntLatHisto"):
            assert pr[histo]["LatNumValues"] == jr[histo]["LatNumValues"], \
                (pr["Phase"], histo)


def tree(root):
    """{relative path: file bytes, or None for a directory}."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for d in dirnames:
            out[os.path.normpath(os.path.join(rel, d)) + "/"] = None
        for fn in filenames:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.normpath(os.path.join(rel, fn))] = f.read()
    return out


def make_dirs(tmp_path, prefix, count):
    paths = [tmp_path / f"{prefix}{i}" for i in range(count)]
    for p in paths:
        p.mkdir()
    return paths


DIR_WORKLOAD = ["-n", "2", "-N", "3", "-s", "12K", "-b", "4K",
                "--iodepth", "2", "--verify", "7"]

CASES = {
    # name: (flags, number of bench dirs)
    "seq": (["-t", "2"], 1),
    "seq-dirsharing": (["-t", "2", "--dirsharing"], 1),
    "seq-two-bench-dirs": (["-t", "2"], 2),
    # one thread: its per-file random amount covers every block (with
    # two, each file's amount is halved, see the test further below)
    "rand": (["-t", "1", "--rand"], 1),
    "rand-dirsharing-two-bench-dirs": (["-t", "1", "--rand",
                                        "--dirsharing"], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_bytes_and_phase_counts_equal_the_jax_package(tmp_path, case):
    flags, num_dirs = CASES[case]
    threads = int(flags[1])
    jax_dirs = make_dirs(tmp_path, "jax", num_dirs)
    port_dirs = make_dirs(tmp_path, "port", num_dirs)
    create = ["-d", "--statdirs", "-w", "--stat", "-r", "--gpuverify",
              *flags, *DIR_WORKLOAD]
    jax_recs, port_recs = run_both(create, jax_dirs, port_dirs, tmp_path,
                                   "create")
    assert [r["Phase"] for r in port_recs] == \
        ["MKDIRS", "STATDIRS", "WRITE", "STAT", "READ"]
    assert_same_counts(jax_recs, port_recs, threads, rand="--rand" in flags)
    for jd, pd in zip(jax_dirs, port_dirs):
        assert tree(pd) == tree(jd)
    files = 2 * 3 * threads
    write, read = port_recs[2], port_recs[4]
    assert write["EntriesLast"] == read["EntriesLast"] == files
    assert write["BytesLast"] == read["BytesLast"] \
        == read["TpuHbmBytes"] == files * (12 << 10)
    assert read["TpuH2dStagedOps"] == files * 3
    for rec in port_recs:
        if rec["Phase"] in ENTRY_PHASES:
            # entry phases: entries and their latencies, no device bytes
            assert rec["EntriesLast"] and rec["TpuHbmBytes"] == 0
            assert rec["EntLatHisto"]["LatNumValues"] == rec["EntriesLast"]
            assert rec["IOLatHisto"]["LatNumValues"] == 0

    jax_recs, port_recs = run_both(["-F", "-D", *flags, *DIR_WORKLOAD],
                                   jax_dirs, port_dirs, tmp_path, "delete")
    assert [r["Phase"] for r in port_recs] == ["RMFILES", "RMDIRS"]
    assert_same_counts(jax_recs, port_recs, threads)
    assert port_recs[0]["EntriesLast"] == files
    for jd, pd in zip(jax_dirs, port_dirs):
        assert tree(pd) == tree(jd) == {}


def test_each_package_reads_the_others_tree_under_verify(tmp_path):
    (jax_dir,) = make_dirs(tmp_path, "jax", 1)
    (port_dir,) = make_dirs(tmp_path, "port", 1)
    flags = ["-t", "2", *DIR_WORKLOAD]
    assert run_jax(["-d", "-w", *flags], [jax_dir]) == 0
    assert run_port(["-d", "-w", *flags], [port_dir]) == 0
    assert run_port(["-r", *flags], [jax_dir]) == 0
    assert run_port(["-r", "--gpuverify", *flags], [jax_dir]) == 0
    assert run_jax(["-r", *flags], [port_dir]) == 0
    assert run_jax(["-r", "--gpuverify", *flags], [port_dir]) == 0


def test_one_flipped_byte_in_one_file_fails_the_verify_read(tmp_path,
                                                            capsys):
    (bench,) = make_dirs(tmp_path, "port", 1)
    flags = ["-t", "2", *DIR_WORKLOAD]
    assert run_port(["-d", "-w", *flags], [bench]) == 0
    path = bench / "r1" / "d1" / "r1-f2"
    data = bytearray(path.read_bytes())
    data[5000] ^= 0x10
    path.write_bytes(bytes(data))
    capsys.readouterr()
    assert run_port(["-r", "--gpuverify", *flags], [bench]) == 1
    err = capsys.readouterr().err
    assert "on-device integrity check failed for block at offset 4096" in err


@pytest.mark.parametrize("size", ["16K", "4K"])
def test_rand_amount_is_per_file_divided_by_threads(tmp_path, size):
    """Dir mode's --rand amount is the file size divided by the threads,
    per file, and at least one block (a quirk of the reference, kept):
    with two threads each 16K file gets 8K of random blocks, and a 4K
    file still gets its one 4K block."""
    jax_dirs = make_dirs(tmp_path, "jax", 1)
    port_dirs = make_dirs(tmp_path, "port", 1)
    jax_recs, port_recs = run_both(
        ["-d", "-w", "--rand", "-t", "2", "-n", "1", "-N", "2", "-s", size,
         "-b", "4K"], jax_dirs, port_dirs, tmp_path, "rand")
    assert_same_counts(jax_recs, port_recs, threads=2, rand=True)
    per_file = max((int(size[:-1]) << 10) // 2, 4 << 10)
    assert port_recs[1]["BytesLast"] == 2 * 2 * per_file


def _error_line(text):
    return [ln.split("ERROR: ", 1)[1] for ln in text.splitlines()
            if "ERROR: " in ln][0]


def test_write_without_mkdirs_fails_with_the_jax_packages_text(tmp_path,
                                                               capsys):
    (bench,) = make_dirs(tmp_path, "bench", 1)
    flags = ["-w", "-t", "1", "-n", "1", "-N", "1", "-s", "4K"]
    capsys.readouterr()
    assert run_jax(flags, [bench]) != 0
    jax_err = capsys.readouterr().err
    assert run_port(flags, [bench]) != 0
    port_err = capsys.readouterr().err
    want = ("File create/open failed. Did you forget to enable directory "
            "creation ('--mkdirs'/-d)? Path: "
            f"{os.path.join(bench, 'r0/d0/r0-f0')}")
    assert want in jax_err and want in port_err


@pytest.mark.parametrize("kind", ["mixed", "dirphase-on-file"])
def test_config_errors_equal_the_jax_packages(tmp_path, capsys, kind):
    (bench,) = make_dirs(tmp_path, "bench", 1)
    afile = tmp_path / "f.bin"
    afile.write_bytes(bytes(4096))
    if kind == "mixed":
        argv, paths = ["-r", "-s", "4K"], [bench, afile]
        want = "all bench paths must have the same type"
    else:
        argv, paths = ["-d", "-w", "-s", "4K"], [afile]
        want = "directory phases (--mkdirs/--deldirs/--statdirs) require " \
               "directory bench paths"
    capsys.readouterr()
    assert run_jax(argv, paths) == 1
    jax_err = _error_line(capsys.readouterr().err)
    assert run_port(argv, paths) == 1
    port_err = _error_line(capsys.readouterr().err)
    assert port_err == jax_err and want in port_err
