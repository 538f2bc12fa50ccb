"""Direct I/O and the access patterns of the port (device="cpu") against
the JAX package: --direct/--nodiocheck/--nofdsharing, --randamount/
--norandalign/--randalgo, --backward/--strided/--shufflewindow, and the
{N..M} expansion of bench paths with --nopathexp.

The generators' offset and length sequences and next_batch arrays are
compared at tolerance 0 for the same sizes, seeds and --randalgo tiers;
so are the configuration's derived values, refusals and notes. The CLI
runs at -s 512K -b 4K (file mode) or -n 2 -N 3 -s 12K -b 4K (dir mode)
through both packages in every block loop (the fused ring, the Python
loop staged and --gpudirect, the engine's block loop, the engine's
per-file loop and the Python host loop): the records, each worker's
counts and the file bytes are compared, and spies on os.open and on the
engine's loops show O_DIRECT on every open and which loop served each
phase. Offsets drawn with seed=None are never compared, only their
coverage and counts.

Whether the file system under the test's directory honours O_DIRECT
(refusing a misaligned read) is probed, not assumed: where it does not,
the EINVAL phase failures become runs that pass, in both packages alike.
"""

import mmap
import os
import re

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.config import args as jax_args_mod
from elbencho_tpu.toolkits import offset_gen as jax_gen
from elbencho_tpu.toolkits import random_algos as jax_rand
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu.workers import local_worker as jax_lw
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.config import args as port_args_mod
from elbencho_tpu_torch.toolkits import offset_gen as port_gen
from elbencho_tpu_torch.toolkits import random_algos as port_rand
from elbencho_tpu_torch.utils import native as port_native
from elbencho_tpu_torch.workers import local_worker as port_lw
from test_torch_dirmode import jax_args, tree
from test_torch_fileloop import failure_lines
from test_torch_native import jax_engine
from test_torch_rwmix import (BLOCKS, LOOPS, SIZE, Pair, summary,
                              verify_pattern_ok)
from test_torch_slice import (assert_same_slice_record, run_both,
                              slice_record)

torch.set_num_threads(1)

ALGOS = ("strong", "balanced_single", "balanced", "fast")
DIR_LAYOUT = ["-n", "2", "-N", "3", "-s", "12K", "-b", "4K"]
DEVICE_LOOPS = ("ring", "ring-direct", "python", "python-direct")
EINVAL_TEXT = "OSError: [Errno 22] Invalid argument"


def drain(gen):
    return list(gen)


def batches(gen, max_n):
    out = []
    while (b := gen.next_batch(max_n)) is not None:
        out.append((b[0].tolist(), b[1].tolist()))
    return out


def covers_once(blocks, num_bytes, start=0):
    """The (offset, length) pairs tile [start, start+num_bytes) exactly
    once."""
    spans = sorted(blocks)
    pos = start
    for off, length in spans:
        if off != pos:
            return False
        pos += length
    return pos == start + num_bytes


def o_direct_probe(directory) -> "tuple[bool, bool]":
    """(an O_DIRECT open works, a misaligned O_DIRECT read is refused) in
    `directory`."""
    path = os.path.join(directory, "probe")
    with open(path, "wb") as f:
        f.write(bytes(8192))
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except OSError:
        os.unlink(path)
        return False, False
    buf = mmap.mmap(-1, 8192)
    try:
        os.preadv(fd, [memoryview(buf)[1:4097]], 0)
        refused = False
    except OSError:
        refused = True
    finally:
        os.close(fd)
        buf.close()
        os.unlink(path)
    return True, refused


# ----------------------------------------------------------------------
# the generators
# ----------------------------------------------------------------------

SEQ_CASES = [(10000, 1024, 0), (16384, 4096, 0), (1000, 300, 7),
             (4096, 4096, 0), (100, 300, 0), (65536 + 1000, 4096, 8192)]


@pytest.mark.parametrize("case", SEQ_CASES)
def test_reverse_seq_equals_the_jax_packages(case):
    """--backward: the same blocks, last first, the short one first; in
    scalar and batch form, again after reset()."""
    n, bs, start = case
    port = port_gen.OffsetGenReverseSeq(n, bs, start=start)
    jax = jax_gen.OffsetGenReverseSeq(n, bs, start=start)
    want = drain(jax)
    assert drain(port) == want
    assert covers_once(want, n, start)
    assert want[0][1] == (n % bs or min(bs, n))
    for max_n in (1, 3, 1000):
        port.reset()
        jax.reset()
        assert batches(port, max_n) == batches(jax, max_n)
    port.reset()
    assert drain(port) == want


RAND_CASES = [(64 << 10, 4096, 256 << 10), (10000, 3000, 50000),
              (4096, 4096, 4096), (20000, 4096, 20480)]


@pytest.mark.parametrize("case", RAND_CASES)
@pytest.mark.parametrize("kind", ["unaligned", "aligned", "full"])
@pytest.mark.parametrize("algo", ALGOS)
def test_random_generators_equal_the_jax_packages_for_each_randalgo(
        algo, kind, case):
    """--rand with each --randalgo tier and a fixed seed: unaligned
    (--norandalign), aligned, and the full-coverage permutation of
    aligned writes; scalar, batched and after reset()."""
    n, bs, range_len = case
    names = {"unaligned": "OffsetGenRandom",
             "aligned": "OffsetGenRandomAligned",
             "full": "OffsetGenRandomAlignedFullCoverage"}

    def make(gen_mod, rand_mod):
        return getattr(gen_mod, names[kind])(
            rand_mod.create_rand_algo(algo, seed=12345), n, bs,
            range_len=range_len)

    want = drain(make(jax_gen, jax_rand))
    port = make(port_gen, port_rand)
    assert drain(port) == want
    assert sum(length for _, length in want) == n
    assert all(0 <= off and off + length <= range_len
               for off, length in want)
    if kind != "unaligned":
        assert all(off % bs == 0 for off, _ in want)
    if kind == "full" and n == range_len and n % bs == 0:
        assert covers_once(want, n)
    for max_n in (1, 5, 1000):
        assert batches(make(port_gen, port_rand), max_n) == \
            batches(make(jax_gen, jax_rand), max_n)
    if kind == "full":
        port.reset()  # the same permutation again
        assert drain(port) == want


SHUFFLE_CASES = [(64 << 10, 4096, 16 << 10, 0, 0),
                 ((64 << 10) + 1000, 4096, 20 << 10, 7, 4096),
                 (64 << 10, 4096, 4096, 3, 0),
                 (64 << 10, 4096, 1 << 20, 1_000_003, 0)]


@pytest.mark.parametrize("case", SHUFFLE_CASES)
def test_shuffle_window_equals_the_jax_packages(case):
    """--shufflewindow: numpy's RandomState permutation under the JAX seed
    mix, window by window, every block exactly once; a batch never spans
    two windows."""
    n, bs, window, seed, start = case
    port = port_gen.OffsetGenShuffleWindow(n, bs, window, seed=seed,
                                           start=start)
    jax = jax_gen.OffsetGenShuffleWindow(n, bs, window, seed=seed,
                                         start=start)
    want = drain(jax)
    assert drain(port) == want
    assert covers_once(want, n, start)
    win = max(1, window // bs)
    for i in range(0, len(want), win):  # each window holds its own blocks
        assert {(off - start) // bs // win for off, _ in want[i:i + win]} \
            == {i // win}
    for max_n in (1, 3, 100):
        port.reset()
        jax.reset()
        got = batches(port, max_n)
        assert got == batches(jax, max_n)
        assert all(len(offs) <= min(max_n, win) for offs, _ in got)
    other = port_gen.OffsetGenShuffleWindow(n, bs, window, seed=seed + 1,
                                            start=start)
    assert sorted(drain(other)) == sorted(want)
    if win > 2:
        assert drain(other) != want


STRIDED_CASES = [(8192, 1024, 0, 2, 0), (8192, 1024, 1, 2, 0),
                 (5000, 1024, 2, 3, 512), (4096, 4096, 3, 4, 0)]


@pytest.mark.parametrize("case", STRIDED_CASES)
def test_strided_with_a_rank_equals_the_jax_packages(case):
    """OffsetGenStrided takes the JAX package's rank as a keyword (the
    port's third argument stays the dataset threads, as the
    --treeroundrob caller passes them): worker r starts at r blocks."""
    n, bs, rank, ndst, start = case
    port = port_gen.OffsetGenStrided(n, bs, ndst, start=start, rank=rank)
    jax = jax_gen.OffsetGenStrided(n, bs, rank, ndst, start=start)
    want = drain(jax)
    assert drain(port) == want
    assert want[0][0] == start + rank * bs
    for max_n in (1, 3, 1000):
        port.reset()
        jax.reset()
        assert batches(port, max_n) == batches(jax, max_n)
    # the --treeroundrob call: rank 0, the share's first block as start
    assert drain(port_gen.OffsetGenStrided(n, bs, ndst, start=start)) == \
        drain(jax_gen.OffsetGenStrided(n, bs, 0, ndst, start=start))


def test_every_generator_resets_where_the_jax_packages_do():
    def gens(mod, rand_mod):
        rand = rand_mod.create_rand_algo("fast", seed=9)
        return [mod.OffsetGenSequential(9000, 1000, start=5),
                mod.OffsetGenReverseSeq(9000, 1000),
                mod.OffsetGenRandom(rand, 9000, 1000, range_len=20000),
                mod.OffsetGenRandomAligned(rand, 9000, 1000,
                                           range_len=20000),
                mod.OffsetGenRandomAlignedFullCoverage(rand, 9000, 1000,
                                                       range_len=9000),
                mod.OffsetGenShuffleWindow(9000, 1000, 3000, seed=2)]

    for port, jax in zip(gens(port_gen, port_rand), gens(jax_gen, jax_rand),
                         strict=True):
        first = drain(port)
        port.reset()
        jax_first = drain(jax)
        jax.reset()
        # a PRNG-driven generator draws on after reset, in both packages
        assert drain(port) == drain(jax)
        assert len(first) == len(jax_first)


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------

def derived(argv, capsys):
    """{package: (derived values, NOTE lines)} of one argv."""
    out = {}
    for pkg, mod in (("port", port_args_mod), ("jax", jax_args_mod)):
        capsys.readouterr()
        cfg, _ = mod.parse_cli(jax_args(argv) if pkg == "jax" else argv)
        cfg.derive()
        cfg.check()
        notes = [ln for ln in capsys.readouterr().out.splitlines()
                 if "NOTE" in ln]
        out[pkg] = ((cfg.paths, cfg.file_size, cfg.block_size,
                     cfg.random_amount), [ln.split("NOTE", 1)[1]
                                          for ln in notes])
    return out


@pytest.mark.parametrize("flags", [
    ["-r", "--rand", "-s", "1M"],
    ["-r", "--rand", "--randamount", "300K", "-s", "1M"],
    ["-r", "--randamount", "300K", "-s", "1M"],
    ["-w", "--rand", "-s", "1M", "-b", "300K"],
    ["-w", "--direct", "-s", "10K", "-b", "4K"],
    ["-w", "--strided", "-s", "10K", "-b", "4K"],
    ["-w", "-s", "10K", "-b", "4K"],
    ["-r", "--direct", "--nodiocheck", "-s", "8000", "-b", "1000"],
])
@pytest.mark.parametrize("paths", ["one", "two", "dir"])
def test_derived_values_and_notes_equal_the_jax_packages(tmp_path, capsys,
                                                         flags, paths):
    """The random amount (an explicit --randamount kept, else the
    dataset), the trim of the file size to whole blocks under --direct,
    --rand and --strided with its note, in file mode over one and two
    files and in dir mode."""
    if paths == "dir":
        bench = [str(tmp_path)]
    else:
        bench = [str(tmp_path / f"f{i}") for i in range(
            1 if paths == "one" else 2)]
    got = derived(flags + bench, capsys)
    assert got["port"] == got["jax"]
    trimmed = "10K" in flags and ("--direct" in flags
                                  or "--strided" in flags)
    assert bool(got["port"][1]) == (trimmed or "300K" in flags
                                    and "-w" in flags)


BRACE_CASES = [["/m/f{1..3}"], ["/m/f{01..03}"], ["/m/f{3..1}"],
               ["/m/d{1..2}/f{8..10}"], ["/m/f{9..11}x", "/m/g"],
               ["/m/f{1..1}", "/m/{a..b}"], ["/m/f{007..9}"]]


@pytest.mark.parametrize("paths", BRACE_CASES)
def test_path_expansion_equals_the_jax_packages(paths):
    want = jax_args_mod.BenchConfig._expand_path_braces(paths)
    assert port_args_mod.BenchConfig._expand_path_braces(paths) == want
    assert len(want) >= len(paths)


@pytest.mark.parametrize("nopathexp", [False, True])
def test_expansion_reaches_the_derived_paths_unless_nopathexp(
        tmp_path, capsys, nopathexp):
    argv = ["-w", "-s", "8K", "-b", "4K",
            *(["--nopathexp"] if nopathexp else []),
            str(tmp_path / "f{1..3}")]
    got = derived(argv, capsys)
    assert got["port"] == got["jax"]
    want = [str(tmp_path / "f{1..3}")] if nopathexp \
        else [str(tmp_path / f"f{i}") for i in (1, 2, 3)]
    assert got["port"][0][0] == want


REFUSALS = {
    "mmap-direct": (["-r", "--mmap", "--direct"],
                    "--mmap and --direct are incompatible"),
    "direct-block": (["-w", "--direct", "-s", "8000", "-b", "1000"],
                     "direct I/O requires file size and block size to be "
                     "multiples of 512 bytes (use --nodiocheck to "
                     "override)"),
    "direct-size": (["-w", "--direct", "-s", "1000", "-b", "1000"],
                    "direct I/O requires file size and block size to be "
                    "multiples of 512 bytes (use --nodiocheck to "
                    "override)"),
    **{f"shuffle-{name}": (["-r", "--shufflewindow", "16K", flag],
                           "--shufflewindow drives its own offset "
                           "permutation — incompatible with --rand/"
                           "--backward/--strided/--mmap")
       for name, flag in (("rand", "--rand"), ("backward", "--backward"),
                          ("strided", "--strided"), ("mmap", "--mmap"))},
    "shuffle-small": (["-r", "--shufflewindow", "2K"],
                      "--shufflewindow must be at least one --block"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_the_configuration_refuses_as_the_jax_package(tmp_path, capsys,
                                                      case):
    flags, text = REFUSALS[case]
    errs = {}
    for pkg, main in (("port", lambda argv: port_main(argv, device="cpu")),
                      ("jax", jax_main)):
        capsys.readouterr()
        argv = ["-s", "64K", "-b", "4K", *flags, "--nolive",
                str(tmp_path / "f")]
        assert main(jax_args(argv) if pkg == "jax" else argv) != 0, pkg
        errs[pkg] = [x for x in capsys.readouterr().err.splitlines()
                     if x.startswith("ERROR")]
    assert errs["port"] == errs["jax"] == [f"ERROR: {text}"]


def test_an_unknown_randalgo_fails_the_workers_as_the_jax_package(
        tmp_path, capsys):
    (tmp_path / "f").write_bytes(bytes(64 << 10))
    got = {}
    for pkg, main in (("port", lambda argv: port_main(argv, device="cpu")),
                      ("jax", jax_main)):
        capsys.readouterr()
        rc = main(["-r", "-s", "64K", "-b", "4K", "--randalgo", "foo",
                   "--nolive", str(tmp_path / "f")])
        got[pkg] = (rc, failure_lines(capsys.readouterr().err))
    assert got["port"] == got["jax"]
    assert got["port"][0] != 0
    assert any("unknown random algorithm: 'foo' (choose from strong, "
               "balanced_single, balanced, fast)" in x
               for x in got["port"][1])


# ----------------------------------------------------------------------
# CLI runs: --direct in every loop, with spies on os.open and the loops
# ----------------------------------------------------------------------

@pytest.fixture
def pair(tmp_path, monkeypatch):
    jax_engine(monkeypatch)
    return Pair(tmp_path, monkeypatch)


@pytest.fixture
def opens(tmp_path, monkeypatch):
    """{package: [(path relative to its directory, flags)]} of every
    os.open of a file under the test's directory, and of every file the
    engine's per-file loop opens (its open_flags), while the packages
    run; a run's package is the directory its path lies in."""
    calls = {"port": [], "jax": []}
    real_open = os.open

    def record(path, flags):
        rel = os.path.relpath(os.fspath(path), tmp_path)
        pkg = rel.split(os.sep)[0]
        if pkg in calls:
            calls[pkg].append((rel.split(os.sep, 1)[1], flags))

    def spy_open(path, flags, *args, **kwargs):
        if str(os.fspath(path)).startswith(str(tmp_path)):
            record(path, flags)
        return real_open(path, flags, *args, **kwargs)

    monkeypatch.setattr(os, "open", spy_open)
    for cls in (port_native._NativeEngine,
                type(jax_native.get_native_engine())):
        real = cls.run_file_loop

        def file_loop(self, paths, op, open_flags, *args, real=real, **kw):
            if op in ("write", "read"):
                for p in paths:
                    record(p, open_flags)
            return real(self, paths, op, open_flags, *args, **kw)

        monkeypatch.setattr(cls, "run_file_loop", file_loop)
    return calls


@pytest.fixture
def loops(monkeypatch):
    """{package: [loop, ...]}: each call into the engine's block loop
    ("block"), per-file loop ("file") and mmap loop ("mmap")."""
    calls = {"port": [], "jax": []}
    for pkg, cls in (("port", port_native._NativeEngine),
                     ("jax", type(jax_native.get_native_engine()))):
        for name, tag in (("run_block_loop", "block"),
                          ("run_file_loop", "file"),
                          ("run_mmap_loop", "mmap")):
            real = getattr(cls, name)

            def spy(self, *args, real=real, pkg=pkg, tag=tag, **kw):
                calls[pkg].append(tag)
                return real(self, *args, **kw)

            monkeypatch.setattr(cls, name, spy)
    return calls


def served_by(recs, calls) -> "list[str]":
    """Which loop served each phase: the fused ring (its ops in the
    record), the engine's block, per-file or mmap loop (their calls), or
    a Python loop."""
    if any(r["TpuStreamFusedOps"] for r in recs):
        return ["ring"]
    return sorted(set(calls)) or ["python"]


def device(loop, *flags):
    """--gpuverify beside --verify in a device loop."""
    return [*flags, "--gpuverify"] if loop in DEVICE_LOOPS else list(flags)


@pytest.mark.parametrize("threads", ["1", "2"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_direct_file_mode_equals_the_jax_package(pair, opens, loops, loop,
                                                 threads):
    """-w -r --direct --verify 5 in file mode: the bytes, records, worker
    counts and loops of the JAX package's run, and O_DIRECT on the one
    shared open of the file."""
    got = {}
    for pkg in ("port", "jax"):
        rc, recs, counts = pair(pkg, device(
            loop, "-w", "-r", "-t", threads, *SIZE, "--iodepth", "4",
            "--direct", "--verify", "5"), loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, served_by(recs, loops[pkg]))
    assert got["port"] == got["jax"]
    assert pair.read("port") == pair.read("jax")
    assert verify_pattern_ok(pair.read("port"), 5)
    write, read = got["port"][0]
    assert write["BytesLast"] == read["BytesLast"] == BLOCKS * 4096
    assert read["TpuHbmBytes"] == (BLOCKS * 4096 if loop in DEVICE_LOOPS
                                   else 0)
    for pkg in ("port", "jax"):
        assert [flags & os.O_DIRECT for name, flags in opens[pkg]
                if name == "f"] == [os.O_DIRECT], pkg
    assert got["port"][2] == {"ring": ["ring"], "ring-direct": ["ring"],
                              "native": ["block"]}.get(loop, ["python"])


@pytest.mark.parametrize("loop", ["native", "auto", "python",
                                  "python-direct", "host-python"])
def test_direct_dir_mode_equals_the_jax_package(pair, opens, loops, loop):
    """Dir mode -d -w -r --direct --verify 7: every file opened with
    O_DIRECT, by Python or by the engine's per-file loop (its open
    flags), and the tree, records and counts of the JAX package's run."""
    got = {}
    for pkg in ("port", "jax"):
        bench = pair.dir(pkg) / "bench"
        bench.mkdir()
        rc, recs, counts = pair(pkg, device(
            loop, "-d", "-w", "-r", "-t", "2", *DIR_LAYOUT, "--direct",
            "--verify", "7"), loop, name="bench")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, tree(bench),
                    served_by(recs, loops[pkg]))
    assert got["port"] == got["jax"]
    for pkg in ("port", "jax"):
        files = [(n, f) for n, f in opens[pkg] if n.startswith("bench/")]
        assert len(files) == 2 * 2 * 2 * 3, pkg  # write + read, 12 files
        assert all(f & os.O_DIRECT for _, f in files), pkg
    assert got["port"][3] == {"native": ["file"],
                              "auto": ["ring"]}.get(loop, ["python"])


@pytest.mark.parametrize("share", [False, True])
def test_nofdsharing_opens_one_fd_per_worker_and_closes_it(
        pair, opens, share):
    """Without --nofdsharing the manager opens the file once; with it each
    worker opens its own (with O_DIRECT under --direct) and closes it at
    the end: no fd is left open, in either package."""
    fds_before = len(os.listdir("/proc/self/fd"))
    got = {}
    flags = [] if share else ["--nofdsharing"]
    for pkg in ("port", "jax"):
        rc, recs, counts = pair(pkg, ["-w", "-r", "-t", "4", *SIZE,
                                      "--direct", "--verify", "3", *flags],
                                "native")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts,
                    [f & os.O_DIRECT for n, f in opens[pkg] if n == "f"])
    assert got["port"] == got["jax"]
    assert got["port"][2] == [os.O_DIRECT] * (1 if share else 4)
    assert len(os.listdir("/proc/self/fd")) == fds_before
    assert pair.read("port") == pair.read("jax")


def test_nofdsharing_serves_the_slice_phase_as_the_jax_package(tmp_path):
    """--gpuslice reads through the worker's path fds: its own under
    --nofdsharing, as the JAX package's tpuslice does."""
    flags = ["-w", "--gpuslice", "-t", "2", "-s", "2M", "-b", "64K",
             "--iodepth", "2", "--verify", "3", "--nofdsharing"]
    jrc, prc, jrecs, precs = run_both(flags, tmp_path)
    assert jrc == prc == 0
    assert_same_slice_record(slice_record(jrecs), slice_record(precs))


@pytest.mark.parametrize("loop", ["native", "python"])
def test_direct_custom_tree_opens_with_o_direct(pair, opens, loop):
    """A --treefile phase opens each tree file with O_DIRECT, through the
    engine's per-file loop or the block loops."""
    got = {}
    for pkg in ("port", "jax"):
        d = pair.dir(pkg)
        (d / "bench").mkdir()
        treefile = d / "tree.txt"
        treefile.write_text("f 8192 a/x\nf 4096 b\nf 16384 big\n")
        rc, recs, counts = pair(pkg, device(
            loop, "-w", "-r", "-t", "2", "-b", "4K", "--direct", "--verify",
            "3", "--treefile", str(treefile), "--sharesize", "16K"),
            loop, name="bench")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, tree(d / "bench"))
        files = [(n, f) for n, f in opens[pkg] if n.startswith("bench/")]
        assert files and all(f & os.O_DIRECT for _, f in files), pkg
    assert got["port"] == got["jax"]


# ----------------------------------------------------------------------
# the access patterns through every loop
# ----------------------------------------------------------------------

@pytest.fixture
def offsets(monkeypatch):
    """{package: {rank: [(offset, length), ...]}}: the sequence of each
    generator a worker makes for a file-mode phase (drained, then reset
    for the phase)."""
    seqs = {"port": {}, "jax": {}}
    for pkg, cls in (("port", port_lw.LocalWorker),
                     ("jax", jax_lw.LocalWorker)):
        real = cls._make_file_mode_offset_gen

        def make(self, *args, real=real, pkg=pkg, **kw):
            gen = real(self, *args, **kw)
            if gen is not None:
                seqs[pkg].setdefault(self.rank, []).append(drain(gen))
                gen.reset()
            return gen

        monkeypatch.setattr(cls, "_make_file_mode_offset_gen", make)
    return seqs


PATTERNS = {"backward": ["--backward"], "strided": ["--strided"],
            "shuffle": ["--shufflewindow", "64K"]}


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_a_pattern_reads_each_block_once_as_the_jax_package(
        pair, offsets, loops, pattern, loop, threads):
    """A --verify read under --backward, --strided or --shufflewindow (and
    --gpuverify on a device, so that every block is checked): each
    worker's offsets equal the JAX package's, the workers together read
    each block once, and the records, counts and loops agree."""
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *SIZE, "--verify", "5"])[0] == 0
        offsets[pkg].clear()
        rc, recs, counts = pair(pkg, device(
            loop, "-r", "-t", threads, *SIZE, "--iodepth", "4", "--verify",
            "5", *PATTERNS[pattern]), loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, served_by(recs, loops[pkg]))
    assert got["port"] == got["jax"]
    assert offsets["port"] == offsets["jax"]
    every = [b for seqs in offsets["port"].values() for seq in seqs
             for b in seq]
    assert covers_once(every, BLOCKS * 4096)
    (rec,) = got["port"][0]
    assert rec["BytesLast"] == BLOCKS * 4096
    assert sum(c[0] for c in got["port"][1].values()) == BLOCKS
    if loop in DEVICE_LOOPS:
        assert rec["TpuHbmBytes"] == BLOCKS * 4096


@pytest.mark.parametrize("pattern", ["backward", "shuffle", "strided"])
def test_dir_mode_patterns_leave_the_per_file_loop_as_the_jax_package(
        pair, loops, pattern):
    """Without a device, --backward and --shufflewindow send dir mode to
    the block loops; --strided means nothing within a worker's file and
    is ignored in dir mode (the per-file loop still serves it), in both
    packages."""
    got = {}
    for pkg in ("port", "jax"):
        bench = pair.dir(pkg) / "bench"
        bench.mkdir()
        flags = ["--shufflewindow", "8K"] if pattern == "shuffle" \
            else PATTERNS[pattern]
        rc, recs, counts = pair(pkg, ["-d", "-w", "-r", "-t", "2",
                                      *DIR_LAYOUT, "--verify", "7", *flags],
                                "native", name="bench")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, tree(bench), sorted(loops[pkg]))
    assert got["port"] == got["jax"]
    assert set(got["port"][3]) == ({"file"} if pattern == "strided"
                                   else {"block"})


@pytest.mark.parametrize("pattern", ["backward", "strided", "shuffle"])
@pytest.mark.parametrize("loop", ["python", "python-direct", "ring"])
def test_a_pattern_under_gpubatch_copies_as_the_jax_package(
        pair, loop, pattern):
    """--gpubatch 4 packs four blocks into one copy whatever their
    offsets: a backward, strided or shuffled read's spans are not
    contiguous in the file, and both packages copy them alike."""
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *SIZE, "--verify", "5"])[0] == 0
        rc, recs, counts = pair(pkg, ["-r", "-t", "2", *SIZE, "--iodepth",
                                      "4", "--verify", "5", "--gpubatch",
                                      "4", *PATTERNS[pattern]], loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts)
    assert got["port"] == got["jax"]
    (rec,) = got["port"][0]
    assert rec["TpuHbmBytes"] == BLOCKS * 4096
    assert rec["TpuH2dStagedOps"] + rec["TpuH2dDirectOps"] == BLOCKS // 4


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("loop", ["native", "ring", "python"])
def test_rand_with_each_randalgo_and_randamount_as_the_jax_package(
        pair, loops, loop, algo):
    """--rand --randamount 192K --randalgo ALGO: the counts of the JAX
    package's run (its offsets are seeded afresh) and every block read
    verified; each tier reaches the worker's offset generator."""
    made = []
    real = port_rand.create_rand_algo

    def spy(name, seed=None):
        made.append(name)
        return real(name, seed)

    pair.monkeypatch.setattr(port_lw, "create_rand_algo", spy)
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *SIZE, "--verify", "5"])[0] == 0
        made.clear()
        rc, recs, counts = pair(pkg, device(
            loop, "-r", "-t", "2", *SIZE, "--iodepth", "4", "--rand",
            "--randamount", "192K", "--randalgo", algo, "--verify", "5"),
            loop)
        assert rc == 0, pkg
        got[pkg] = ([{k: v for k, v in r.items()
                      if not k.startswith("TpuD2hPrefetch")}
                     for r in summary(recs)], counts,
                    served_by(recs, loops[pkg]), list(made))
    assert got["port"][:3] == got["jax"][:3]
    assert got["port"][0][0]["BytesLast"] == 192 << 10
    assert got["port"][3] == [algo, algo]  # one per worker


# ----------------------------------------------------------------------
# the phase failures of misaligned direct I/O
# ----------------------------------------------------------------------

def errors_of_both(pair, capsys, args, loop, prepare=None):
    got = {}
    for pkg in ("port", "jax"):
        if prepare:
            prepare(pkg)
        capsys.readouterr()
        rc, _, _ = pair(pkg, args, loop)
        # the workers' lines in the order they failed, which is timing's
        got[pkg] = (rc, sorted(re.sub("tpu", "gpu", x) for x in
                               failure_lines(capsys.readouterr().err,
                                             pair.dir(pkg))))
    return got


@pytest.mark.parametrize("loop", ["native", "ring", "python",
                                  "host-python"])
@pytest.mark.parametrize("case", ["nodiocheck-block", "norandalign",
                                  "three-slices"])
def test_misaligned_direct_io_fails_the_phase_as_the_jax_package(
        pair, capsys, tmp_path, loop, case):
    """-w -s 8000 -b 1000 --direct --nodiocheck, a --rand --norandalign
    --direct read, and a -t 3 --direct write whose workers' slices start
    off a block boundary: where the file system enforces O_DIRECT's
    alignment, both packages fail the phase with EINVAL (the JAX text);
    where it does not, both runs pass."""
    opens_ok, enforced = o_direct_probe(tmp_path)
    assert opens_ok, "the test directory refuses O_DIRECT opens"
    if case == "nodiocheck-block":
        args, prepare = ["-w", "-s", "8000", "-b", "1000", "--direct",
                         "--nodiocheck"], None
    elif case == "three-slices":
        args, prepare = ["-w", "-t", "3", *SIZE, "--direct"], None
    else:
        args = ["-r", "-t", "1", *SIZE, "--direct", "--rand",
                "--norandalign"]

        def prepare(pkg):
            assert pair(pkg, ["-w", *SIZE])[0] == 0
    got = errors_of_both(pair, capsys, args, loop, prepare)
    if case == "three-slices":
        # workers 1 and 2 fail at their first op; worker 0 only at its
        # short last block, unless the others' failure interrupts it first
        got = {pkg: (rc, [x for x in lines if "Worker 0" not in x])
               for pkg, (rc, lines) in got.items()}
    assert got["port"] == got["jax"]
    rc, lines = got["port"]
    if enforced:
        phase = "READFILES" if case == "norandalign" else "CREATEFILES"
        assert rc != 0
        assert any(re.fullmatch(f"ERROR: Worker [0-2] phase {phase} "
                                f"failed: {re.escape(EINVAL_TEXT)}", x)
                   for x in lines), lines
    else:
        assert rc == 0 and not lines


# ----------------------------------------------------------------------
# quirks kept and faults of the reference not kept
# ----------------------------------------------------------------------

def masked(lines) -> "set[str]":
    """A run's worker failures with their numbers masked: the offsets of
    random reads drawn with seed=None are never compared."""
    return {re.sub(r"0x[0-9a-f]+|\d+", "N", x) for x in lines
            if "phase" in x and "failed" in x}


@pytest.mark.parametrize("loop", ["native", "host-python", "ring",
                                  "python", "python-direct"])
def test_norandalign_verify_fails_as_the_jax_package(pair, capsys, loop):
    """A quirk kept: a --rand --norandalign --verify read of a file that
    holds the pattern fails in both packages. Each holds a block to the
    pattern laid out from the block's own offset (on the host, or with
    --gpuverify as the device's fingerprint), which the file does not
    hold at an offset that is not a multiple of 8."""
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *SIZE, "--verify", "5"])[0] == 0
        capsys.readouterr()
        rc = pair(pkg, device(loop, "-r", "-t", "2", *SIZE, "--rand",
                              "--norandalign", "--verify", "5"), loop)[0]
        lines = failure_lines(capsys.readouterr().err)
        offsets = [int(m) for x in lines
                   for m in re.findall(r"at (?:file )?offset (\d+)", x)]
        assert offsets and all(off % 8 for off in offsets), lines
        got[pkg] = (rc, masked(lines))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1
    text = ("ValueError: on-device integrity check failed for block"
            if loop in DEVICE_LOOPS else
            "WorkerException: data integrity check failed at file offset")
    assert all(text in x for x in got["port"][1]), got["port"]


@pytest.mark.parametrize("feature", ["--readinline", "--verifydirect"])
@pytest.mark.parametrize("loop", ["native", "host-python", "python",
                                  "python-direct"])
def test_norandalign_write_readback_verifies_as_the_jax_package(
        pair, loops, loop, feature):
    """-w --rand --norandalign --verify with --readinline or
    --verifydirect: each block is read back where it was just written,
    laid out from its own offset, and verifies in both packages, through
    the same loop."""
    got = {}
    for pkg in ("port", "jax"):
        loops[pkg].clear()
        rc, recs, counts = pair(pkg, ["-w", "-t", "1", *SIZE, "--rand",
                                      "--norandalign", "--verify", "5",
                                      feature], loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts, served_by(recs, loops[pkg]))
    assert got["port"] == got["jax"]
    assert got["port"][2] == (["block"] if loop == "native" else ["python"])
    assert got["port"][0][0]["BytesLast"] == BLOCKS * 4096


@pytest.mark.parametrize("feature", [["--readinline"], ["--verifydirect"],
                                     ["--rwmixpct", "30"]])
@pytest.mark.parametrize("loop", ["native", "python", "auto"])
def test_direct_with_readback_and_rwmix_equals_the_jax_package(
        pair, loop, feature):
    """--direct beside the read-back of --readinline/--verifydirect and
    the reads of --rwmixpct, over a file that holds the pattern: the
    bytes, records and counts of the JAX package's run."""
    got = {}
    for pkg in ("port", "jax"):
        assert pair(pkg, ["-w", *SIZE, "--verify", "9"])[0] == 0
        rc, recs, counts = pair(pkg, ["-w", "-t", "2", *SIZE, "--direct",
                                      "--verify", "9", *feature], loop)
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts)
    assert got["port"] == got["jax"]
    assert pair.read("port") == pair.read("jax")
    assert verify_pattern_ok(pair.read("port"), 9)


@pytest.mark.parametrize("loop", ["native", "auto"])
def test_direct_dir_mode_trims_a_partial_block_as_the_jax_package(
        pair, capsys, loop):
    """Dir mode --direct with -s 10K -b 4K: the file size is trimmed to
    8 KiB with the JAX package's note, and every file holds two blocks."""
    got = {}
    for pkg in ("port", "jax"):
        bench = pair.dir(pkg) / "bench"
        bench.mkdir()
        capsys.readouterr()
        rc, recs, counts = pair(pkg, ["-d", "-w", "-r", "-t", "2", "-n",
                                      "1", "-N", "2", "-s", "10K", "-b",
                                      "4K", "--direct", "--verify", "3"],
                                loop, name="bench")
        assert rc == 0, pkg
        notes = [ln.split("NOTE", 1)[1]
                 for ln in capsys.readouterr().out.splitlines()
                 if "NOTE: File size" in ln]
        got[pkg] = (summary(recs), counts, tree(bench), notes)
    assert got["port"] == got["jax"]
    assert got["port"][3] == [
        ": File size has to be a multiple of block size for direct IO, "
        "random IO and strided IO. Reducing file size. Old: 10240; New: "
        "8192"]
    assert all(len(v) == 8192 for v in got["port"][2].values()
               if v is not None)


def test_expanded_paths_run_as_the_jax_packages_and_nopathexp_does_not(
        pair):
    """-w -r over f{1..4} writes and reads four striped files in both
    packages; --nopathexp takes the name with its braces as one file."""
    got = {}
    for pkg in ("port", "jax"):
        rc, recs, counts = pair(pkg, ["-w", "-r", "-t", "2", "-s", "64K",
                                      "-b", "4K", "--verify", "3",
                                      "--gpuverify"], "ring",
                                name="f{1..4}")
        assert rc == 0, pkg
        rc2, recs2, _ = pair(pkg, ["-w", "-s", "64K", "-b", "4K",
                                   "--nopathexp"], "native",
                             name="g{1..2}")
        assert rc2 == 0, pkg
        got[pkg] = (summary(recs), counts, summary(recs2),
                    sorted(os.listdir(pair.dir(pkg))))
    assert got["port"] == got["jax"]
    names = got["port"][3]
    assert {"f1", "f2", "f3", "f4", "g{1..2}"} <= set(names)
    assert "f{1..4}" not in names
    write, read = got["port"][0]
    assert write["BytesLast"] == read["BytesLast"] == 4 * (64 << 10)
    assert read["TpuHbmBytes"] == 4 * (64 << 10)
    for i in (1, 2, 3, 4):
        assert pair.read("port", f"f{i}") == pair.read("jax", f"f{i}")


def test_strided_file_mode_over_striped_files_equals_the_jax_package(
        pair, offsets):
    """--strided over two files: the workers' interleaved blocks run over
    the striped range, each block once, as in the JAX package."""
    got = {}
    for pkg in ("port", "jax"):
        d = pair.dir(pkg)
        offsets[pkg].clear()
        rc, recs, counts = pair(pkg, ["-w", "-r", "-t", "3", "-s", "64K",
                                      "-b", "4K", "--strided", "--verify",
                                      "3"], "ring", name="s{1..2}")
        assert rc == 0, pkg
        got[pkg] = (summary(recs), counts,
                    [(d / f"s{i}").read_bytes() for i in (1, 2)])
    assert got["port"] == got["jax"]
    assert offsets["port"] == offsets["jax"]
    reads = [seq for seqs in offsets["port"].values() for seq in seqs[1:]]
    assert covers_once([b for seq in reads for b in seq], 2 * (64 << 10))

