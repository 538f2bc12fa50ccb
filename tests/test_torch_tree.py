"""Custom trees in the port (device="cpu") against the JAX package:
--treefile, --treerand, --treeroundrob, --treeroundup, --sharesize and
--treescan.

The port's PathStore gives the JAX package's elements for generated
trees: the non-shared, shared and round-robin sublists of every worker
(a round-robin element's range_len aside: the port's counts the bytes
the worker's strided blocks hold), the split at the share size, the round-up and the seed-42 shuffle, and
a base64 tree file. --treescan writes the JAX package's tree file, with
its texts for a missing --treefile and a path that is not a directory.
A tree of small, zero-length and shared files runs -w --stat -r and -F
through both CLIs in three loops (the engine's per-file loop without a
device, --gpuids 0 where the shared ranges take the fused ring, and the
Python loop at --gpustream off): the files, the counts and the fused
ring's ops are equal at tolerance 0. The one departure is pinned: under
--treeroundrob the port writes each shared file whole, where the JAX
package writes it short (ROADMAP.md C).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.toolkits import file_tk as jax_file_tk
from elbencho_tpu.toolkits import path_store as jax_ps
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.toolkits import file_tk as port_file_tk
from elbencho_tpu_torch.toolkits import offset_gen as port_og
from elbencho_tpu_torch.toolkits import path_store as port_ps
from test_torch_dirmode import LAST_COUNT_KEYS, jax_args, tree
from test_torch_native import jax_engine

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# PathStore: the sublists of generated trees
# ----------------------------------------------------------------------

def tree_text(seed: int) -> str:
    """A tree file of 1-40 files: zero-length, small, block multiples and
    large, some names sharing a length, a few dir lines and comments."""
    rng = np.random.RandomState(seed)
    lines = ["# a generated tree", "d top"]
    for i in range(int(rng.randint(1, 41))):
        kind = rng.randint(4)
        size = (0, int(rng.randint(1, 9000)), 4096 * int(rng.randint(1, 20)),
                int(rng.randint(60000, 400000)))[kind]
        depth = int(rng.randint(0, 3))
        name = "/".join(f"d{int(rng.randint(3))}" for _ in range(depth))
        lines.append(f"f {size} {name + '/' if name else ''}f{i}")
    return "\n".join(lines) + "\n"


def elems(store):
    return [(e.path, e.total_len, e.range_start, e.range_len)
            for e in store.elems]


def sublists(mod, text, block, ndst, share, round_up, rand):
    """Every worker's three sublists and the split, as element tuples."""
    store = mod.PathStore(block_size=block)
    store.load_files_from_text(text, round_up_size=round_up)
    if rand:
        store.random_shuffle(seed=42)
    else:
        store.sort_by_path_len()
    non_shared, shared = store.split_by_share_size(share)
    out = [elems(store), elems(non_shared), elems(shared),
           store.num_paths, store.total_bytes]
    for rank in range(ndst):
        # a round-robin element's range_len is the pinned departure: the
        # port's counts the worker's strided bytes (see below)
        out += [elems(non_shared.get_worker_sublist_non_shared(rank, ndst)),
                elems(shared.get_worker_sublist_shared(rank, ndst)),
                [e[:3] for e in elems(
                    shared.get_worker_sublist_shared_round_robin(rank,
                                                                 ndst))]]
    return out


@pytest.mark.parametrize("ndst", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", range(6))
def test_sublists_equal_the_jax_packages(seed, ndst):
    text = tree_text(seed)
    for block, share, round_up, rand in ((4096, 8192, 0, False),
                                         (4096, 65536, 4096, True),
                                         (16384, 16384 * ndst, 0, True),
                                         (1000, 3000, 3000, False)):
        args = (text, block, ndst, share, round_up, rand)
        assert sublists(port_ps, *args) == sublists(jax_ps, *args), args


def strided_blocks(elem, block, ndst):
    return list(port_og.OffsetGenStrided(elem.range_len, block, ndst,
                                         start=elem.range_start))


@pytest.mark.parametrize("ndst", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", range(6))
def test_round_robin_shares_cover_each_shared_file_once(seed, ndst):
    """The port reads a --treeroundrob element with OffsetGenStrided from
    range_start over range_len bytes: over all workers each block of
    each shared file comes once, with its length, the short last block
    included, and each element's range_len is the bytes it moves."""
    block = 4096
    store = port_ps.PathStore(block_size=block)
    store.load_files_from_text(tree_text(seed))
    store.sort_by_path_len()
    _, shared = store.split_by_share_size(2 * block)
    blocks = {}
    for rank in range(ndst):
        for e in shared.get_worker_sublist_shared_round_robin(
                rank, ndst).elems:
            got = strided_blocks(e, block, ndst)
            assert sum(length for _, length in got) == e.range_len, e
            blocks.setdefault(e.path, []).extend(got)
    for e in shared.elems:
        want = [(off, min(block, e.total_len - off))
                for off in range(0, e.total_len, block)]
        assert sorted(blocks[e.path]) == want, e


@pytest.mark.parametrize("rank, start, range_len, jax_range_len",
                         [(0, 0, 8192, 8192), (1, 4096, 5808, 8192)])
def test_round_robin_range_len_counts_the_short_last_block(
        rank, start, range_len, jax_range_len):
    """f 14000 at -b 4K over two workers: rank 1 takes blocks 1 and 3, the
    last 1712 bytes long; the JAX package books it 8192."""
    elems_ = {}
    for name, ps in (("port", port_ps), ("jax", jax_ps)):
        store = ps.PathStore(block_size=4096)
        store.load_files_from_text("f 14000 big\n")
        elems_[name] = elems(store.get_worker_sublist_shared_round_robin(
            rank, 2))
    assert elems_["port"] == [("big", 14000, start, range_len)]
    assert elems_["jax"] == [("big", 14000, start, jax_range_len)]


def test_a_base64_tree_file_loads_as_in_the_jax_package(tmp_path):
    names = ["plain", "with\nnewline/f", "sp ace", "ü/ß"]
    stores = {}
    for pkg, ps, ftk in (("port", port_ps, port_file_tk),
                         ("jax", jax_ps, jax_file_tk)):
        files = ps.PathStore()
        for i, n in enumerate(names):
            files.elems.append(ps.PathStoreElem(n, total_len=1000 * i,
                                                range_len=1000 * i))
        dirs = ps.PathStore(elems=[ps.PathStoreElem("with\nnewline")])
        path = tmp_path / f"{pkg}.tree"
        ftk.write_treefile(str(path), dirs, files, use_base64=True)
        loaded = ps.PathStore()
        loaded.load_files_from_file(str(path))
        stores[pkg] = (path.read_bytes(), elems(loaded))
    assert stores["port"] == stores["jax"]
    assert stores["port"][0].startswith(b"# encoding=base64\n")
    assert [e[0] for e in stores["port"][1]] == names


# ----------------------------------------------------------------------
# --treescan
# ----------------------------------------------------------------------

def test_treescan_writes_the_jax_packages_tree_file(tmp_path, capsys):
    src = tmp_path / "src"
    for rel, size in (("a", 10), ("sub/b c", 0), ("sub/deep/c", 5000),
                      ("new\nline", 3), ("d\nir/e", 7)):
        path = src / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"x" * size)
    out = {}
    for pkg, main in (("port", lambda a: port_main(a, device="cpu")),
                      ("jax", jax_main)):
        target = tmp_path / f"{pkg}.tree"
        capsys.readouterr()
        assert main(["--treescan", str(src), "--treefile", str(target)]) == 0
        out[pkg] = (target.read_bytes(), capsys.readouterr().out
                    .replace(str(target), "<out>"))
    assert out["port"] == out["jax"]
    assert out["port"][0].startswith(b"# encoding=base64\n")
    assert "5 files, " in out["port"][1]


@pytest.mark.parametrize("case", ["no-treefile", "not-a-directory"])
def test_treescan_refusals_give_the_jax_texts(tmp_path, capsys, case):
    afile = tmp_path / "afile"
    afile.write_text("x")
    argv = ["--treescan", str(afile if case == "not-a-directory"
                              else tmp_path)]
    if case == "not-a-directory":
        argv += ["--treefile", str(tmp_path / "t")]
    errs = {}
    for pkg, main in (("port", lambda a: port_main(a, device="cpu")),
                      ("jax", jax_main)):
        capsys.readouterr()
        assert main(argv) == 1
        errs[pkg] = capsys.readouterr().err
    assert errs["port"] == errs["jax"]
    assert errs["port"].startswith("ERROR: --treescan ")


@pytest.mark.parametrize("url", ["s3://bucket/prefix", "gs://bucket"])
def test_treescan_of_a_bucket_fails_with_one_error_line(tmp_path, capsys,
                                                        url):
    assert port_main(["--treescan", url, "--treefile",
                      str(tmp_path / "t")], device="cpu") == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and err.startswith("ERROR: ") \
        and "object back ends" in err and url in err
    assert not (tmp_path / "t").exists()


# ----------------------------------------------------------------------
# tree runs through both CLIs
# ----------------------------------------------------------------------

#: small, zero-length and shared files (at --sharesize 32K: big, and
#: big2 with a short last block); -b 4K --iodepth 2 takes the ring for
#: ranges of at least four blocks
TREE = ("d a\nf 0 a/empty\nf 5000 a/small\nf 0 zero\nf 12288 b/c/mid\n"
        "f 65536 big\nf 40000 big2\nf 100 b/tiny\n")
COMMON = ["-t", "2", "-b", "4K", "--iodepth", "2", "--sharesize", "32K"]
TREE_CASES = {
    "contiguous": [],
    "treerand": ["--treerand"],
    "treeroundup": ["--treeroundup", "8K"],
    "sharesize": ["--sharesize", "48K"],
}
#: the loops: name -> flags (the port's; the JAX package's are mapped)
TREE_LOOPS = {
    "native": [],
    "ring": ["--gpuids", "0", "--gpuverify"],
    "python": ["--gpuids", "0", "--gpuverify", "--gpustream", "off"],
}
KEYS = (*LAST_COUNT_KEYS, "TpuStreamFusedOps")


def run(pkg, args, bench, json_path):
    """One CLI run; returns (rc, records)."""
    if json_path.exists():
        json_path.unlink()
    argv = args + ["--nolive", "--jsonfile", str(json_path), str(bench)]
    rc = jax_main(jax_args(argv)) if pkg == "jax" \
        else port_main(argv, device="cpu")
    recs = []
    if json_path.exists():
        recs = [json.loads(x) for x in json_path.read_text().splitlines()]
    return rc, recs


def counts(recs):
    return [({k: r[k] for k in KEYS}, r["IOLatHisto"]["LatNumValues"],
             r["EntLatHisto"]["LatNumValues"]) for r in recs]


@pytest.fixture
def tree_file(tmp_path, monkeypatch):
    jax_engine(monkeypatch)
    path = tmp_path / "tree.txt"
    path.write_text(TREE)
    return path


def files_only(root):
    return {k: v for k, v in tree(root).items() if v is not None}


@pytest.mark.parametrize("loop", list(TREE_LOOPS))
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_runs_equal_the_jax_package(tmp_path, tree_file, case, loop):
    flags = [*COMMON, "--treefile", str(tree_file), *TREE_CASES[case],
             *TREE_LOOPS[loop]]
    got = {}
    for pkg in ("port", "jax"):
        bench = tmp_path / pkg
        bench.mkdir()
        rc, recs = run(pkg, ["-w", "--stat", "-r", "--verify", "5", *flags],
                       bench, tmp_path / f"{pkg}.json")
        assert rc == 0, pkg
        written = tree(bench)
        rc, rm_recs = run(pkg, ["-F", *flags], bench,
                          tmp_path / f"{pkg}.json")
        assert rc == 0, pkg
        got[pkg] = (counts(recs), written, counts(rm_recs),
                    files_only(bench))
    assert got["port"] == got["jax"]
    written = got["port"][1]
    size = 8192 if case == "treeroundup" else 4096
    assert len(written["big2"]) == (40960 if case == "treeroundup"
                                    else 40000)
    assert len(written["a/small"]) == size + (0 if size == 8192 else 904)
    assert got["port"][3] == {}  # -F leaves only directories
    write, _, read = got["port"][0]
    assert write[0]["BytesLast"] == read[0]["BytesLast"] == sum(
        len(v) for v in written.values() if v is not None)
    if loop == "ring":
        assert read[0]["TpuStreamFusedOps"] > 0


def test_a_corrupted_block_after_zero_length_files_gives_the_jax_offset(
        tmp_path, capsys, monkeypatch):
    """The engine's verify error of a tree names the file and offset,
    with zero-length files counting no block."""
    jax_engine(monkeypatch)
    tree_path = tmp_path / "tree.txt"
    tree_path.write_text("f 0 empty1\nf 0 empty2\nf 65536 big\n")
    flags = ["-t", "1", "-b", "16K", "--treefile", str(tree_path),
             "--verify", "5"]
    errs = {}
    for pkg in ("port", "jax"):
        bench = tmp_path / pkg
        bench.mkdir()
        assert run(pkg, ["-w", *flags], bench, tmp_path / "r.json")[0] == 0
        data = bytearray((bench / "big").read_bytes())
        data[40000] ^= 0xFF
        (bench / "big").write_bytes(bytes(data))
        capsys.readouterr()
        assert run(pkg, ["-r", *flags], bench, tmp_path / "r.json")[0] != 0
        errs[pkg] = [re.sub(r"^\S+ \S+ ", "", x).replace(str(bench), "B")
                     for x in capsys.readouterr().err.splitlines()
                     if "integrity" in x]
    assert errs["port"] == errs["jax"]
    assert "data integrity check failed at file offset 40000 of B/big: " \
        "expected" in errs["port"][0]


# ----------------------------------------------------------------------
# the departure: --treeroundrob writes each shared file whole
# ----------------------------------------------------------------------

@pytest.mark.parametrize("loop", list(TREE_LOOPS))
@pytest.mark.parametrize("big", [16384, 14000])
def test_treeroundrob_writes_shared_files_whole(tmp_path, monkeypatch, big,
                                               loop):
    """The tree "f 16384 big / f 4096 small" at -t 2 -b 4K --sharesize
    8K: the JAX package's round-robin write leaves big 12,288 bytes long
    (each worker writes [first block, first block + 2 blocks) as one
    range); the port's equals the contiguous split's byte for byte,
    verifies, and books the bytes it moved. 14000 ends in a short
    block."""
    jax_engine(monkeypatch)
    tree_path = tmp_path / "tree.txt"
    tree_path.write_text(f"f {big} big\nf 4096 small\n")
    flags = ["-t", "2", "-b", "4K", "--sharesize", "8K", "--treefile",
             str(tree_path), "--verify", "3", *TREE_LOOPS[loop]]
    files, recs = {}, {}
    for pkg, rr in (("jax", True), ("port", True), ("port", False)):
        bench = tmp_path / f"{pkg}{int(rr)}"
        bench.mkdir()
        rc, recs[pkg, rr] = run(pkg, ["-w", "-r", *flags]
                                + (["--treeroundrob"] if rr else []),
                                bench, tmp_path / "r.json")
        assert rc == 0, (pkg, rr)
        files[pkg, rr] = (bench / "big").read_bytes()
    assert len(files["jax", True]) == 12288
    assert files["port", True] == files["port", False]
    assert len(files["port", True]) == big
    for rec in recs["port", True]:
        assert rec["BytesLast"] == big + 4096
        assert rec["IOLatHisto"]["LatNumValues"] == 5
    assert [r["BytesLast"] for r in recs["jax", True]] == [20480, 20480]
