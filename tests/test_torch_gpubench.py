"""--gpubench of the port's CLI (device="cpu") against the JAX package's
--tpubench on the same arguments.

Both packages run the transfer benchmark with no bench path; the
TPUBENCH records must agree at tolerance 0 on every count: bytes, ops,
device bytes, the H2D/D2H path-audit counters and the number of latencies
in the histogram (the buckets themselves are timings). Also the defaults
of --gpubench and the text of every check it brings.
"""

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.config.args import parse_cli as jax_parse_cli
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.config.args import ConfigError, parse_cli
from test_torch_dirmode import jax_args, records
from test_torch_e2e import COUNT_KEYS, _jax_python_loop  # noqa: F401

torch.set_num_threads(1)

#: counts of the record that must agree; the stonewall "First" counts
#: only with one worker (they are a snapshot of the others' progress).
#: TpuPipeFullStalls is not among them: it counts copies that had not
#: finished when the ring was full, a timing on the JAX side
BENCH_KEYS = COUNT_KEYS + ("TpuStreamFusedOps",)


def run_both(args, tmp_path):
    """Run `args` (port flags) through both CLIs; returns the two
    TPUBENCH records (JAX, port)."""
    jax_json, port_json = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_main(jax_args(args) + ["--nolive", "--jsonfile",
                                      str(jax_json)]) == 0
    assert port_main(args + ["--nolive", "--jsonfile", str(port_json)],
                     device="cpu") == 0
    (jax_rec,), (port_rec,) = records(jax_json), records(port_json)
    return jax_rec, port_rec


def assert_same_counts(jax_rec, port_rec, threads):
    keys = [k for k in BENCH_KEYS
            if threads == 1 or not k.endswith("First")]
    assert {k: port_rec[k] for k in keys} == {k: jax_rec[k] for k in keys}
    assert port_rec["IOLatHisto"]["LatNumValues"] \
        == jax_rec["IOLatHisto"]["LatNumValues"]
    assert port_rec["Device"] == "cpu"
    # every key the port writes is a key of the JAX package's record,
    # except the device name
    assert set(port_rec) - set(jax_rec) == {"Device"}


CASES = {
    # name: (flags, ops per worker, bytes per op moved)
    "h2d": (["--gpubenchpat", "h2d"], 4, 1),
    "d2h": (["--gpubenchpat", "d2h"], 4, 1),
    "both": (["--gpubenchpat", "both"], 4, 2),
    "h2d-direct": (["--gpubenchpat", "h2d", "--gpudirect"], 4, 1),
    "d2h-direct": (["--gpubenchpat", "d2h", "--gpudirect"], 4, 1),
    "both-direct": (["--gpubenchpat", "both", "--gpudirect"], 4, 2),
    "h2d-two-threads": (["--gpubenchpat", "h2d", "-t", "2"], 4, 1),
    "both-two-threads-direct": (["--gpubenchpat", "both", "-t", "2",
                                 "--gpudirect"], 4, 2),
    "h2d-gpubatch": (["--gpubenchpat", "h2d", "--gpubatch", "4"], 4, 1),
    "both-gpubatch-direct": (["--gpubenchpat", "both", "--gpubatch", "4",
                              "--gpudirect"], 4, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_record_equals_the_jax_package(tmp_path, case):
    flags, ops, factor = CASES[case]
    threads = int(flags[flags.index("-t") + 1]) if "-t" in flags else 1
    jax_rec, port_rec = run_both(
        ["--gpubench", "-s", "64K", "-b", "16K", "--iodepth", "2", *flags],
        tmp_path)
    assert_same_counts(jax_rec, port_rec, threads)
    assert port_rec["Phase"] == "TPUBENCH"
    assert port_rec["IOLatHisto"]["LatNumValues"] == threads * ops
    assert port_rec["BytesLast"] == port_rec["TpuHbmBytes"] \
        == threads * factor * (64 << 10)


@pytest.mark.parametrize("pattern", ["h2d", "d2h", "both"])
@pytest.mark.parametrize("size,block,ops", [
    ("40K", "16K", 3),   # -s not a multiple of -b: a short last op
    ("22", "6", 4),      # a sub-word block, and a 4-byte last op
])
def test_ragged_sizes_equal_the_jax_package(tmp_path, pattern, size, block,
                                            ops):
    jax_rec, port_rec = run_both(
        ["--gpubench", "--gpubenchpat", pattern, "-s", size, "-b", block],
        tmp_path)
    assert_same_counts(jax_rec, port_rec, 1)
    assert port_rec["IOLatHisto"]["LatNumValues"] == ops


def test_defaults_equal_the_jax_package():
    """--gpubench alone: GPU 0, -s 256M, the h2d pattern, and TPUBENCH as
    the only phase; after any storage phase it runs last."""
    cfg, _ = parse_cli(["--gpubench"])
    cfg.derive()
    cfg.check()
    jax_cfg, _ = jax_parse_cli(["--tpubench"])
    jax_cfg.derive(probe_paths=False)
    assert (cfg.gpu_ids, cfg.file_size, cfg.block_size,
            cfg.gpu_bench_pattern) == \
        (jax_cfg.tpu_ids, jax_cfg.file_size, jax_cfg.block_size,
         jax_cfg.tpu_bench_pattern) == ([0], 256 << 20, 1 << 20, "h2d")
    assert [p.name for p in cfg.enabled_phases()] == ["TPUBENCH"]
    cfg, _ = parse_cli(["--gpubench", "-w", "-r", "-s", "1K", "-b", "4K",
                        "--gpuids", "1", "/nonexistent/file"])
    cfg.derive()
    assert [p.name for p in cfg.enabled_phases()] == \
        ["CREATEFILES", "READFILES", "TPUBENCH"]
    # a given -s and --gpuids are kept; -b shrinks to -s, as in the JAX
    # package
    assert (cfg.gpu_ids, cfg.file_size, cfg.block_size) == ([1], 1024, 1024)


def port_check_error(args):
    cfg, _ = parse_cli(args)
    with pytest.raises(ConfigError) as err:
        cfg.derive()
        cfg.check()
    return str(err.value)


def jax_check_error(args, capsys):
    """The JAX package's message for `args` (port flags): its CLI prints
    config errors, and logs the unknown pattern's worker error."""
    assert jax_main(jax_args(args) + ["--nolive"]) == 1
    out = capsys.readouterr()
    line = [ln for ln in (out.err + out.out).splitlines()
            if "ERROR" in ln][-1]
    return line.split("ERROR: ")[-1].removeprefix(
        "Aborting due to worker error: ")


def as_port_text(jax_text):
    """The JAX package's words with the port's flag and device names."""
    return jax_text.replace("--tpu", "--gpu").replace("TPU", "GPU")


@pytest.mark.parametrize("args", [
    ["--gpubench", "--gpubenchpat", "bogus"],
    ["--gpubench", "--gpustream", "on"],
    ["--gpudepth", "2", "-s", "4K", "/nonexistent/file"],
    ["--gpubudget", "5", "-s", "4K", "/nonexistent/file"],
], ids=["unknown-pattern", "gpustream-on", "gpudepth", "gpubudget"])
def test_check_texts_equal_the_jax_package(args, capsys):
    assert port_check_error(args) == as_port_text(
        jax_check_error(args, capsys))


@pytest.mark.parametrize("args", [
    ["--gpudepth", "2", "--gpubench"],
    ["--gpubudget", "5", "--gpubench"],
])
def test_pipeline_flags_pass_under_gpubench(args):
    cfg, _ = parse_cli(args)
    cfg.derive()
    cfg.check()


def test_storage_phases_need_a_bench_path():
    assert "need bench paths" in port_check_error(["--gpubench", "-w"])
    assert port_main(["-r"], device="cpu") == 1  # no path: help, rc 1
