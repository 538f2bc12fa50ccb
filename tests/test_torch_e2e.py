"""End to end: the port's CLI (device="cpu") against the JAX package's CLI
on the same workload. Files written with --verify must be byte-identical,
each package must read the other's file cleanly under verify, and the
phase records must agree on bytes, ops and the device counters."""

import json

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu_torch.cli import main as port_main

torch.set_num_threads(1)

WORKLOAD = ["-t", "2", "-s", "8M", "-b", "1M", "--iodepth", "2",
            "--verify", "7", "--nolive"]
#: record keys that count work (not time): they must agree exactly
COUNT_KEYS = ("Phase", "NumWorkers", "BytesFirst", "BytesLast",
              "EntriesFirst", "EntriesLast", "TpuHbmBytes",
              "TpuH2dDirectOps", "TpuH2dStagedOps", "TpuH2dDirectFallbacks",
              "TpuD2hDirectOps", "TpuD2hStagedOps", "TpuD2hDirectFallbacks",
              "TpuD2hPrefetchHits", "TpuD2hPrefetchMisses",
              "TpuPipeInflightHwm")


@pytest.fixture(autouse=True)
def _jax_python_loop(monkeypatch):
    # the JAX package's native engine is not what is compared here, and
    # building it would dominate the test time
    monkeypatch.setenv("ELBENCHO_TPU_NO_NATIVE", "1")
    from elbencho_tpu.utils.native import reset_native_engine_cache
    reset_native_engine_cache()


def run_jax(args, path, json_path=None):
    extra = ["--jsonfile", str(json_path)] if json_path else []
    return jax_main(args + ["--tpuids", "0", "--tpustream", "off"] + extra
                    + [str(path)])


def run_port(args, path, json_path=None):
    extra = ["--jsonfile", str(json_path)] if json_path else []
    return port_main(args + ["--gpuids", "0"] + extra + [str(path)],
                     device="cpu")


def records(json_path):
    with open(json_path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stream", ["auto", "off"])
@pytest.mark.parametrize("direct", [False, True])
def test_write_read_parity_with_the_jax_package(tmp_path, direct, stream):
    flags = ["-w", "-r", *WORKLOAD, "--gpustream", stream] \
        + (["--gpudirect"] if direct else [])
    jax_flags = ["-w", "-r", *WORKLOAD] + (["--tpudirect"] if direct else [])
    assert run_jax(jax_flags + ["--tpuverify"], tmp_path / "jax.bin",
                   tmp_path / "jax.json") == 0
    assert run_port(flags + ["--gpuverify"], tmp_path / "port.bin",
                    tmp_path / "port.json") == 0
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    jax_recs = records(tmp_path / "jax.json")
    port_recs = records(tmp_path / "port.json")
    assert [r["Phase"] for r in port_recs] == ["WRITE", "READ"]
    # the workload runs two workers (-t 2): the stonewall "First" counts
    # are a snapshot of one worker's progress when the other finished,
    # which depends on timing
    keys = [k for k in COUNT_KEYS if not k.endswith("First")]
    for jr, pr in zip(jax_recs, port_recs, strict=True):
        assert {k: pr[k] for k in keys} == {k: jr[k] for k in keys}
        assert pr["IOLatHisto"]["LatNumValues"] == \
            jr["IOLatHisto"]["LatNumValues"] == 8
        assert pr["Device"] == "cpu"
    # every key the port writes is a key of the JAX package's record,
    # except the device name
    assert set(port_recs[0]) - set(jax_recs[0]) == {"Device"}


def test_each_package_reads_the_others_file_under_verify(tmp_path):
    jax_file, port_file = tmp_path / "jax.bin", tmp_path / "port.bin"
    assert run_jax(["-w", *WORKLOAD], jax_file) == 0
    assert run_port(["-w", *WORKLOAD], port_file) == 0
    # host-side verify on both sides, and on-device verify on both sides
    assert run_port(["-r", *WORKLOAD], jax_file) == 0
    assert run_port(["-r", *WORKLOAD, "--gpuverify"], jax_file) == 0
    assert run_jax(["-r", *WORKLOAD], port_file) == 0
    assert run_jax(["-r", *WORKLOAD, "--tpuverify"], port_file) == 0


@pytest.mark.parametrize("device_verify", [True, False])
def test_one_flipped_byte_fails_the_read(tmp_path, capsys, device_verify):
    path = tmp_path / "f.bin"
    assert run_port(["-w", *WORKLOAD], path) == 0
    data = bytearray(path.read_bytes())
    data[5 * (1 << 20) + 12345] ^= 0x01
    path.write_bytes(bytes(data))
    flags = ["-r", *WORKLOAD] + (["--gpuverify"] if device_verify else [])
    assert run_port(flags, path) == 1
    assert "integrity" in capsys.readouterr().err


def test_random_offsets_write_then_verify(tmp_path):
    path = tmp_path / "f.bin"
    json_path = tmp_path / "r.json"
    # one thread: its full-coverage random write hits every block once
    # (two threads would each cover half the blocks of the whole range)
    flags = ["-t", "1", "-s", "8M", "-b", "1M", "--verify", "7", "--nolive"]
    assert run_port(["-w", "-r", "--rand", *flags, "--gpuverify"], path,
                    json_path) == 0
    write, read = records(json_path)
    assert write["BytesLast"] == read["BytesLast"] == 8 << 20
    assert run_jax(["-r", *flags], path) == 0


def test_plain_write_through_the_device_fill_pool_and_delete(tmp_path):
    path = tmp_path / "f.bin"
    json_path = tmp_path / "p.json"
    assert run_port(["-w", "-r", "-F", "-t", "2", "-s", "2M", "-b", "256K",
                     "--nolive"], path, json_path) == 0
    write, read, delete = records(json_path)
    assert write["TpuD2hStagedOps"] == 8 and read["TpuH2dStagedOps"] == 8
    assert delete["Phase"] == "RMFILES" and delete["EntriesLast"] == 1
    assert not path.exists()


def test_host_only_run_without_gpuids(tmp_path):
    path = tmp_path / "f.bin"
    json_path = tmp_path / "h.json"
    assert port_main(["-w", "-r", *WORKLOAD, "--jsonfile", str(json_path),
                      str(path)]) == 0
    assert [r["TpuHbmBytes"] for r in records(json_path)] == [0, 0]
    assert run_jax(["-r", *WORKLOAD], path) == 0


@pytest.mark.parametrize("argv,message", [
    (["-r", "-t", "0", "-s", "1M"], "--threads must be >= 1"),
    (["-r", "-s", "1M", "--gpudepth", "-1", "--gpuids", "0"],
     "--gpudepth must be >= 0"),
    (["-r", "-s", "1M", "--gpubudget", "5"],
     "--gpudepth/--gpubudget tune the GPU transfer pipeline"),
    (["-r"], "file size must not be 0"),
    (["-r", "-s", "1M", "--gpustream", "on"],
     "--gpustream on requires --gpuids"),
    (["-r", "-s", "1M", "--gpustream", "yes", "--gpuids", "0"],
     "--gpustream must be auto|on|off"),
    (["-r", "-s", "1M", "--ioengine", "spdk"],
     "--ioengine must be auto|sync|aio|uring"),
    (["-r", "-s", "1M", "--ioengine", "sync", "--iodepth", "2"],
     "--ioengine sync requires --iodepth 1"),
])
def test_config_errors(tmp_path, capsys, argv, message):
    assert port_main(argv + [str(tmp_path / "missing.bin")],
                     device="cpu") == 1
    assert message in capsys.readouterr().err


def test_directory_write_without_mkdirs_is_refused(tmp_path, capsys):
    """A directory is a dir-mode bench path: a write into it without
    --mkdirs is refused with the JAX package's hint."""
    assert port_main(["-w", "-s", "1M", str(tmp_path)], device="cpu") == 1
    assert "Did you forget to enable directory creation ('--mkdirs'/-d)?" \
        in capsys.readouterr().err
