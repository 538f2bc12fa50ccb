"""--gpuprofile of the port's CLI (device="cpu") against the JAX package's
--tpuprofile on the same arguments: the same trace subdirectories, by name
and count (``NNN_<phase>``, one per device-touching phase run, numbered
across the run). Trace contents are not compared: the two profilers
record different things."""

import os

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu_torch.cli import main as port_main
from test_torch_dirmode import jax_args
from test_torch_e2e import _jax_python_loop  # noqa: F401

torch.set_num_threads(1)

FILE = ["-s", "32K", "-b", "16K"]
DIR = ["-n", "1", "-N", "2", "-s", "16K", "-b", "16K"]

CASES = {
    # name: (port flags, bench path kind, expected subdirectories)
    "file-write-read": (["-w", "-r", "-F", "--gpuids", "0", *FILE], "file",
                        ["001_createfiles", "002_readfiles"]),
    "dir-mode": (["-d", "-w", "--stat", "-r", "-F", "-D", "--gpuids", "0",
                  *DIR], "dir", ["001_createfiles", "002_readfiles"]),
    "gpubench": (["--gpubench", *FILE], None, ["001_tpubench"]),
    "gpubench-after-storage": (["-w", "-r", "--gpubench", *FILE], "file",
                               ["001_createfiles", "002_readfiles",
                                "003_tpubench"]),
    "no-device-ids": (["-w", "-r", "-F", *FILE], "file", []),
}


def bench_paths(tmp_path, kind, side):
    if kind is None:
        return []
    path = tmp_path / f"{side}-bench"
    if kind == "dir":
        path.mkdir()
    return [str(path)]


def subdirs(prof_dir):
    return sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_dirs_equal_the_jax_package(tmp_path, case):
    flags, kind, want = CASES[case]
    jax_prof, port_prof = tmp_path / "jax-prof", tmp_path / "port-prof"
    assert jax_main(jax_args(flags) + [
        "--tpustream", "off", "--nolive", "--tpuprofile", str(jax_prof),
        *bench_paths(tmp_path, kind, "jax")]) == 0
    assert port_main(flags + ["--nolive", "--gpuprofile", str(port_prof),
                              *bench_paths(tmp_path, kind, "port")],
                     device="cpu") == 0
    assert subdirs(port_prof) == subdirs(jax_prof) == want
    for name in want:  # each traced phase wrote its trace
        assert os.path.getsize(port_prof / name / "trace.json") > 0


def test_no_flag_writes_no_trace(tmp_path):
    assert port_main(["-w", "-r", "--gpuids", "0", "--nolive", *FILE,
                      str(tmp_path / "f")], device="cpu") == 0
    assert sorted(os.listdir(tmp_path)) == ["f"]


WARMUP_CASES = {
    # name: (port flags, bench path kind, warm-up copies: one per worker
    # thread at prepare and per traced phase, none without --gpuprofile)
    "file-write-read": (["-w", "-r", "-F", "-t", "2", "--gpuids", "0",
                         *FILE, "--gpuprofile"], "file", 2 * (1 + 2)),
    "dir-mode": (["-d", "-w", "--stat", "-r", "-F", "-D", "--gpuids", "0",
                  *DIR, "--gpuprofile"], "dir", 1 + 2),
    "gpubench": (["--gpubench", "-t", "2", *FILE, "--gpuprofile"], None,
                 2 * (1 + 1)),
    "no-flag": (["-w", "-r", "-F", "-t", "2", "--gpuids", "0", *FILE], "file",
                0),
}


@pytest.mark.parametrize("case", sorted(WARMUP_CASES))
def test_each_thread_warms_up_each_traced_phase(tmp_path, monkeypatch, case):
    """Each worker thread makes CudaWorkerContext.profile_warmup's copy at
    prepare (allocating its buffers) and at the start of each phase that
    --gpuprofile traces, and at no other."""
    from elbencho_tpu_torch.cuda.device import CudaWorkerContext
    calls = []
    monkeypatch.setattr(CudaWorkerContext, "profile_warmup",
                        lambda self: calls.append(self))
    flags, kind, want = WARMUP_CASES[case]
    if "--gpuprofile" in flags:
        flags = flags + [str(tmp_path / "prof")]
    assert port_main(flags + ["--nolive", *bench_paths(tmp_path, kind,
                                                       "port")],
                     device="cpu") == 0
    assert len(calls) == want
