"""The port's fused --gpustream ring (device="cpu") against the JAX
package's --tpustream ring and its Python loop.

Mirrors tests/test_tpu_stream_fused.py: each workload runs through the
port with --gpustream on, and through the JAX package with its own
engine, --tpustream on and off. Bytes, op counts, device bytes, the H2D
and D2H op counters, TpuStreamFusedOps and the files' bytes must agree at
tolerance 0. Also: a file cut short fails loudly in both packages, the
blocker of tiny dir-mode files is the JAX package's, an interrupt
mid-stream books the completed prefix, and under --gpudirect no slot
goes back to the engine while the copy that reads it is in flight.
"""

import ctypes
import json

import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.workers.local_worker import LocalWorker as JaxWorker
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.cuda.device import (CudaWorkerContext,
                                            TransferPipeline)
from elbencho_tpu_torch.utils.native import NativeStream
from elbencho_tpu_torch.workers.local_worker import LocalWorker
from test_torch_native import jax_engine

torch.set_num_threads(1)

#: per-phase counts that do not depend on timing
KEYS = ("Phase", "BytesLast", "EntriesLast", "TpuHbmBytes",
        "TpuH2dDirectOps", "TpuH2dStagedOps", "TpuD2hDirectOps",
        "TpuD2hStagedOps", "TpuStreamFusedOps")

BASE = ["-t", "1", "-s", "1M", "-b", "64K", "--iodepth", "4", "--nolive"]


def jax_flags(args):
    return [a.replace("--gpu", "--tpu") if a.startswith("--gpu") else a
            for a in args]


def run_port(args, paths, json_path):
    return port_main(args + ["--gpuids", "0", "--jsonfile", str(json_path)]
                     + [str(p) for p in paths], device="cpu")


def run_jax(args, paths, json_path, stream):
    return jax_main(jax_flags(args) + ["--tpuids", "0", "--tpustream",
                                       stream, "--jsonfile", str(json_path)]
                    + [str(p) for p in paths])


def records(json_path):
    with open(json_path) as f:
        return [json.loads(line) for line in f]


def summary(recs):
    return [dict({k: r[k] for k in KEYS},
                 ops=r["IOLatHisto"]["LatNumValues"]) for r in recs]


#: case -> (flags of the measured run, number of files)
CASES = {
    "staged": ([], 1),
    "direct": (["--gpudirect"], 1),
    "verify": (["--verify", "5"], 1),
    "gpuverify": (["--verify", "5", "--gpuverify"], 1),
    "direct-gpuverify": (["--verify", "5", "--gpuverify", "--gpudirect"],
                         1),
    "rand": (["--rand", "--verify", "5", "--gpuverify"], 1),
    "striped": (["--verify", "5", "--gpuverify"], 4),
    "gpubatch": (["--gpubatch", "3", "--verify", "5"], 1),
    "gpubatch-direct": (["--gpubatch", "3", "--gpudirect"], 1),
}


@pytest.mark.parametrize("op", ["read", "write"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_ring_equals_the_jax_package(tmp_path, monkeypatch, case, op):
    jax_engine(monkeypatch)
    flags, n_files = CASES[case]
    results = {}
    for name, run in (
            ("port", lambda a, p, j: run_port(a, p, j)),
            ("jax-on", lambda a, p, j: run_jax(a, p, j, "on")),
            ("jax-off", lambda a, p, j: run_jax(a, p, j, "off"))):
        paths = [tmp_path / f"{name}{i}" for i in range(n_files)]
        if op == "read":  # the data a read verifies: the pattern of salt 5
            assert port_main(["-w", *BASE, "--verify", "5"]
                             + [str(p) for p in paths], device="cpu") == 0
        json_path = tmp_path / f"{name}.json"
        rc = run(["-r" if op == "read" else "-w", *BASE, *flags]
                 + (["--gpustream", "on"] if name == "port" else []),
                 paths, json_path)
        assert rc == 0, name
        results[name] = (summary(records(json_path)),
                         b"".join(p.read_bytes() for p in paths))
    port, jax_on, jax_off = (results[k] for k in ("port", "jax-on",
                                                   "jax-off"))
    assert port[0] == jax_on[0]
    assert port[0][0]["TpuStreamFusedOps"] == 16 * n_files \
        and jax_off[0][0]["TpuStreamFusedOps"] == 0
    for rec in port[0] + jax_off[0]:
        rec.pop("TpuStreamFusedOps")
    assert port[0] == jax_off[0]
    if op == "write" and "--verify" in flags:
        # the written bytes are the verify pattern in all three runs
        assert port[1] == jax_on[1] == jax_off[1]
    assert len(port[1]) == n_files << 20


@pytest.mark.parametrize("package", ["port", "jax"])
def test_read_of_a_file_cut_short_fails_loudly(tmp_path, monkeypatch,
                                               capsys, package):
    """The file is cut to half its size after the configuration was
    checked: the ring reaps short reads, and the phase fails with the
    offset, as the Python loop does."""
    jax_engine(monkeypatch)
    path = tmp_path / "f"
    assert port_main(["-w", *BASE, str(path)], device="cpu") == 0
    cls = LocalWorker if package == "port" else JaxWorker
    orig = cls.prepare

    def prepare_then_truncate(self):
        orig(self)
        with open(path, "r+b") as f:
            f.truncate(1 << 19)

    monkeypatch.setattr(cls, "prepare", prepare_then_truncate)
    json_path = tmp_path / "r.json"
    capsys.readouterr()
    if package == "port":
        rc = run_port(["-r", *BASE, "--gpustream", "on"], [path], json_path)
    else:
        rc = run_jax(["-r", *BASE], [path], json_path, "on")
    assert rc != 0
    assert "short read at offset " in capsys.readouterr().err


DIR_FLAGS = ["-w", "-d", "-r", "-t", "1", "-n", "1", "-N", "2", "-s", "32K",
             "-b", "16K", "--iodepth", "4", "--nolive"]


def test_stream_on_refuses_tiny_dir_mode_files_with_the_jax_reason(
        tmp_path, monkeypatch, capsys):
    jax_engine(monkeypatch)
    reasons = []
    for name, run in (("port", run_port),
                      ("jax", lambda a, p, j: run_jax(a, p, j, "on"))):
        root = tmp_path / name
        root.mkdir()
        args = DIR_FLAGS + (["--gpustream", "on"] if name == "port" else [])
        capsys.readouterr()
        assert run(args, [root], tmp_path / f"{name}.json") != 0
        err = capsys.readouterr().err
        marker = "stream on: fused native-stream loop unavailable ("
        assert marker in err, err[-400:]
        reasons.append(err.split(marker)[1].split(")")[0])
    assert reasons[0] == reasons[1] == \
        "per-file stream too short to amortize ring setup"


def test_stream_auto_takes_the_python_loop_for_tiny_dir_mode_files(
        tmp_path, capsys):
    json_path = tmp_path / "r.json"
    assert run_port(DIR_FLAGS, [tmp_path], json_path) == 0
    rec = next(r for r in records(json_path) if r["Phase"] == "READ")
    assert rec["TpuStreamFusedOps"] == 0
    assert rec["TpuHbmBytes"] == rec["BytesLast"] == 2 * 32 * 1024
    assert "NOTE: fused GPU stream ineligible (per-file stream too short " \
        "to amortize ring setup); using the Python loop" \
        in capsys.readouterr().out


def test_interrupt_mid_stream_drains_and_books_the_completed_prefix(
        tmp_path, monkeypatch):
    """The worker is interrupted from inside its 5th device copy: the
    ring stops at the next check, drains, and the phase books exactly
    the ops it reaped (an interrupted chunk books no latencies)."""
    path = tmp_path / "f"
    flags = ["-t", "1", "-s", "16M", "-b", "16K", "--iodepth", "4",
             "--nolive"]
    assert port_main(["-w", *flags, str(path)], device="cpu") == 0
    orig = LocalWorker._post_read_actions
    calls = []

    def interrupting(self, *args):
        calls.append(1)
        if len(calls) == 5:
            self.interrupt_execution()
        return orig(self, *args)

    monkeypatch.setattr(LocalWorker, "_post_read_actions", interrupting)
    closes = []
    orig_close = NativeStream.close

    def counted_close(self):
        ret = orig_close(self)
        closes.append(ret)
        return ret

    monkeypatch.setattr(NativeStream, "close", counted_close)
    json_path = tmp_path / "r.json"
    assert run_port(["-r", *flags, "--gpustream", "on"], [path],
                    json_path) == 0
    (rec,) = records(json_path)
    fused = rec["TpuStreamFusedOps"]
    assert 5 <= fused < 1024
    assert rec["BytesLast"] == rec["TpuHbmBytes"] == fused * 16 * 1024
    assert closes[0] == 0  # the ring drained cleanly
    monkeypatch.setattr(LocalWorker, "_post_read_actions", orig)
    json_path = tmp_path / "again.json"
    assert run_port(["-r", *flags], [path], json_path) == 0
    (rec,) = records(json_path)
    assert rec["TpuStreamFusedOps"] == 1024


@pytest.mark.parametrize("holdback", ["kept", "dropped"])
def test_direct_slots_are_not_reused_while_their_copy_is_in_flight(
        tmp_path, monkeypatch, holdback):
    """Instruments a --gpudirect read: each H2D copy logs the slot it
    reads, each drain of the transfer ring retires the oldest copy, and
    every read the ring submits must go to a slot no undrained copy
    reads. With the holdback dropped the instrument must see the reuse
    (on the CPU the copy itself is done at once, so only the instrument
    can show it)."""
    copies, drained, violations, depths = [], [0], [], []
    orig_h2d = CudaWorkerContext.host_to_device
    orig_drain = TransferPipeline._drain_one
    orig_submit = NativeStream.submit
    orig_hold = CudaWorkerContext.holdback_depth

    def h2d(self, buf, *args, **kwargs):
        copies.append(ctypes.addressof(ctypes.c_char.from_buffer(buf)))
        return orig_h2d(self, buf, *args, **kwargs)

    def drain_one(self, *args, **kwargs):
        drained[0] += 1
        return orig_drain(self, *args, **kwargs)

    def hold(self):
        depths.append((orig_hold(self), self.pipeline_depth))
        return depths[-1][0] if holdback == "kept" else 0

    def submit(self, slot, fd_idx, offset, length, is_write):
        addr = self_addrs[0][slot]
        if addr in copies[drained[0]:]:
            violations.append((slot, offset))
        return orig_submit(self, slot, fd_idx, offset, length, is_write)

    self_addrs = []
    orig_open = LocalWorker._run_fused_gpu_stream_loop

    def open_loop(self, *args):
        self_addrs.append(self._staging_pool.slot_addrs)
        return orig_open(self, *args)

    monkeypatch.setattr(CudaWorkerContext, "host_to_device", h2d)
    monkeypatch.setattr(TransferPipeline, "_drain_one", drain_one)
    monkeypatch.setattr(CudaWorkerContext, "holdback_depth", hold)
    monkeypatch.setattr(NativeStream, "submit", submit)
    monkeypatch.setattr(LocalWorker, "_run_fused_gpu_stream_loop", open_loop)
    path = tmp_path / "f"
    flags = ["-t", "1", "-s", "2M", "-b", "64K", "--iodepth", "4",
             "--verify", "5", "--nolive"]
    assert port_main(["-w", *flags, str(path)], device="cpu") == 0
    copies.clear()
    drained[0] = 0
    json_path = tmp_path / "r.json"
    assert run_port(["-r", *flags, "--gpudirect", "--gpustream", "on"],
                    [path], json_path) == 0
    (rec,) = records(json_path)
    assert rec["TpuStreamFusedOps"] == rec["TpuH2dDirectOps"] == 32
    assert depths[-1] == (3, 4)  # pipeline_depth - 1
    assert len(copies) == 32
    if holdback == "kept":
        assert violations == []
    else:
        assert violations


@pytest.mark.parametrize("engine", ["uring", "aio"])
def test_pinned_ioengine_against_the_stream_backend(tmp_path, monkeypatch,
                                                    capsys, engine):
    """A pin that matches the stream's backend keeps the fused ring; one
    that does not leaves a device phase no loop to run, in both
    packages."""
    backend = jax_engine(monkeypatch).stream_backend_name()
    path = tmp_path / "f"
    assert port_main(["-w", *BASE, str(path)], device="cpu") == 0
    flags = ["-r", *BASE, "--ioengine", engine]
    rcs, fused = [], []
    for name, run in (("port", run_port),
                      ("jax", lambda a, p, j: run_jax(a, p, j, "auto"))):
        json_path = tmp_path / f"{name}.json"
        capsys.readouterr()
        rcs.append(run(flags, [path], json_path))
        if json_path.exists():
            fused += [r["TpuStreamFusedOps"] for r in records(json_path)]
    if engine == backend:
        assert rcs == [0, 0] and fused == [16, 16]
    else:
        assert rcs == [1, 1] and fused == []
        assert f"--ioengine {engine} only supports the native block loop" \
            in capsys.readouterr().err
