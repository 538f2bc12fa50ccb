"""Data-plane fault tolerance of the port (device="cpu") against the JAX
package: the storage-error classifier and the retrier, --ioretries in
the Python loop, the native block loop and the fused ring under injected
faults, --iotimeout, the three --gpufallback modes under a simulated lost
device, the slice phase's device-loss message, the configuration errors
and the records that tools/elbencho-tpu-summarize-json reads.

Ported from tests/test_io_fault_tolerance.py and
tests/test_pod_slice.py::test_chip_loss_aborts_loudly_not_failover. Every
count is compared at tolerance 0. The fused ring's counts were equal run
after run in both packages (one worker, one ring: the engine's fault
schedule counts submits, and the retries of both packages submit alike).
"""

import errno
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.service.fault_tolerance import RetryPolicy as JaxPolicy
from elbencho_tpu.tpu import device as jax_device
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu.workers import io_errors as jax_io
from elbencho_tpu.workers import tpuslice as jax_slice
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.cuda import device as port_device
from elbencho_tpu_torch.cuda.device import CudaWorkerContext
from elbencho_tpu_torch.utils import native as port_native
from elbencho_tpu_torch.workers import gpuslice as port_slice
from elbencho_tpu_torch.workers import io_errors as port_io
from elbencho_tpu_torch.workers.shared import WorkerException
from test_torch_native import jax_engine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: -t 1 -s 512K -b 16K --iodepth 4: 32 blocks through one ring of 4 slots
RING = ["-t", "1", "-s", "512K", "-b", "16K", "--iodepth", "4"]
#: -t 1 -s 256K -b 16K: 16 blocks
SMALL = ["-t", "1", "-s", "256K", "-b", "16K"]
FAULT_KEYS = ("Phase", "BytesLast", "IoRetries", "IoTimeouts",
              "TpuStreamFusedOps", "TpuChipFailovers", "TpuH2dStagedOps",
              "TpuD2hStagedOps")


def jax_flags(args):
    return [a.replace("--gpu", "--tpu") if a.startswith("--gpu") else a
            for a in args]


def run(package, args, path, json_path):
    """One CLI run of `package` ("port" or "jax"); the JAX package gets
    the --tpu* names of the --gpu* flags. Returns (rc, records)."""
    if os.path.exists(json_path):
        os.unlink(json_path)
    argv = args + ["--nolive", "--jsonfile", str(json_path), str(path)]
    if package == "port":
        rc = port_main(argv, device="cpu")
    else:
        rc = jax_main(jax_flags(argv))
    recs = []
    if os.path.exists(json_path):
        with open(json_path) as f:
            recs = [json.loads(line) for line in f]
    return rc, recs


def summary(recs):
    return [{k: r[k] for k in FAULT_KEYS} for r in recs]


@pytest.fixture
def both(tmp_path, monkeypatch):
    """Runs each package in a directory of its own; the JAX package
    with its native engine."""
    jax_engine(monkeypatch)

    def go(package, args, name="f"):
        d = tmp_path / package
        d.mkdir(exist_ok=True)
        return run(package, args, d / name, d / "res.json")
    return go


# ---------------------------------------------------------------------------
# the classifier and the retrier
# ---------------------------------------------------------------------------

def test_errno_sets_and_short_io_text_equal_the_jax_package():
    assert port_io.TRANSIENT_ERRNOS == jax_io.TRANSIENT_ERRNOS
    assert port_io.PERMANENT_ERRNOS == jax_io.PERMANENT_ERRNOS
    assert port_io.NETFS_TYPES == jax_io.NETFS_TYPES
    for args in ((True, 4096, 100, 512), (False, 0, 0, 16384)):
        port, jax = port_io.ShortIOError(*args), jax_io.ShortIOError(*args)
        assert str(port) == str(jax)
        assert port.errno == jax.errno == errno.EIO
    assert str(port_io.ShortIOError(True, 4096, 100, 512)) \
        == "short read at offset 4096: 100 != 512"


ERRNOS = sorted(port_io.TRANSIENT_ERRNOS | port_io.PERMANENT_ERRNOS
                | {errno.EIO, errno.ENOMEM, errno.ENXIO, errno.EPIPE,
                   errno.ECONNRESET, errno.EFBIG})


@pytest.mark.parametrize("eno", ERRNOS, ids=errno.errorcode.get)
def test_classifier_equals_the_jax_package(monkeypatch, eno):
    """On a network file system and off it, by path (a synthetic mount
    table) and by the netfs override."""
    mounts = [("/mnt/nfs", True), ("/", False)]
    for mod in (port_io, jax_io):
        monkeypatch.setattr(mod, "_load_netfs_mounts", lambda: mounts)
        mod.reset_netfs_cache()
    err = OSError(eno, os.strerror(eno))
    for kwargs in ({"path": "/home/x/f"}, {"path": "/mnt/nfs/f"},
                   {"netfs": True}, {"netfs": False}, {}):
        assert port_io.classify_io_error(err, **kwargs) \
            == jax_io.classify_io_error(err, **kwargs), kwargs
    for mod in (port_io, jax_io):
        mod.reset_netfs_cache()


def test_classifier_table_and_non_os_errors():
    """The documented table, pinned (the JAX test's rows)."""
    for eno in (errno.EINTR, errno.EAGAIN, errno.ETIMEDOUT, errno.ESTALE):
        assert port_io.classify_io_error(OSError(eno, "x")) == "transient"
    for eno in (errno.ENOSPC, errno.EROFS, errno.EBADF, errno.ENOENT,
                errno.EACCES, errno.EINVAL):
        assert port_io.classify_io_error(OSError(eno, "x")) == "permanent"
    assert port_io.classify_io_error(
        port_io.ShortIOError(True, 0, 1, 2)) == "transient"
    for err in (ValueError("bug"), RuntimeError("x"), OSError("no errno")):
        assert port_io.classify_io_error(err) == "permanent" \
            == jax_io.classify_io_error(err)


class _FakeWorker:
    def __init__(self, rank=0):
        self.rank = rank
        self.io_retries = 0
        self.io_retry_usec = 0
        self.io_timeouts = 0

    def check_interruption_flag_only(self):
        pass


def _retriers(rank, **policy):
    port_w, jax_w = _FakeWorker(rank), _FakeWorker(rank)
    return (port_io.IoRetrier(port_w, port_io.RetryPolicy(**policy)),
            jax_io.IoRetrier(jax_w, JaxPolicy(**policy)))


@pytest.mark.parametrize("rank", [0, 1, 7])
def test_retrier_counts_and_backoff_equal_the_jax_package(monkeypatch,
                                                          rank):
    """The same retries, the same jittered backoff sequence drawn from
    Random(rank), the original error re-raised, a permanent error not
    retried."""
    slept = []
    monkeypatch.setattr("time.sleep", slept.append)
    results = []
    for retrier, mod in zip(_retriers(rank, num_retries=3, budget_secs=30),
                            (port_io, jax_io)):
        slept.clear()
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError(errno.EINTR, "interrupted")
            return "ok"

        assert retrier.run(flaky) == "ok"
        with pytest.raises(OSError) as exc:
            retrier.run(lambda: (_ for _ in ()).throw(
                OSError(errno.ENOSPC, "full")))
        assert exc.value.errno == errno.ENOSPC
        with pytest.raises(mod.ShortIOError):  # 3 retries, then raised
            retrier.run(lambda: (_ for _ in ()).throw(
                mod.ShortIOError(True, 0, 1, 2)))
        w = retrier.worker
        results.append((calls["n"], w.io_retries, w.io_retry_usec,
                        list(slept)))
    assert results[0] == results[1]
    assert results[0][1] == 2 + 3 and results[0][2] > 0


def test_retrier_budget_exhaustion_equals_the_jax_package(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    for budget in (0.0, 0.3):
        counts = []
        for retrier in _retriers(0, num_retries=100, budget_secs=budget):
            with pytest.raises(OSError) as exc:
                retrier.run(lambda: (_ for _ in ()).throw(
                    OSError(errno.EAGAIN, "busy")))
            assert exc.value.errno == errno.EAGAIN  # the original error
            counts.append((retrier.worker.io_retries,
                           retrier.worker.io_retry_usec))
        assert counts[0] == counts[1]
    assert counts[0][0] > 0


# ---------------------------------------------------------------------------
# the Python loop (--gpuids 0 --gpustream off) and the native block loop
# ---------------------------------------------------------------------------

def _write(both, package, args=()):
    rc, _ = both(package, ["-w", *SMALL, *args])
    assert rc == 0


PYLOOP = ["--gpuids", "0", "--gpustream", "off"]


def _flaky_preadv(monkeypatch, failures=0, short_once=False):
    real = os.preadv
    state = {"failures": failures, "short": short_once, "calls": 0}

    def preadv(fd, bufs, off):
        state["calls"] += 1
        if state["failures"] > 0:
            state["failures"] -= 1
            raise OSError(errno.EINTR, "interrupted system call")
        n = real(fd, bufs, off)
        if state["short"]:
            state["short"] = False
            return n - 512
        return n

    monkeypatch.setattr(os, "preadv", preadv)
    return state


@pytest.mark.parametrize("fault", ["eintr", "short"])
def test_python_loop_retries_equal_the_jax_package(both, monkeypatch,
                                                   fault):
    got = {}
    for package in ("port", "jax"):
        _write(both, package)
        _flaky_preadv(monkeypatch, failures=2 if fault == "eintr" else 0,
                      short_once=fault == "short")
        rc, recs = both(package, ["-r", *SMALL, *PYLOOP, "--ioretries",
                                  "3"])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert rc == 0, package
        assert recs[0]["IoRetryUsec"] > 0
        got[package] = summary(recs)
    assert got["port"] == got["jax"]
    assert got["port"][0]["IoRetries"] == (2 if fault == "eintr" else 1)
    assert got["port"][0]["TpuH2dStagedOps"] == 16


def test_python_loop_default_fails_fast_as_the_jax_package(both,
                                                           monkeypatch,
                                                           capsys):
    for package in ("port", "jax"):
        _write(both, package)
        state = _flaky_preadv(monkeypatch, short_once=True)
        rc, _ = both(package, ["-r", *SMALL, *PYLOOP])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert not state["short"] and rc != 0, package
        assert "short read at offset 0: 15872 != 16384" \
            in capsys.readouterr().err, package


def test_a_permanent_error_is_not_retried_in_either_package(both,
                                                            monkeypatch):
    for package in ("port", "jax"):
        calls = {"n": 0}

        def nospace(fd, bufs, off):
            calls["n"] += 1
            raise OSError(errno.ENOSPC, "no space left on device")

        monkeypatch.setattr(os, "pwritev", nospace)
        rc, _ = both(package, ["-w", *SMALL, *PYLOOP, "--ioretries", "5"])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert rc != 0 and calls["n"] == 1, package


@pytest.mark.parametrize("op", ["-w", "-r"])
def test_native_block_loop_retries_a_chunk_as_the_jax_package(
        both, monkeypatch, op):
    """No --gpuids: the engine's block loop. A chunk that fails with
    EINTR twice is run again whole; nothing counts twice."""
    got = {}
    for package, engine_cls in (
            ("port", port_native._NativeEngine),
            ("jax", jax_native._NativeEngine)):
        _write(both, package, ["--verify", "3"])
        real = engine_cls.run_block_loop
        state = {"failures": 2}

        def flaky(self, *a, real=real, state=state, **kw):
            if state["failures"] > 0:
                state["failures"] -= 1
                raise OSError(errno.EINTR, "interrupted system call")
            return real(self, *a, **kw)

        monkeypatch.setattr(engine_cls, "run_block_loop", flaky)
        rc, recs = both(package, [op, *SMALL, "--verify", "3",
                                  "--ioretries", "3"])
        monkeypatch.setattr(engine_cls, "run_block_loop", real)
        assert rc == 0 and state["failures"] == 0, package
        got[package] = [dict(r, ops=rec["IOLatHisto"]["LatNumValues"])
                        for r, rec in zip(summary(recs), recs)]
        # without --ioretries the first EINTR ends the phase
        state["failures"] = 1
        monkeypatch.setattr(engine_cls, "run_block_loop", flaky)
        rc, _ = both(package, [op, *SMALL, "--verify", "3"])
        monkeypatch.setattr(engine_cls, "run_block_loop", real)
        assert rc != 0, package
    assert got["port"] == got["jax"]
    assert got["port"][0]["IoRetries"] == 2
    assert got["port"][0]["BytesLast"] == 256 << 10


# ---------------------------------------------------------------------------
# the fused ring under the engine's fault injection (ELBENCHO_TPU_IO_FAULT)
# ---------------------------------------------------------------------------

#: name -> (spec, flags of the read, retries at least)
RING_FAULTS = {
    "eio": ("eio:7", [], 4),
    "short": ("short:5", ["--verify", "11"], 6),
    "hang": ("hang:13", ["--iotimeout", "1"], 2),
}


@pytest.mark.parametrize("case", list(RING_FAULTS))
def test_fused_ring_faults_equal_the_jax_package(both, monkeypatch, case):
    spec, flags, least = RING_FAULTS[case]
    monkeypatch.setenv("ELBENCHO_TPU_TESTING", "1")
    for mod in (port_io, jax_io):  # EIO is transient on a netfs only
        monkeypatch.setattr(mod, "is_netfs_path", lambda p: True)
    got = {}
    for package in ("port", "jax"):
        monkeypatch.delenv("ELBENCHO_TPU_IO_FAULT", raising=False)
        rc, _ = both(package, ["-w", *RING, "--verify", "11"])
        assert rc == 0
        monkeypatch.setenv("ELBENCHO_TPU_IO_FAULT", spec)
        rc, recs = both(package, ["-r", *RING, "--gpuids", "0",
                                  "--ioretries", "3", *flags]
                        + (["--gpustream", "on"] if package == "port"
                           else []))
        assert rc == 0, package
        got[package] = summary(recs)
    assert got["port"] == got["jax"]
    rec = got["port"][0]
    assert rec["TpuStreamFusedOps"] == 32 and rec["BytesLast"] == 512 << 10
    assert rec["IoRetries"] >= least
    if case == "hang":
        assert rec["IoTimeouts"] >= 2 and rec["IoRetries"] >= \
            rec["IoTimeouts"]
    else:
        assert rec["IoTimeouts"] == 0


@pytest.mark.parametrize("netfs,retries", [(True, False), (False, True)])
def test_fused_ring_eio_fails_fast_as_the_jax_package(both, monkeypatch,
                                                      capsys, netfs,
                                                      retries):
    """EIO aborts the phase without --ioretries, and with it on a local
    file system (EIO is permanent there), with the engine's error."""
    monkeypatch.setenv("ELBENCHO_TPU_TESTING", "1")
    for mod in (port_io, jax_io):
        monkeypatch.setattr(mod, "is_netfs_path", lambda p, n=netfs: n)
    for package in ("port", "jax"):
        monkeypatch.delenv("ELBENCHO_TPU_IO_FAULT", raising=False)
        assert both(package, ["-w", *RING])[0] == 0
        monkeypatch.setenv("ELBENCHO_TPU_IO_FAULT", "eio:7")
        capsys.readouterr()
        rc, _ = both(package, ["-r", *RING, "--gpuids", "0"]
                     + (["--ioretries", "3"] if retries else []))
        assert rc != 0, package
        assert "phase READFILES failed: OSError: [Errno 5] Input/output " \
            "error" in capsys.readouterr().err, package


# ---------------------------------------------------------------------------
# --gpufallback: a simulated lost device through the transfer path
# ---------------------------------------------------------------------------

class XlaRuntimeError(Exception):
    """The JAX tests' stand-in; both classifiers match it by name."""


def _arm(monkeypatch, cls, method, times=1):
    """Raise XlaRuntimeError from the first `times` mid-phase calls of
    cls.method (the prepare-time warm-ups do not call it)."""
    orig = getattr(cls, method)
    state = {"left": times}

    def failing(self, *a, **kw):
        if state["left"] > 0:
            state["left"] -= 1
            raise XlaRuntimeError("fake device failure")
        return orig(self, *a, **kw)

    monkeypatch.setattr(cls, method, failing)
    return state


CONTEXTS = {"port": CudaWorkerContext, "jax": jax_device.TpuWorkerContext}


@pytest.mark.parametrize("loop", ["python", "ring"])
def test_chip_failover_equals_the_jax_package(both, monkeypatch, loop):
    got = {}
    for package in ("port", "jax"):
        assert both(package, ["-w", *SMALL])[0] == 0
        state = _arm(monkeypatch, CONTEXTS[package], "host_to_device")
        rc, recs = both(package, [
            "-r", *SMALL, "--iodepth", "4", "--gpuids", "0,1",
            "--gpustream", "off" if loop == "python" else "on",
            "--gpufallback", "chip"])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert state["left"] == 0 and rc == 0, package
        got[package] = summary(recs)
    assert got["port"] == got["jax"]
    rec = got["port"][0]
    assert rec["TpuChipFailovers"] == 1 and rec["TpuH2dStagedOps"] == 16
    assert rec["BytesLast"] == 256 << 10


@pytest.mark.parametrize("verify", [True, False])
def test_host_staging_writes_the_jax_packages_bytes(both, monkeypatch,
                                                    tmp_path, verify):
    """--gpufallback host from the first device->host copy of a write:
    every block is host-staged, and the files of both packages are
    byte-equal (the verify pattern, or the "fast" generator's pool seeded
    by the GPU id). A fresh --verify read passes in both."""
    flags = ["--verify", "7"] if verify else []
    got = {}
    for package in ("port", "jax"):
        state = _arm(monkeypatch, CONTEXTS[package], "device_to_host")
        rc, recs = both(package, ["-w", *SMALL, *flags, "--gpuids", "0",
                                  "--gpustream", "off", "--gpufallback",
                                  "host"])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert state["left"] == 0 and rc == 0, package
        got[package] = summary(recs)
        if verify:
            assert both(package, ["-r", *SMALL, *flags])[0] == 0
    assert got["port"] == got["jax"]
    assert got["port"][0]["TpuChipFailovers"] == 1
    assert got["port"][0]["TpuD2hStagedOps"] == 16
    port_bytes = (tmp_path / "port" / "f").read_bytes()
    assert port_bytes == (tmp_path / "jax" / "f").read_bytes()
    assert len(port_bytes) == 256 << 10


def test_host_failover_of_a_gpuverify_read_verifies_on_the_host(
        both, monkeypatch, tmp_path, capsys):
    """After the failover the blocks are checked on the host, with the
    host's error: a byte flipped in block 10 fails the read in both
    packages at the same offset."""
    bad = 10 * 16384 + 100
    args = ["-r", *SMALL, "--verify", "7", "--gpuids", "0", "--gpuverify",
            "--gpustream", "off", "--gpufallback", "host"]
    for package in ("port", "jax"):
        assert both(package, ["-w", *SMALL, "--verify", "7"])[0] == 0
        state = _arm(monkeypatch, CONTEXTS[package], "host_to_device")
        rc, recs = both(package, args)
        assert state["left"] == 0 and rc == 0, package
        assert recs[0]["TpuChipFailovers"] == 1
        with open(tmp_path / package / "f", "r+b") as f:
            f.seek(bad)
            byte = f.read(1)
            f.seek(bad)
            f.write(bytes([byte[0] ^ 1]))
        capsys.readouterr()
        _arm(monkeypatch, CONTEXTS[package], "host_to_device")
        rc, _ = both(package, args)
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert rc != 0, package
        assert f"data integrity check failed at file offset {bad - 4}" \
            in capsys.readouterr().err, package


def test_device_loss_aborts_by_default_as_the_jax_package(both,
                                                          monkeypatch,
                                                          capsys):
    for package, flag in (("port", "--gpufallback"),
                          ("jax", "--tpufallback")):
        assert both(package, ["-w", *SMALL])[0] == 0
        _arm(monkeypatch, CONTEXTS[package], "host_to_device")
        rc, _ = both(package, ["-r", *SMALL, "--gpuids", "0,1",
                               "--gpustream", "off"])
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert rc != 0, package
        assert flag in capsys.readouterr().err, package


def test_device_loss_message_names_the_gpu_and_the_flag():
    cause = XlaRuntimeError("fake device failure")
    port = str(port_device.GpuDeviceLostError(1, cause))
    jax = str(jax_device.TpuDeviceLostError(1, cause))
    assert port == jax.replace("TPU chip", "GPU").replace(
        "--tpufallback", "--gpufallback").replace("single-chip",
                                                  "single-GPU")
    assert port == ("GPU 1 lost mid-phase (XlaRuntimeError: fake device "
                    "failure); rerun with --gpufallback chip|host to "
                    "survive single-GPU loss")


#: errors both classifiers see alike (the JAX test's rows and markers)
SHARED_LOSS_ROWS = [
    (XlaRuntimeError("boom"), True),
    (RuntimeError("device lost: chip 3"), True),
    (RuntimeError("DATA_LOSS: stream"), True),
    (RuntimeError("failed to enqueue the transfer"), True),
    (RuntimeError("the device is in an error state"), True),
    (RuntimeError("Device unavailable"), True),
    (RuntimeError("hardware failure on the host link"), True),
    (RuntimeError("device halted"), True),
    (RuntimeError(
        "--gpubudget exceeded: measured per-op dispatch overhead 9.1 usec "
        "> budget 5 usec over 100 ops (910 usec host-side dispatch total; "
        "DMA wall 100 usec)"), False),
    (ValueError("logic bug"), False),
    (OSError(errno.EIO, "Input/output error"), False),
]


@pytest.mark.parametrize("err,loss", SHARED_LOSS_ROWS,
                         ids=lambda v: str(v)[:24] if not
                         isinstance(v, bool) else str(v))
def test_device_loss_classifier_equals_the_jax_package(err, loss):
    assert port_device.is_device_loss_error(err) is loss
    assert jax_device.is_device_loss_error(err) is loss


class _AcceleratorError(RuntimeError):
    """Shaped like torch.AcceleratorError: a CUDA error with its code."""

    def __init__(self, code, msg):
        super().__init__(msg)
        self.error_code = code


#: the port's CUDA rows: a loss only where the runtime's error is sticky
CUDA_LOSS_ROWS = [
    (RuntimeError("CUDA error: an illegal memory access was encountered\n"
                  "CUDA kernel errors might be asynchronously reported"),
     True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), True),
    (RuntimeError("CUDA error: hardware stack error"), True),
    (RuntimeError("CUDA error: an illegal instruction was encountered"),
     True),
    (RuntimeError("CUDA error: misaligned address"), True),
    (RuntimeError("CUDA error: invalid program counter"), True),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), True),
    (RuntimeError("CUDA error: uncorrectable NVLink error detected during "
                  "the execution"), True),
    (RuntimeError("Unable to determine the device handle for GPU0: "
                  "GPU is lost"), True),
    (RuntimeError("NVRM: GPU has fallen off the bus"), True),
    (_AcceleratorError(700, "CUDA error"), True),
    (_AcceleratorError(46, "CUDA error"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 16.00 MiB"), False),
    (_AcceleratorError(2, "CUDA error: out of memory"), False),
    (RuntimeError("CUDA error: invalid argument"), False),
    (_AcceleratorError(1, "CUDA error: invalid argument"), False),
    (RuntimeError("CUDA error: device not ready"), False),
    (_AcceleratorError(600, "CUDA error: device not ready"), False),
    (RuntimeError("cudaHostRegister of a 4096-byte staging slab failed "
                  "(cudaError 712)"), False),
    (ValueError("on-device integrity check failed for block at offset 0"),
     False),
]


@pytest.mark.parametrize("err,loss", CUDA_LOSS_ROWS,
                         ids=lambda v: str(v)[:32] if not
                         isinstance(v, bool) else str(v))
def test_cuda_device_loss_rows(err, loss):
    assert port_device.is_device_loss_error(err) is loss
    assert port_device.is_device_loss_error(
        port_device.GpuDeviceLostError(0, err))  # its own type, by name


@pytest.mark.parametrize("code", sorted(port_device._STICKY_CUDA_ERRORS))
def test_a_fault_of_the_ports_own_kernel_is_not_a_loss(code):
    """The fingerprint wrapper names its CUDA error by number; a sticky
    code there may be a fault of fingerprint.cu itself, so it never
    passes for a lost GPU."""
    err = RuntimeError(f"fingerprint_u32 kernel launch failed "
                       f"(cudaError {code})")
    assert not port_device.is_device_loss_error(err)


@pytest.mark.parametrize("loop", ["python", "ring"])
@pytest.mark.parametrize("fallback", ["host", "chip"])
def test_a_fingerprint_kernel_error_aborts_naming_the_kernel(
        tmp_path, monkeypatch, capsys, fallback, loop):
    """A --gpuverify read whose 3rd fingerprint launch fails with a
    sticky code: under --gpufallback host or chip the phase still
    aborts, its error names the kernel, and nothing fails over."""
    from elbencho_tpu_torch.ops import verify as port_verify
    real = port_verify.fingerprint_u32
    calls = [0]

    def failing(words):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("fingerprint_u32 kernel launch failed "
                               "(cudaError 700)")
        return real(words)

    path, json_path = tmp_path / "f", tmp_path / "res.json"
    assert run("port", ["-w", *SMALL, "--verify", "7"], path,
               json_path)[0] == 0
    monkeypatch.setattr(port_verify, "fingerprint_u32", failing)
    capsys.readouterr()
    rc, recs = run("port", ["-r", *SMALL, "--verify", "7", "--gpuids",
                            "0,1", "--gpuverify", "--gpustream",
                            "off" if loop == "python" else "on",
                            "--gpufallback", fallback], path, json_path)
    err = capsys.readouterr().err
    assert calls[0] == 3
    assert rc != 0 and not recs
    assert "fingerprint_u32 kernel launch failed (cudaError 700)" in err
    assert "lost mid-phase" not in err and "failed over" not in err


def test_a_poisoned_context_makes_no_device_call():
    """After a lost GPU, drain() and close() call nothing of the
    context's stream: after a sticky CUDA error every call raises."""
    ctx = CudaWorkerContext(chip_id=0, block_size=4096, pipeline_depth=2,
                            device="cpu")

    class DeadStream:
        def synchronize(self):
            raise AssertionError("a call into the lost device")

    ctx.host_to_device(memoryview(bytearray(4096)), 4096)
    ctx.stream = DeadStream()
    with pytest.raises(AssertionError):
        ctx.drain()
    ctx._poison_device_state()
    assert not ctx._inflight and not ctx._dev_slots
    ctx.drain()
    ctx.close()


def test_failover_to_chip_gives_the_context_a_device_of_its_own():
    ctx = CudaWorkerContext(chip_id=0, block_size=4096, pipeline_depth=2,
                            device="cpu")
    buf = memoryview(bytearray(4096))
    ctx.host_to_device(buf, 4096)
    ctx.device_to_host(buf, 4096)
    bounce = ctx._bounce
    ctx.failover_to_chip(3)
    assert (ctx.chip_id, ctx.chip_failovers, ctx.host_staging) == (3, 1,
                                                                   False)
    assert ctx._bounce is bounce  # host memory outlives the failover
    assert not ctx._dev_slots and not ctx._fill_pool
    want = torch.Generator().manual_seed(3)
    assert torch.equal(
        torch.randint(0, 9, (8,), generator=ctx._generator),
        torch.randint(0, 9, (8,), generator=want))
    ctx.host_to_device(buf, 4096)
    assert ctx.h2d_staged_ops == 2
    ctx.failover_to_host()
    assert ctx.host_staging and not ctx.verify_on_device
    assert ctx.chip_failovers == 2
    ctx.close()


def test_host_staged_copies_equal_the_jax_contexts():
    """The host-staged D2H bytes of both contexts, the pool path and the
    verify path, block after block; the H2D keeps the counts."""
    port = CudaWorkerContext(chip_id=2, block_size=16384, device="cpu")
    jax = jax_device.TpuWorkerContext(chip_id=2, block_size=16384)
    for ctx in (port, jax):
        ctx.failover_to_host()
    for salt, off, length in ((0, 0, 16384), (0, 16384, 16384),
                              (0, 0, 1000), (5, 0, 16384),
                              (5, 4096, 1004), (0, 0, 16384)):
        bufs = [memoryview(bytearray(16384)) for _ in range(2)]
        port.device_to_host(bufs[0], length, verify_salt=salt,
                            file_offset=off)
        jax.device_to_host(bufs[1], length, verify_salt=salt,
                           file_offset=off)
        assert bytes(bufs[0]) == bytes(bufs[1]), (salt, off, length)
    data = memoryview(bytearray(np.arange(4096, dtype=np.uint32).tobytes()))
    port.host_to_device(data, 16384)
    jax.host_to_device(data, 16384)
    for key in ("d2h_staged_ops", "h2d_staged_ops", "chip_failovers"):
        assert getattr(port, key) == getattr(jax, key), key
    port.close()
    jax.close()


# ---------------------------------------------------------------------------
# the slice phase, the configuration, the records
# ---------------------------------------------------------------------------

class _SliceXlaRuntimeError(RuntimeError):
    pass


_SliceXlaRuntimeError.__name__ = "XlaRuntimeError"


def test_slice_phase_aborts_on_a_lost_gpu_with_the_jax_message(
        monkeypatch):
    def boom(*a):
        raise _SliceXlaRuntimeError("device lost mid collective")

    monkeypatch.setattr(port_slice, "_run_slice_phase_inner", boom)
    monkeypatch.setattr(jax_slice, "_run_slice_phase_inner", boom)
    with pytest.raises(WorkerException,
                       match="gpufallback does not apply") as port:
        port_slice.run_gpu_slice_phase(object())
    with pytest.raises(Exception,
                       match="tpufallback does not apply") as jax:
        jax_slice.run_tpu_slice_phase(object(), None)
    assert str(port.value) == str(jax.value).replace(
        "TPU chip lost", "GPU lost").replace("--tpuslice", "--gpuslice") \
        .replace("chip loss", "GPU loss").replace(
            "--tpufallback", "--gpufallback").replace("SPMD mesh", "mesh")


def test_slice_phase_aborts_on_a_sticky_cuda_error(monkeypatch):
    def boom(*a):
        raise RuntimeError(
            "CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_slice, "_run_slice_phase_inner", boom)
    with pytest.raises(WorkerException) as port:
        port_slice.run_gpu_slice_phase(object())
    assert str(port.value) == (
        "GPU lost during the --gpuslice phase (RuntimeError: CUDA error: an "
        "illegal memory access was encountered); slice phases abort on GPU "
        "loss (--gpufallback does not apply to mesh phases)")


def test_slice_phase_other_errors_keep_the_generic_text(monkeypatch):
    def boom(*a):
        raise RuntimeError("feeder exploded")

    monkeypatch.setattr(port_slice, "_run_slice_phase_inner", boom)
    with pytest.raises(WorkerException,
                       match=r"^--gpuslice phase failed \(RuntimeError: "
                             r"feeder exploded\)$"):
        port_slice.run_gpu_slice_phase(object())


CONFIG_ERRORS = [
    (["--ioretries", "-1"], {}),
    (["--ioretrybudget", "-1"], {}),
    (["--iotimeout", "-1"], {}),
    (["--gpufallback", "bogus", "--gpuids", "0"], {}),
    (["--gpufallback", "chip"], {}),
    ([], {"ELBENCHO_TPU_IO_FAULT": "eio:7"}),
    ([], {"ELBENCHO_TPU_IO_FAULT": "bogus-spec",
          "ELBENCHO_TPU_TESTING": "1"}),
    ([], {"ELBENCHO_TPU_IO_FAULT": "hang:0", "ELBENCHO_TPU_TESTING": "1"}),
]


@pytest.mark.parametrize("args,env", CONFIG_ERRORS)
def test_config_errors_equal_the_jax_package(tmp_path, monkeypatch, capsys,
                                             args, env):
    monkeypatch.delenv("ELBENCHO_TPU_TESTING", raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    errs = {}
    for package in ("port", "jax"):
        rc, _ = run(package, ["-w", "-t", "1", "-s", "4K", *args],
                    tmp_path / "g", tmp_path / "r.json")
        assert rc != 0, package
        errs[package] = [line for line in capsys.readouterr().err
                         .splitlines() if line.startswith("ERROR")]
    assert len(errs["port"]) == 1
    assert errs["port"] == [e.replace("--tpufallback", "--gpufallback")
                            .replace("TPU chip-failover", "GPU failover")
                            .replace("--tpuids", "--gpuids")
                            for e in errs["jax"]]
    assert not (tmp_path / "g").exists()


def test_the_config_file_takes_the_fault_flags(tmp_path):
    from elbencho_tpu_torch.config.args import parse_cli
    conf = tmp_path / "c.conf"
    conf.write_text("ioretries = 4\nioretrybudget = 9\niotimeout = 2\n"
                    "gpufallback = host\n")
    cfg, _ = parse_cli(["-c", str(conf), "-r", str(tmp_path / "f")])
    assert (cfg.io_num_retries, cfg.io_retry_budget_secs,
            cfg.io_timeout_secs, cfg.gpu_fallback) == (4, 9, 2, "host")


def test_chip_failovers_merge_as_max():
    class Ctx:
        def __init__(self, n):
            for attr, _key in port_device.PATH_AUDIT_COUNTERS:
                setattr(self, attr, 0)
            self.chip_failovers = n

    class Worker:
        def __init__(self, n):
            self._gpu = Ctx(n)
            for attr, _key in port_device.PATH_AUDIT_WORKER_COUNTERS:
                setattr(self, attr, 0)
            self.io_retries = n

    totals = port_device.sum_path_audit_counters(
        [Worker(1), Worker(2), Worker(1)])
    assert totals["TpuChipFailovers"] == 2 and totals["IoRetries"] == 4
    assert "TpuChipFailovers" in jax_device.PATH_AUDIT_MAX_KEYS


def test_record_keys_and_summarize_json_banner(both, monkeypatch, tmp_path):
    """Every record carries the four keys in the JAX package's order; a
    port record with retries and a failover reads in summarize-json with
    the DEGRADED-TPU banner and the retry and failover columns."""
    monkeypatch.setenv("ELBENCHO_TPU_TESTING", "1")
    keys = {}
    for package in ("port", "jax"):
        monkeypatch.delenv("ELBENCHO_TPU_IO_FAULT", raising=False)
        rc, recs = both(package, ["-w", *RING, "--gpuids", "0"])
        assert rc == 0
        keys[package] = list(recs[0])
        four = ["IoRetries", "IoRetryUsec", "IoTimeouts", "TpuChipFailovers"]
        assert [recs[0][k] for k in four] == [0, 0, 0, 0]
    common = [k for k in keys["jax"] if k in set(keys["port"])]
    assert [k for k in keys["port"] if k in set(common)] == common
    i = keys["port"].index("TpuStreamFusedOps")
    assert keys["port"][i + 1:i + 5] == four
    monkeypatch.setenv("ELBENCHO_TPU_IO_FAULT", "short:5")
    _arm(monkeypatch, CudaWorkerContext, "host_to_device")
    rc, recs = both("port", ["-r", *RING, "--gpuids", "0", "--ioretries",
                             "3", "--gpufallback", "host"])
    assert rc == 0
    rec = recs[0]
    assert rec["IoRetries"] >= 6 and rec["TpuChipFailovers"] == 1
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "elbencho-tpu-summarize-json"),
         str(tmp_path / "port" / "res.json"), "--csv"],
        capture_output=True, text=True, check=True)
    header, row = (line.split(",") for line in out.stdout.splitlines()[:2])
    cols = dict(zip(header, row))
    assert (cols["IoRetry"], cols["IoTmo"], cols["ChipFail"]) == (
        str(rec["IoRetries"]), "0", "1")
    assert "DEGRADED-TPU" in out.stderr


def test_host_staging_of_a_block_that_is_not_whole_words():
    """A fault of the reference that the port does not keep: the JAX
    package's host-staged D2H of a 6-byte block (-b 6) fails, its pool
    blocks being whole 4-byte words (4 bytes here); the port's pool
    blocks round up to whole words, and the block is the JAX package's
    generator bytes."""
    from elbencho_tpu.toolkits.random_algos import create_rand_algo
    jax = jax_device.TpuWorkerContext(chip_id=0, block_size=6)
    port = CudaWorkerContext(chip_id=0, block_size=6, device="cpu")
    for ctx in (port, jax):
        ctx.failover_to_host()
    buf = memoryview(bytearray(8))
    with pytest.raises(ValueError, match="could not broadcast"):
        jax.device_to_host(buf, 6)
    port.device_to_host(buf, 6)
    fill = create_rand_algo("fast", seed=1)
    pool = [fill.fill_buffer(8) for _ in range(4)]
    assert bytes(buf[:6]) == pool[1][:6]  # the rotation starts at 1
    port.close()
    jax.close()


def test_slice_feeders_retry_as_the_jax_package(tmp_path, monkeypatch,
                                                capsys):
    """--ioretries keeps the slice's feeders off the ring (it has no
    re-arm) and retries their preadv reads: two EINTRs, two retries, in
    both packages (the port over 8 CPU slots, the JAX package over its 8
    devices)."""
    jax_engine(monkeypatch)
    ids = ",".join(str(i) for i in range(8))
    got = {}
    for package in ("port", "jax"):
        target = tmp_path / f"{package}.bin"
        rc, _ = run(package, ["-w", "-t", "2", "-s", "2M", "-b", "64K"],
                    target, tmp_path / "w.json")
        assert rc == 0
        _flaky_preadv(monkeypatch, failures=2)
        rc, recs = run(package, ["--gpuslice", "-t", "2", "-s", "2M", "-b",
                                 "64K", "--iodepth", "2", "--gpuids", ids,
                                 "--ioretries", "3"],
                       target, tmp_path / "s.json")
        monkeypatch.undo()
        jax_engine(monkeypatch)
        assert rc == 0, package
        got[package] = [{k: r[k] for k in ("Phase", "BytesLast",
                                           "EntriesLast", "IoRetries",
                                           "ShardIngestMiB")}
                        for r in recs]
        assert "slice ingest ring engaged" not in capsys.readouterr().out
    assert got["port"] == got["jax"]
    assert got["port"][0]["IoRetries"] == 2
