"""The port's native I/O engine against the JAX package's.

The engine is built from the port's own copy of csrc/ioengine.cpp into
elbencho_tpu_torch/_build/ and must report the JAX engine's version; the
offset generators' next_batch arrays, which feed it, must equal the JAX
package's element for element; and a host-only write+read through the
native block loop (no --gpuids) must give the JAX package's counts, file
bytes and integrity error text. Tolerance 0 throughout.
"""

import ctypes
import json
import os
import time

import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.toolkits import offset_gen as jax_gen
from elbencho_tpu.toolkits.random_algos import \
    RandAlgoGoldenPrime as JaxRand
from elbencho_tpu.utils import native as jax_native
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.ops import cuda_build
from elbencho_tpu_torch.toolkits import offset_gen as port_gen
from elbencho_tpu_torch.toolkits.random_algos import \
    RandAlgoGoldenPrime as PortRand
from elbencho_tpu_torch.utils import native as port_native
from elbencho_tpu_torch.workers import local_worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_engine(monkeypatch):
    """The JAX package's engine (its own csrc build), retried briefly: a
    test in another process may be building the same library."""
    monkeypatch.delenv("ELBENCHO_TPU_NO_NATIVE", raising=False)
    for _ in range(5):
        jax_native.reset_native_engine_cache()
        engine = jax_native.get_native_engine()
        if engine is not None:
            return engine
        time.sleep(1)
    pytest.fail("the JAX package's native engine did not build")


#: the port's engine is the JAX package's csrc/ioengine.cpp with exactly
#: these replacements: one process-wide lock around the syscalls that
#: create or destroy a kernel-AIO context (the gVisor race, ROADMAP C10)
ENGINE_AIO_LOCK = (
    (b"#include <ctime>\n", b"#include <ctime>\n#include <mutex>\n"),
    (b"""// raw syscall wrappers (kernel AIO without libaio)
inline int sys_io_setup(unsigned nr, aio_context_t* ctx) {
    return static_cast<int>(syscall(SYS_io_setup, nr, ctx));
}
inline int sys_io_destroy(aio_context_t ctx) {
    return static_cast<int>(syscall(SYS_io_destroy, ctx));
}
""", b"""// raw syscall wrappers (kernel AIO without libaio). The calls that
// create or destroy a context take one process-wide lock, around the
// syscall only: on a kernel whose io_destroy unmaps the context's ring
// page before it retires the context (gVisor), an io_setup in another
// thread can map that page again and fail with EINVAL.
inline std::mutex& aio_ctx_mutex() {
    static std::mutex m;
    return m;
}
inline int sys_io_setup(unsigned nr, aio_context_t* ctx) {
    std::lock_guard<std::mutex> lock(aio_ctx_mutex());
    return static_cast<int>(syscall(SYS_io_setup, nr, ctx));
}
inline int sys_io_destroy(aio_context_t ctx) {
    std::lock_guard<std::mutex> lock(aio_ctx_mutex());
    return static_cast<int>(syscall(SYS_io_destroy, ctx));
}
"""),
)


def test_engine_builds_from_the_ports_source_and_matches_the_jax_engine(
        monkeypatch):
    with open(os.path.join(REPO, "csrc", "ioengine.cpp"), "rb") as f:
        jax_src = f.read()
    want = jax_src
    for old, new in ENGINE_AIO_LOCK:
        assert jax_src.count(old) == 1
        want = want.replace(old, new)
    with open(os.path.join(cuda_build.CSRC_DIR, "ioengine.cpp"), "rb") as f:
        assert f.read() == want  # the JAX engine plus the lock, ABI 11
    engine = port_native.get_native_engine()
    assert engine is not None
    lib_path = cuda_build._libs["ioengine"]._name
    assert os.path.dirname(lib_path) == cuda_build.BUILD_DIR
    assert os.path.basename(lib_path).startswith("libioengine-")
    assert engine.abi_version() == port_native.EXPECTED_ABI == 11
    assert engine.version() == jax_engine(monkeypatch).version()
    assert engine.stream_backend() == jax_native.get_native_engine() \
        .stream_backend()


def _drain(gen, max_n):
    offs, lens = [], []
    while (batch := gen.next_batch(max_n)) is not None:
        assert batch[0].dtype == batch[1].dtype == np.uint64
        assert 0 < len(batch[0]) == len(batch[1]) <= max_n
        offs.append(batch[0])
        lens.append(batch[1])
    return np.concatenate(offs), np.concatenate(lens)


def _make(kind, pkg, seed, num_bytes, bs, range_len):
    mod, rand = (jax_gen, JaxRand) if pkg == "jax" else (port_gen, PortRand)
    if kind == "seq":
        return mod.OffsetGenSequential(num_bytes, bs, start=range_len)
    cls = mod.OffsetGenRandomAligned if kind == "rand" \
        else mod.OffsetGenRandomAlignedFullCoverage
    return cls(rand(seed=seed), num_bytes, bs, range_len=range_len)


#: (seed, bytes, block size, range, max_n): short final blocks, batches
#: of one, and full coverage of a range whose block count is no power of 2
GEN_CASES = ((1, 1 << 20, 4096, 1 << 20, 7),
             (2, (1 << 20) + 1000, 4096, 3 << 20, 1),
             (3, 5000 * 512, 512, 5000 * 512, 4096),
             (4, 3 * 9000 * 512, 512, 9000 * 512, 1000))


@pytest.mark.parametrize("kind", ["seq", "rand", "full"])
@pytest.mark.parametrize("case", GEN_CASES, ids=lambda c: f"seed{c[0]}")
def test_next_batch_equals_the_jax_packages(kind, case):
    seed, num_bytes, bs, range_len, max_n = case
    if kind != "seq" and num_bytes % bs:
        num_bytes -= num_bytes % bs
    want = _drain(_make(kind, "jax", seed, num_bytes, bs, range_len), max_n)
    got = _drain(_make(kind, "port", seed, num_bytes, bs, range_len), max_n)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert int(got[1].sum()) == num_bytes
    # the same sequence as next_block, also when the two are interleaved
    scalar = list(_make(kind, "port", seed, num_bytes, bs, range_len))
    assert [tuple(map(int, p)) for p in zip(*got)] == scalar
    gen = _make(kind, "port", seed, num_bytes, bs, range_len)
    mixed = [gen.next_block()]
    while (batch := gen.next_batch(max_n)) is not None:
        mixed += [tuple(map(int, p)) for p in zip(*batch)]
        if (blk := gen.next_block()) is not None:
            mixed.append(blk)
    assert mixed == scalar
    if kind == "full":  # every block exactly once per coverage
        assert np.unique(got[0][:range_len // bs]).size \
            == min(range_len, num_bytes) // bs


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def block_loops(monkeypatch):
    """Counts the port's native block-loop calls."""
    calls = []
    orig = port_native._NativeEngine.run_block_loop

    def counted(self, *args, **kwargs):
        calls.append(len(args[2]))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(port_native._NativeEngine, "run_block_loop", counted)
    return calls


#: host-only workloads: one file at each engine, striped, --rand, dir mode
HOST_CASES = {
    "sync": ["-t", "1", "--iodepth", "1"],
    "aio": ["-t", "2", "--iodepth", "4"],
    "uring": ["-t", "2", "--iodepth", "4", "--ioengine", "uring"],
    "striped": ["-t", "2", "--iodepth", "2", "+4files"],
    "rand": ["-t", "1", "--iodepth", "4", "--rand"],
    "dirmode": ["-t", "2", "--iodepth", "2", "-d", "-n", "2", "-N", "2",
                "+dir"],
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_only_native_block_loop_equals_the_jax_package(
        tmp_path, monkeypatch, block_loops, case):
    jax_engine(monkeypatch)
    assert_host_only_parity(tmp_path, case)
    assert block_loops, "the port's native block loop never ran"


@pytest.mark.parametrize("case", sorted(set(HOST_CASES) - {"uring"}))
def test_host_only_python_loop_equals_the_jax_package(
        tmp_path, monkeypatch, block_loops, case):
    """Where no engine can be built (no g++), phases without a device take
    the Python loop: held against the JAX package's Python loop."""
    monkeypatch.setenv("ELBENCHO_TPU_NO_NATIVE", "1")
    jax_native.reset_native_engine_cache()
    monkeypatch.setattr(local_worker, "get_native_engine", lambda: None)
    assert_host_only_parity(tmp_path, case)
    assert not block_loops, "the port's native block loop ran"


def assert_host_only_parity(tmp_path, case):
    """A host-only write+read of HOST_CASES[case] through both CLIs: the
    same counts, latency counts, files and file bytes."""
    args = [a for a in HOST_CASES[case] if not a.startswith("+")]
    flags = ["-w", "-r", "-s", "1M", "-b", "64K", "--verify", "5",
             "--nolive", *args]
    roots = {}
    for pkg in ("jax", "port"):
        root = tmp_path / pkg
        root.mkdir()
        if "+dir" in HOST_CASES[case]:
            paths = [root]
        elif "+4files" in HOST_CASES[case]:
            paths = [root / f"f{i}" for i in range(4)]
        else:
            paths = [root / "f"]
        argv = flags + ["--jsonfile", str(tmp_path / f"{pkg}.json")] \
            + [str(p) for p in paths]
        if pkg == "jax":
            assert jax_main(argv) == 0
        else:
            assert port_main(argv, device="cpu") == 0
        roots[pkg] = root
    jax_recs, port_recs = (_records(tmp_path / f"{p}.json")
                           for p in ("jax", "port"))
    keys = ("Phase", "BytesLast", "EntriesLast", "TpuHbmBytes",
            "TpuStreamFusedOps")
    assert [r["Phase"] for r in port_recs] == \
        (["MKDIRS"] if case == "dirmode" else []) + ["WRITE", "READ"]
    for jr, pr in zip(jax_recs, port_recs, strict=True):
        assert {k: pr[k] for k in keys} == {k: jr[k] for k in keys}
        assert pr["IOLatHisto"]["LatNumValues"] == \
            jr["IOLatHisto"]["LatNumValues"]
    files = sorted(p.relative_to(roots["jax"])
                   for p in roots["jax"].rglob("*") if p.is_file())
    assert files and files == sorted(
        p.relative_to(roots["port"])
        for p in roots["port"].rglob("*") if p.is_file())
    for rel in files:
        assert (roots["port"] / rel).read_bytes() == \
            (roots["jax"] / rel).read_bytes()


@pytest.mark.parametrize("damage", ["flip", "zero"])
def test_corrupted_block_fails_with_the_jax_packages_message(
        tmp_path, monkeypatch, capsys, block_loops, damage):
    jax_engine(monkeypatch)
    flags = ["-t", "1", "-s", "1M", "-b", "64K", "--iodepth", "4",
             "--verify", "5", "--nolive"]
    errors = {}
    for pkg, run in (("jax", lambda a: jax_main(a)),
                     ("port", lambda a: port_main(a, device="cpu"))):
        path = tmp_path / pkg
        assert run(["-w", *flags, str(path)]) == 0
        data = bytearray(path.read_bytes())
        if damage == "flip":
            data[700001] ^= 0x10
        else:
            data[700000:700008] = bytes(8)
        path.write_bytes(bytes(data))
        capsys.readouterr()
        assert run(["-r", *flags, str(path)]) == 1
        err = capsys.readouterr().err
        errors[pkg] = err[err.index("data integrity check failed"):] \
            .splitlines()[0]
    assert block_loops
    assert errors["port"] == errors["jax"]
    assert "at file offset 700000:" in errors["port"]
    assert errors["port"].endswith("(read of an unwritten/sparse region?)") \
        == (damage == "zero")


def test_native_interrupt_flag_is_set_by_interrupt_execution():
    from elbencho_tpu_torch.workers.base import Worker
    from elbencho_tpu_torch.workers.shared import WorkersSharedData
    from elbencho_tpu_torch.config.args import BenchConfig
    worker = Worker(WorkersSharedData(BenchConfig()), 0)
    assert isinstance(worker._native_interrupt, ctypes.c_int)
    worker.interrupt_execution()
    assert worker._native_interrupt.value == 1
    worker.reset_stats()
    assert worker._native_interrupt.value == 0


def test_failed_host_build_raises_with_the_compilers_output(tmp_path,
                                                            monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*"
                                           r"broken\.cpp[\s\S]*error"):
        cuda_build.load_host_library("broken")
    assert "broken" not in cuda_build._libs


def test_concurrent_builds_of_one_source_each_load_a_whole_library(
        tmp_path):
    """Processes that build the same source at once (pytest-xdist runs
    test files in parallel) each load a complete library."""
    import subprocess
    import sys
    (tmp_path / "answer.cpp").write_text(
        'extern "C" int answer() { return 42; }\n')
    code = (
        "import sys; from elbencho_tpu_torch.ops import cuda_build as b;"
        f"b.CSRC_DIR = {str(tmp_path)!r};"
        f"b.BUILD_DIR = {str(tmp_path / '_build')!r};"
        "sys.exit(0 if b.load_host_library('answer').answer() == 42 else 1)")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO)
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    built = os.listdir(tmp_path / "_build")
    assert len(built) == 1 and built[0].startswith("libanswer-")


def test_stream_ring_over_the_staging_slots(tmp_path):
    """The wrapper's ring over a StagingPool's slots: reads land in the
    slot they were submitted on, inflight and the oldest op's age follow
    the ring, a slot in flight refuses a second op, cancelling an idle
    slot is no error, and close drains."""
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    engine = port_native.get_native_engine()
    path = tmp_path / "f"
    data = np.arange(4 * 4096 // 8, dtype=np.uint64)
    path.write_bytes(data.tobytes())
    pool = StagingPool(4, 4096)
    fd = os.open(path, os.O_RDONLY)
    try:
        stream = engine.open_stream([fd], pool.slot_addrs, 4096)
        assert stream.backend_name in ("uring", "aio")
        for slot in range(4):
            stream.submit(3 - slot, 0, slot * 4096, 4096, is_write=False)
        assert stream.inflight() == 4  # in flight until reaped
        assert stream.oldest_age_usec() >= 0
        with pytest.raises(port_native.NativeStreamError, match="slot 0"):
            stream.submit(0, 0, 0, 4096, is_write=False)  # -EBUSY
        events = []
        while len(events) < 4:
            events += stream.reap(1, 1000, ctypes.c_int(0))
        assert sorted(slot for slot, _lat, _res in events) == [0, 1, 2, 3]
        assert all(res == 4096 for _slot, _lat, res in events)
        assert stream.inflight() == 0
        stream.cancel(0)  # idle: -ENOENT is not an error
        with pytest.raises(port_native.NativeStreamError):
            stream.submit(0, 0, 0, 8192, is_write=False)  # > the slot
        for slot in range(4):
            got = np.frombuffer(pool.views[3 - slot], dtype=np.uint64)
            assert (got == data[slot * 512:(slot + 1) * 512]).all()
        assert stream.close() == 0
        assert stream.close() == 0  # idempotent
    finally:
        os.close(fd)
        pool.close()


@pytest.mark.parametrize("first_only", [False, True])
def test_a_first_fault_schedule_never_faults_a_retry(tmp_path, first_only):
    """The ring's fault knob with every op short (short:1): the engine's
    schedule, the JAX package's, counts every submit and faults a retry
    too; with "first" (short:1:0:first) a retry (resubmit) is neither
    faulted nor counted, so the next first submit is faulted as
    if no retry had been made."""
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    assert port_native.parse_fault_spec("short:1:0:first") == (0, 1, 2, True)
    assert port_native.parse_fault_spec("hang:13:2") == (2, 13, 3, False)
    for bad in ("short:5:0:last", "short:5:0:first:1"):
        with pytest.raises(ValueError, match="malformed"):
            port_native.parse_fault_spec(bad)
    engine = port_native.get_native_engine()
    path = tmp_path / "f"
    path.write_bytes(bytes(4 * 4096))
    pool = StagingPool(1, 4096)
    fd = os.open(path, os.O_RDONLY)
    try:
        stream = engine.open_stream([fd], pool.slot_addrs, 4096)
        stream.set_fault_from_spec("short:1:0:first" if first_only
                                   else "short:1")
        got = []
        for off, retry in ((0, False), (0, True), (4096, False),
                           (4096, True), (8192, True)):
            (stream.resubmit if retry else stream.submit)(
                0, 0, off, 4096, is_write=False)
            events = []
            while not events:
                events = stream.reap(1, 1000, ctypes.c_int(0))
            got.append(events[0][2])
        full = 4096 if first_only else 2048
        assert got == [2048, full, 2048, full, full]
        assert stream.close() == 0
    finally:
        os.close(fd)
        pool.close()


class _OverlapRecorder:
    """The engine library with its AIO-context calls (the stream probe,
    open and close) timed: records the most of them ever in flight at
    once, holding each open for a moment so that an unserialized call
    from another thread would overlap it."""

    _CALLS = ("ioengine_stream_backend", "ioengine_stream_open",
              "ioengine_stream_close")

    def __init__(self, lib):
        import threading
        self._lib = lib
        self._mu = threading.Lock()
        self.active = self.most = self.calls = 0

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._CALLS:
            return fn

        def timed(*args):
            with self._mu:
                self.active += 1
                self.calls += 1
                self.most = max(self.most, self.active)
            try:
                time.sleep(0.002)
                return fn(*args)
            finally:
                with self._mu:
                    self.active -= 1
        return timed


def test_aio_context_calls_never_overlap_across_threads(tmp_path):
    """Workers that probe the stream backend and open and close rings at
    once reach the engine one at a time (an io_setup beside another
    thread's io_destroy fails with EINVAL on some kernels), and the probe
    runs once per engine."""
    import threading
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    engine = port_native._NativeEngine(port_native.get_native_engine()._lib)
    recorder = _OverlapRecorder(engine._lib)
    engine._lib = recorder
    path = tmp_path / "f"
    path.write_bytes(bytes(8192))
    fd = os.open(path, os.O_RDONLY)
    pools = [StagingPool(2, 4096) for _ in range(4)]
    backends, errors = [], []

    def worker(pool):
        try:
            for _ in range(5):
                backends.append(engine.stream_backend())
                engine.open_stream([fd], pool.slot_addrs, 4096).close()
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)
    threads = [threading.Thread(target=worker, args=(p,)) for p in pools]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        os.close(fd)
        for pool in pools:
            pool.close()
    assert errors == []
    assert set(backends) == {port_native.get_native_engine().stream_backend()}
    assert recorder.calls == 1 + 2 * 5 * len(pools)  # one probe
    assert recorder.most == 1


def test_the_aio_block_loop_from_four_threads_books_every_call(tmp_path):
    """Four threads run the engine's block loop on kernel AIO at
    --iodepth 4 at once, 50 calls each, over files of their own: each
    call sets up and destroys its context under the engine's lock, and
    succeeds and books its bytes; the reads check the writes' --verify
    pattern (the race itself shows only on the
    card's kernel; here the test guards against a deadlock and wrong
    accounting)."""
    import threading
    from types import SimpleNamespace

    from elbencho_tpu_torch.stats.latency_histogram import LatencyHistogram
    from elbencho_tpu_torch.utils.staging_pool import StagingPool
    from elbencho_tpu_torch.workers.base import LiveOps
    engine = port_native.get_native_engine()
    block, blocks, calls = 4096, 8, 50
    offsets = np.arange(blocks, dtype=np.uint64) * np.uint64(block)
    lengths = np.full(blocks, block, dtype=np.uint64)
    errors = []

    def worker(rank, w):
        fd = os.open(tmp_path / f"f{rank}", os.O_RDWR | os.O_CREAT, 0o644)
        pool = StagingPool(1, block * blocks)
        try:
            for i in range(calls):
                engine.run_block_loop(
                    [fd], None, offsets, lengths, i % 2 == 0,
                    pool.slot_addrs[0], 4, w, ctypes.c_int(0),
                    engine="aio", verify_salt=7)
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)
        finally:
            os.close(fd)
            pool.close()

    workers = [SimpleNamespace(
        rank=r, live_ops=LiveOps(), live_ops_rwmix_read=LiveOps(),
        iops_latency_histo=LatencyHistogram(),
        iops_latency_histo_rwmix=LatencyHistogram(),
        _num_iops_submitted=0,
        create_stonewall_stats_if_triggered=lambda: None)
        for r in range(4)]
    threads = [threading.Thread(target=worker, args=(r, w))
               for r, w in enumerate(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a block loop hung"
    assert errors == []
    for rank, w in enumerate(workers):
        assert w.live_ops.num_iops_done == calls * blocks
        assert w.live_ops.num_bytes_done == calls * blocks * block
        assert w.iops_latency_histo.num_values == calls * blocks
        assert w._num_iops_submitted == calls * blocks
        # the writes laid down the --verify 7 pattern the reads checked
        assert os.path.getsize(tmp_path / f"f{rank}") == blocks * block
