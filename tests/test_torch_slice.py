"""The port's --gpuslice data plane (device="cpu", 8 CPU mesh slots)
against the JAX package's --tpuslice on its 8 virtual CPU devices.

Each check feeds both packages the same numpy input and compares at
tolerance 0: the mesh factory's shapes and error texts, the data each
device holds after every --redistspec redistribution, the fingerprints,
the corruption refusal, the rank->shard map, the sharded ingest step
(the port given the JAX step's per-shard bits), the phase barrier's
interrupt and failure paths, and the CLI's TPUSLICE records (bytes,
entries, per-device bytes and the slice counters; the stonewall "First"
keys of a -t 2 run depend on timing and are not compared).
"""

import json
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.parallel import ingest as jax_ingest
from elbencho_tpu.parallel import slice_phase as jax_slice
from elbencho_tpu.parallel.mesh import make_ingest_mesh as jax_mesh
from elbencho_tpu.workers.manager import WorkerManager as JaxManager
from elbencho_tpu.workers.shared import \
    WorkerInterruptedException as JaxInterrupted
from elbencho_tpu.workers.tpuslice import _SliceState as JaxSliceState
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.ops.verify import fingerprint_u32
from elbencho_tpu_torch.parallel import ingest
from elbencho_tpu_torch.parallel import slice_phase
from elbencho_tpu_torch.parallel.mesh import make_ingest_mesh
from elbencho_tpu_torch.workers.gpuslice import SliceAbortError, _SliceState
from elbencho_tpu_torch.workers.manager import WorkerManager
from elbencho_tpu_torch.workers.shared import WorkerInterruptedException
from test_torch_native import jax_engine

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPECS = ("alltoall", "host", "chip", "replicate")
IDS = ",".join(str(i) for i in range(8))
MASK = 0xFFFFFFFF


def slots(n):
    return [CPU] * n


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def raised(fn, *args, **kwargs):
    """(exception type name, text) of what fn raises, or its result."""
    try:
        return fn(*args, **kwargs)
    except Exception as err:  # noqa: BLE001 - compared by name and text
        return type(err).__name__, str(err)


# ----------------------------------------------------------------------
# mesh factory
# ----------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["2x4", "1X8", "4*2", "2x", "x4", "2x4x2",
                                  "ax4", "0x8", "-1x8", "8"])
def test_parse_mesh_shape_equals_the_jax_package(spec):
    assert raised(slice_phase.parse_mesh_shape, spec) == \
        raised(jax_slice.parse_mesh_shape, spec)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_and_errors_equal_the_jax_package(n):
    """The balanced factorization, every explicit shape up to 8x8, and a
    host count that does not divide the devices, for 1 to 8 devices."""
    def port(**kw):
        return make_ingest_mesh(slots(n), **kw).devices.shape

    def ref(**kw):
        return jax_mesh(jax.devices()[:n], **kw).devices.shape

    assert port() == ref()
    for h in range(1, 9):
        for c in range(1, 9):
            assert raised(port, shape=(h, c)) == raised(ref, shape=(h, c))
        assert raised(port, num_hosts=h) == raised(ref, num_hosts=h)
    mesh = make_ingest_mesh(slots(n))
    assert mesh.axis_names == ("host", "chip")
    assert list(mesh.devices.flat) == slots(n)


# ----------------------------------------------------------------------
# redistribution + fingerprint against the JAX runner
# ----------------------------------------------------------------------

def jax_per_device(out, mesh) -> "list[np.ndarray]":
    """The JAX output's shard on each mesh device, in mesh order."""
    flat = list(mesh.devices.flat)
    by_dev = {shard.device: np.asarray(shard.data)
              for shard in out.addressable_shards}
    return [by_dev[dev] for dev in flat]


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("spec", SPECS)
def test_redistribution_equals_the_jax_package(spec, shape):
    words = 1024  # 4 KiB shards; 1024 % 8 == 0 covers alltoall
    stripe = np.random.default_rng(7).integers(
        0, 1 << 32, size=(8, words), dtype=np.uint64).astype(np.uint32)

    jmesh = jax_mesh(jax.devices(), shape=shape)
    jrunner = jax_slice.SliceRunner(jmesh, spec, words)
    jhandle = jrunner.launch(jrunner.assemble({
        d: jax.device_put(stripe[d:d + 1], jmesh.devices.flat[d])
        for d in range(8)}))
    jsum, jxor, _ = jrunner.complete(jhandle)

    mesh = make_ingest_mesh(slots(8), shape=shape)
    runner = slice_phase.SliceRunner(mesh, spec, words)
    runner.warmup()
    shards = {d: (torch.from_numpy(stripe[d].view(np.int32).copy()), None)
              for d in range(8)}
    fingerprint_u32.launches.reset()
    handle = runner.launch(runner.assemble(shards))
    got_sum, got_xor, usec = runner.complete(handle)

    want = jax_per_device(jhandle["out"], jmesh)
    # the plain version: numpy slicing of the stripe by the target layout
    plain = [stripe[rows, lo:hi] for rows, (lo, hi), _part in
             slice_phase.target_layout(spec, *shape, words)]
    for d in range(8):
        np.testing.assert_array_equal(u32(handle["out"][d]), want[d])
        np.testing.assert_array_equal(plain[d], want[d])
    assert (got_sum, got_xor) == (jsum, jxor) == \
        slice_phase.host_fingerprint(stripe) == \
        jax_slice.host_fingerprint(stripe)
    assert usec >= 1
    # one fingerprint of each device's part: the CPU runs the kernel's
    # plain version, which the wrapper does not count as a launch
    assert fingerprint_u32.launches.count == 0


def test_corruption_is_refused_with_the_jax_text():
    words = 512
    stripe = np.arange(8 * words, dtype=np.uint32).reshape(8, words)
    want_sum, want_xor = slice_phase.host_fingerprint(stripe)
    bad = stripe.copy()
    bad[3, 7] ^= 0xFF  # one word of one shard
    runner = slice_phase.SliceRunner(make_ingest_mesh(slots(8)),
                                     "alltoall", words)
    handle = runner.launch(runner.assemble(
        {d: (torch.from_numpy(bad[d].view(np.int32).copy()), None)
         for d in range(8)}))
    got_sum, got_xor, _ = runner.complete(handle)
    assert (got_sum, got_xor) == slice_phase.host_fingerprint(bad)
    jrunner = jax_slice.SliceRunner(jax_mesh(jax.devices()), "alltoall",
                                    words)
    assert raised(runner.verify, got_sum, got_xor, want_sum, want_xor, 0) \
        == ("SliceFingerprintError", raised(
            jrunner.verify, got_sum, got_xor, want_sum, want_xor, 0)[1])
    with pytest.raises(slice_phase.SliceFingerprintError, match="stripe 0"):
        runner.verify(got_sum, got_xor, want_sum, want_xor, 0)
    runner.verify(want_sum, want_xor, want_sum, want_xor, 0)


@pytest.mark.parametrize("words", [1027, 1028, 4])
def test_alltoall_divisibility_text_equals_the_jax_package(words):
    port = raised(slice_phase.SliceRunner, make_ingest_mesh(slots(8)),
                  "alltoall", words)
    ref = raised(jax_slice.SliceRunner, jax_mesh(jax.devices()),
                 "alltoall", words)
    if isinstance(ref, tuple):
        assert port == ref and "multiple of 32" in port[1]
    else:
        assert not isinstance(port, tuple)


def test_assembly_needs_every_shard():
    runner = slice_phase.SliceRunner(make_ingest_mesh(slots(4)), "host", 8)
    with pytest.raises(ValueError, match="one shard per addressable"):
        runner.assemble({0: (torch.zeros(8, dtype=torch.int32), None)})


def test_slice_shard_assignment_equals_the_jax_package():
    for n_dev in range(1, 9):
        for n_workers in range(1, 5):
            seen = []
            for r in range(n_workers):
                picks = WorkerManager.slice_shard_assignment(
                    n_dev, n_workers, r)
                assert picks == JaxManager.slice_shard_assignment(
                    n_dev, n_workers, r)
                seen += picks
            assert sorted(seen) == list(range(n_dev))


# ----------------------------------------------------------------------
# the sharded ingest step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,batch", [((2, 4), (4, 256)),
                                         ((1, 8), (2, 512)),
                                         ((4, 2), (8, 64))],
                         ids=["2x4", "1x8", "4x2"])
def test_ingest_step_equals_the_jax_package(shape, batch):
    """JAX scrambles shard (h, c) with bits of fold_in(fold_in(key, h),
    c); the port is handed those bits and must give the same scrambled
    shards and global (sum, xor)."""
    rng = np.random.default_rng(sum(batch))
    data = rng.integers(0, 1 << 32, size=batch,
                        dtype=np.uint64).astype(np.uint32)
    key = jax.random.PRNGKey(11)
    jmesh = jax_mesh(jax.devices(), shape=shape)
    jstep, _ = jax_ingest.make_ingest_step(jmesh)
    jscrambled, jsum, jxor = jstep(
        jax_ingest.host_shard_to_devices(jmesh, data.copy()), key)
    jshards = jax_per_device(jscrambled, jmesh)

    mesh = make_ingest_mesh(slots(8), shape=shape)
    shards = ingest.host_shard_to_devices(mesh, data)
    bits = []
    for (h, c), shard in zip(np.ndindex(*shape), shards):
        shard_key = jax.random.fold_in(jax.random.fold_in(key, h), c)
        bits.append(torch.from_numpy(np.asarray(jax.random.bits(
            shard_key, tuple(shard.shape), dtype=jnp.uint32)).view(
                np.int32).copy()))
    scrambled, total, xor = ingest.make_ingest_step(mesh)(shards, bits)
    for d in range(8):
        np.testing.assert_array_equal(u32(scrambled[d]), jshards[d])
    assert (total, xor) == (int(jsum), int(jxor))
    whole = np.asarray(jscrambled)
    assert total == int(whole.sum(dtype=np.uint64)) & MASK
    assert xor == int(np.bitwise_xor.reduce(whole.reshape(-1)))


def test_ingest_step_refuses_a_batch_that_does_not_divide():
    mesh = make_ingest_mesh(slots(8), shape=(2, 4))
    with pytest.raises(ValueError, match="does not divide"):
        ingest.host_shard_to_devices(mesh, np.zeros((3, 8), np.uint32))
    with pytest.raises(ValueError, match="takes 8 shards"):
        ingest.make_ingest_step(mesh)([], [])


# ----------------------------------------------------------------------
# the phase barrier: interrupt and sibling failure
# ----------------------------------------------------------------------

class _FakeWorker:
    def __init__(self, exc):
        self.exc = exc
        self.interrupted = False

    def check_interruption_flag_only(self):
        if self.interrupted:
            raise self.exc("interrupt requested")


@pytest.mark.parametrize("package", ["port", "jax"])
def test_slice_state_interrupt_unblocks_the_barrier(package):
    state_cls, exc = (_SliceState, WorkerInterruptedException) \
        if package == "port" else (JaxSliceState, JaxInterrupted)
    state = state_cls(n_workers=2, n_devices=8)
    worker = _FakeWorker(exc)

    def interrupt_soon():
        time.sleep(0.3)
        worker.interrupted = True

    t = threading.Thread(target=interrupt_soon)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(exc):
        state.wait_consumed(worker, 0)  # never marked: must not hang
    assert time.monotonic() - t0 < 5
    t.join()


def test_slice_state_sibling_failure_equals_the_jax_package():
    port = _SliceState(n_workers=2, n_devices=8)
    ref = JaxSliceState(n_workers=2, n_devices=8)
    texts = []
    for state, exc in ((port, WorkerInterruptedException),
                       (ref, JaxInterrupted)):
        worker = _FakeWorker(exc)
        state.fail(RuntimeError("feeder exploded"))
        state.fail(RuntimeError("a second failure is not reported"))
        texts.append([raised(state.wait_all_published, worker)[1],
                      raised(state.publish, worker, {}, 0, 0)[1],
                      raised(state.wait_consumed, worker, 0)[1]])
    assert texts[0] == texts[1]
    with pytest.raises(SliceAbortError, match="feeder exploded"):
        port.wait_all_published(_FakeWorker(WorkerInterruptedException))


def test_slice_state_folds_the_host_fingerprints():
    state = _SliceState(n_workers=2, n_devices=2)
    worker = _FakeWorker(WorkerInterruptedException)
    state.publish(worker, {0: "a"}, 0xFFFFFFF0, 0x0F)
    state.publish(worker, {1: "b"}, 0x20, 0xF0)
    assert state.wait_all_published(worker) == ({0: "a", 1: "b"}, 0x10, 0xFF)
    assert state.published == 0 and state.shards == {}


# ----------------------------------------------------------------------
# the CLI: TPUSLICE records of both packages
# ----------------------------------------------------------------------

#: record keys of the slice phase that count work, not time
SLICE_KEYS = ("Phase", "NumWorkers", "BytesLast", "EntriesLast",
              "TpuHbmBytes", "ShardIngestMiB", "IciRedistMiB",
              "TpuStreamFusedOps", "TpuH2dStagedOps", "TpuH2dDirectOps")


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_both(flags, tmp_path, name="run"):
    """`flags` through both CLIs, the port over 8 CPU slots, the JAX
    package over its 8 devices, each on its own file; returns (rc, rc,
    JAX records, port records)."""
    jf, pf = tmp_path / f"{name}.jax.json", tmp_path / f"{name}.port.json"
    jrc = jax_main([f.replace("--gpu", "--tpu") for f in flags]
                   + ["--tpuids", IDS, "--nolive", "--jsonfile", str(jf),
                      str(tmp_path / "jax.bin")])
    prc = port_main(flags + ["--gpuids", IDS, "--nolive", "--jsonfile",
                             str(pf), str(tmp_path / "port.bin")],
                    device="cpu")
    jrecs = records(jf) if jf.exists() else []
    precs = records(pf) if pf.exists() else []
    return jrc, prc, jrecs, precs


def slice_record(recs):
    return next(r for r in recs if r["Phase"] == "TPUSLICE")


def assert_same_slice_record(jrec, prec):
    assert {k: prec[k] for k in SLICE_KEYS} == \
        {k: jrec[k] for k in SLICE_KEYS}
    assert {k: v["Bytes"] for k, v in prec["TpuPerChip"].items()} == \
        {k: v["Bytes"] for k, v in jrec["TpuPerChip"].items()}
    for rec in (jrec, prec):
        assert rec["IciRedistUSec"] > 0 and rec["IciGbpsHwm"] > 0
    assert prec["EntLatHisto"]["LatNumValues"] == \
        jrec["EntLatHisto"]["LatNumValues"] == prec["EntriesLast"]
    assert prec["IOLatHisto"]["LatNumValues"] == \
        jrec["IOLatHisto"]["LatNumValues"]
    assert prec["Device"] == "cpu"
    assert set(prec) - set(jrec) == {"Device"}


@pytest.mark.parametrize("spec", SPECS)
def test_cli_slice_record_equals_the_jax_package(tmp_path, spec):
    jrc, prc, jrecs, precs = run_both(
        ["-w", "--gpuslice", "-t", "2", "-s", "4M", "-b", "128K",
         "--redistspec", spec], tmp_path)
    assert jrc == prc == 0
    assert [r["Phase"] for r in precs] == [r["Phase"] for r in jrecs] \
        == ["WRITE", "TPUSLICE"]
    prec, jrec = slice_record(precs), slice_record(jrecs)
    assert_same_slice_record(jrec, prec)
    # 4M / (8 devices x 128K) = 4 stripes, every byte ingested once and
    # redistributed once; two workers with a device context each
    assert prec["EntriesLast"] == 4
    assert prec["TpuHbmBytes"] == 4 << 20
    assert prec["ShardIngestMiB"] == prec["IciRedistMiB"] == 4
    assert {k: v["Bytes"] for k, v in prec["TpuPerChip"].items()} == \
        {"0": 2 << 20, "1": 2 << 20}


def test_cli_slice_without_device_contexts_equals_the_jax_package(
        tmp_path):
    """Without --gpuids/--tpuids on the workers, the per-device rows come
    from the feeders: one per mesh device. The port's mesh is then one
    CPU slot, so compare against the JAX package restricted to one
    device by --meshshape 1x1 on --tpuids 0."""
    target = tmp_path / "f.bin"
    jf, pf = tmp_path / "jax.json", tmp_path / "port.json"
    assert port_main(["-w", "--gpuslice", "-t", "2", "-s", "1M", "-b",
                      "64K", "--nolive", "--jsonfile", str(pf),
                      str(target)], device="cpu") == 0
    prec = slice_record(records(pf))
    assert prec["EntriesLast"] == 16 and prec["TpuHbmBytes"] == 1 << 20
    assert {k: v["Bytes"] for k, v in prec["TpuPerChip"].items()} == \
        {"0": 1 << 20}
    assert prec["Device"] == "cpu" and prec["NumWorkers"] == 1
    assert jax_main(["--tpuslice", "-t", "2", "-s", "1M", "-b", "64K",
                     "--tpuids", "0", "--nolive", "--jsonfile", str(jf),
                     str(target)]) == 0
    jrec = slice_record(records(jf))
    assert (jrec["EntriesLast"], jrec["TpuHbmBytes"], jrec["NumWorkers"]) \
        == (prec["EntriesLast"], prec["TpuHbmBytes"], 1)


@pytest.mark.parametrize("stream", ["on", "off"])
def test_cli_slice_fused_ring_and_python_reader(tmp_path, monkeypatch,
                                                capsys, stream):
    if stream == "on":
        jax_engine(monkeypatch)
    jrc, prc, jrecs, precs = run_both(
        ["-w", "--gpuslice", "-t", "2", "-s", "2M", "-b", "64K",
         "--gpustream", stream, "--iodepth", "2"], tmp_path)
    assert jrc == prc == 0
    assert_same_slice_record(slice_record(jrecs), slice_record(precs))
    out = capsys.readouterr().out
    assert ("slice ingest ring engaged" in out) == (stream == "on")


def test_cli_slice_budget_breach_fails_on_both_sides(tmp_path, capsys):
    assert run_both(["-w", "-t", "2", "-s", "2M", "-b", "64K"],
                    tmp_path, "write")[:2] == (0, 0)
    jrc, prc, jrecs, precs = run_both(
        ["--gpuslice", "-t", "2", "-s", "2M", "-b", "64K", "--gpubudget",
         "1"], tmp_path, "slice")
    assert jrc == prc == 1
    assert jrecs == precs == []
    err = capsys.readouterr().err
    assert "--gpubudget exceeded" in err and "--tpubudget exceeded" in err


def test_cli_slice_meshshape(tmp_path, capsys):
    jrc, prc, jrecs, precs = run_both(
        ["-w", "--gpuslice", "-t", "2", "-s", "2M", "-b", "64K",
         "--meshshape", "4x2", "--redistspec", "host"], tmp_path)
    assert jrc == prc == 0
    assert_same_slice_record(slice_record(jrecs), slice_record(precs))
    assert "slice mesh 4x2" in capsys.readouterr().out
    jrc, prc, _, _ = run_both(
        ["--gpuslice", "-t", "1", "-s", "2M", "-b", "64K", "--meshshape",
         "3x3"], tmp_path, "3x3")
    assert jrc == prc == 1
    err = capsys.readouterr().err
    assert err.count("--meshshape 3x3 does not fit 8 device(s): the "
                     "\"host\" axis of size 3 requires hosts*chips == 8") \
        >= 2


@pytest.mark.parametrize("args,text", [
    (["-w", "-s", "1M", "--meshshape", "2x4"],
     "--meshshape shapes the --gpuslice mesh — it does nothing without "
     "--gpuslice"),
    (["-w", "--gpuslice", "-s", "1M", "--meshshape", "nope"],
     "--meshshape must be HOSTSxCHIPS (e.g. 2x4), got 'nope'"),
    (["-w", "-s", "1M", "--redistspec", "host"],
     "--redistspec shapes the --gpuslice redistribution target — it does "
     "nothing without --gpuslice"),
    (["-w", "--gpuslice", "-s", "1M", "--redistspec", "bogus"],
     "--redistspec must be one of alltoall|host|chip|replicate"),
    (["-w", "--gpuslice", "-s", "1M", "-b", "6"],
     "--gpuslice shards are uint32 arrays: --block must be a multiple of "
     "4 bytes"),
], ids=["meshshape-alone", "meshshape-bad", "redistspec-alone",
        "redistspec-bad", "block"])
def test_config_texts_equal_the_jax_package(tmp_path, capsys, args, text):
    target = str(tmp_path / "f.bin")
    assert jax_main([a.replace("--gpu", "--tpu") for a in args]
                    + ["--nolive", target]) == 1
    jax_err = capsys.readouterr().err
    assert port_main(args + ["--nolive", target], device="cpu") == 1
    port_err = capsys.readouterr().err
    assert text in port_err
    assert text.replace("--gpu", "--tpu") in jax_err


def test_cli_slice_on_a_directory_is_refused(tmp_path, capsys):
    assert port_main(["--gpuslice", "-s", "1M", str(tmp_path)],
                     device="cpu") == 1
    assert "--gpuslice requires file/blockdev bench paths" \
        in capsys.readouterr().err


def test_slice_phase_needs_cuda_without_device_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """Without device="cpu" the phase runs on CUDA devices, and raises
    where there are none: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA devices"):
        make_ingest_mesh()
    target = str(tmp_path / "f.bin")
    assert port_main(["-w", "-s", "1M", "-b", "64K", "--nolive",
                      target], device="cpu") == 0
    assert port_main(["--gpuslice", "-s", "1M", "-b", "64K", "--nolive",
                      target]) == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_summarize_json_reads_the_ports_slice_record(tmp_path):
    """tools/elbencho-tpu-summarize-json shows the port's TPUSLICE record
    with the slice columns, as it does the JAX package's."""
    pf = tmp_path / "port.json"
    assert port_main(["-w", "--gpuslice", "-t", "2", "-s", "2M", "-b",
                      "64K", "--gpuids", IDS, "--nolive", "--jsonfile",
                      str(pf), str(tmp_path / "f.bin")], device="cpu") == 0
    rec = slice_record(records(pf))
    out = subprocess.run(
        [sys.executable, "tools/elbencho-tpu-summarize-json", "--csv",
         str(pf)], capture_output=True, text=True,
        cwd=str(__import__("pathlib").Path(__file__).parent.parent))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    header = lines[0].split(",")
    row = next(ln for ln in lines[1:] if "TPUSLICE" in ln).split(",")
    cols = dict(zip(header, row))
    assert cols["ShardMiB"] == str(rec["ShardIngestMiB"]) == "2"
    assert cols["IciMiB"] == str(rec["IciRedistMiB"]) == "2"
    assert float(cols["IciGbps"]) == rec["IciGbpsHwm"] > 0
