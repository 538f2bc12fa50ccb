"""The port's collective --gpubench patterns (device="cpu", one CPU slot
per --gpuids id) against the JAX package's --tpubench collectives on its
virtual CPU devices.

For each of ici, allgather, reducescatter, alltoall and psum, at
tolerance 0: the TPUBENCH records' bytes and ops, the NOTE of a block
size that is padded, one step's output on the same numpy input against
the JAX package's jitted step (and the ring permute's state after
several steps), and a --gpuids subset of the devices. ``ici`` and
``alltoall`` run the copies they run on the card; the reductions write
the buffers NCCL writes there, and each device's buffer is held against
what that collective leaves on each device.
"""

import jax
import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.workers.tpubench import CollectiveBench as JaxBench
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.workers.gpubench import (CUDA_ROUTES,
                                                 CollectiveBench,
                                                 collective_plain)
from test_torch_dirmode import records

torch.set_num_threads(1)

PATTERNS = ("ici", "allgather", "reducescatter", "alltoall", "psum")
IDS = ",".join(str(i) for i in range(8))
#: counts of a TPUBENCH record that do not depend on timing
KEYS = ("Phase", "NumWorkers", "BytesLast", "TpuHbmBytes", "EntriesLast",
        "TpuH2dStagedOps", "TpuD2hStagedOps", "TpuStreamFusedOps")


def run_both(pattern, flags, tmp_path, capsys, ids=IDS):
    """One --gpubench run of `pattern` through each CLI; returns (JAX
    record, port record, JAX stdout, port stdout)."""
    jf, pf = tmp_path / "jax.json", tmp_path / "port.json"
    args = ["--gpubench", "--gpubenchpat", pattern, *flags, "--nolive"]
    assert jax_main([a.replace("--gpu", "--tpu") for a in args]
                    + ["--tpuids", ids, "--jsonfile", str(jf)]) == 0
    jax_out = capsys.readouterr().out
    assert port_main(args + ["--gpuids", ids, "--jsonfile", str(pf)],
                     device="cpu") == 0
    port_out = capsys.readouterr().out
    (jrec,), (prec,) = records(jf), records(pf)
    return jrec, prec, jax_out, port_out


def assert_same_record(jrec, prec):
    assert {k: prec[k] for k in KEYS} == {k: jrec[k] for k in KEYS}
    assert prec["IOLatHisto"]["LatNumValues"] == \
        jrec["IOLatHisto"]["LatNumValues"]
    assert prec["Device"] == "cpu"
    assert set(prec) - set(jrec) == {"Device"}


def note_lines(out):
    return [ln.split(" ", 2)[2] for ln in out.splitlines() if "NOTE" in ln]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_records_equal_the_jax_package(tmp_path, capsys, pattern):
    """-s 64K -b 4K over 8 devices: 1024 words a device, 32 KiB a step,
    two steps, driven by the first of two workers only."""
    jrec, prec, _, port_out = run_both(
        pattern, ["-t", "2", "-s", "64K", "-b", "4K"], tmp_path, capsys)
    assert_same_record(jrec, prec)
    assert prec["BytesLast"] == prec["TpuHbmBytes"] == 2 * 8 * 4096
    assert prec["IOLatHisto"]["LatNumValues"] == 2
    assert prec["NumWorkers"] == 1
    route = "peer copies" if pattern in ("ici", "alltoall") else "torch ops"
    assert f"collective {pattern} over 8 device(s): {route}" in port_out


@pytest.mark.parametrize("pattern", PATTERNS)
def test_padding_note_equals_the_jax_package(tmp_path, capsys, pattern):
    """-b 1000 is 250 words, padded to 256 (divisible by 8 devices): the
    NOTE and the accounted bytes are the JAX package's."""
    jrec, prec, jax_out, port_out = run_both(
        pattern, ["-s", "8K", "-b", "1000"], tmp_path, capsys)
    assert_same_record(jrec, prec)
    want = ("NOTE: collective block size adjusted to 1024 bytes "
            "(word-aligned and divisible by 8 chips); accounted bytes per "
            "step use the adjusted size")
    assert note_lines(port_out) == note_lines(jax_out) == [want]
    assert prec["BytesLast"] == 8 * 1024  # one step: 8 devices x 1024


@pytest.mark.parametrize("pattern", PATTERNS)
def test_one_step_equals_the_jax_step(pattern):
    """The same random (8, 1024) uint32 input through JAX's jitted step
    and the port's step; the ring permute also after three steps."""
    words = 1024
    data = np.random.default_rng(len(pattern)).integers(
        0, 1 << 32, size=(8, words), dtype=np.uint64).astype(np.uint32)
    jbench = JaxBench(pattern, jax.devices(), 4 * words)
    jarr = jax.device_put(data, jbench._arr.sharding)
    jout = jbench._jit_step(jarr)
    bench = CollectiveBench(pattern, [torch.device("cpu")] * 8, 4 * words)
    assert (bench.bytes_per_step, bench.block_size_adjusted) == \
        (jbench.bytes_per_step, jbench.block_size_adjusted)
    bench.arrays = [torch.from_numpy(row.view(np.int32).copy())
                    for row in data]
    out = bench.compute()
    if pattern == "ici":
        np.testing.assert_array_equal(
            np.stack([t.numpy().view(np.uint32) for t in out]),
            np.asarray(jout))
        plain = collective_plain(pattern, bench.arrays)
        assert all(torch.equal(o, p) for o, p in zip(out, plain))
        np.testing.assert_array_equal(np.asarray(jout),
                                      np.roll(data, 1, axis=0))
        jbench._arr = jarr
        for _ in range(3):
            jbench.step()
            bench.step()
        np.testing.assert_array_equal(
            np.stack([t.numpy().view(np.uint32) for t in bench.arrays]),
            np.asarray(jbench._arr))
    else:
        assert out == int(jout)
        assert out == collective_plain(pattern, bench.arrays)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_per_device_buffers_are_what_each_collective_leaves(pattern):
    """One step over 4 CPU slots of 8 random words each: each device's
    output buffer holds what the collective leaves on that device (the
    shapes NCCL writes on the card), in numpy by hand."""
    data = np.random.default_rng(3).integers(
        0, 1 << 32, size=(4, 8), dtype=np.uint64).astype(np.uint32)
    bench = CollectiveBench(pattern, [torch.device("cpu")] * 4, 4 * 128)
    bench.arrays = [torch.from_numpy(r.view(np.int32).copy()) for r in data]
    out = bench.compute()
    got = [o.numpy().view(np.uint32)
           for o in (out if pattern == "ici" else bench._outs)]
    total = data.sum(axis=0, dtype=np.uint64).astype(np.uint32)
    want = {"ici": lambda i: data[(i - 1) % 4],
            "allgather": lambda i: data.reshape(-1),
            "reducescatter": lambda i: total[2 * i:2 * i + 2],
            "alltoall": lambda i: data[:, 2 * i:2 * i + 2].reshape(-1),
            "psum": lambda i: total}[pattern]
    for i in range(4):
        np.testing.assert_array_equal(got[i], want(i))
    if pattern != "ici":
        assert out == collective_plain(pattern, bench.arrays)


def test_outputs_are_what_each_collective_computes():
    """The plain versions on a small input, by hand: S is the uint32 sum
    of every word; allgather and psum replicate it to every device (n*S),
    reducescatter and alltoall move every word once (S)."""
    data = np.arange(1, 4 * 8 + 1, dtype=np.uint32).reshape(4, 8) * 1000003
    arrays = [torch.from_numpy(r.view(np.int32).copy()) for r in data]
    s = int(data.sum(dtype=np.uint64)) & 0xFFFFFFFF
    assert collective_plain("allgather", arrays) == (4 * s) & 0xFFFFFFFF
    assert collective_plain("psum", arrays) == (4 * s) & 0xFFFFFFFF
    assert collective_plain("reducescatter", arrays) == s
    assert collective_plain("alltoall", arrays) == s
    permuted = collective_plain("ici", arrays)
    assert [t.tolist() for t in permuted] == \
        [arrays[3].tolist()] + [a.tolist() for a in arrays[:3]]
    with pytest.raises(ValueError, match="not a collective pattern"):
        collective_plain("h2d", arrays)
    assert set(CUDA_ROUTES) == set(PATTERNS)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_gpuids_subset_equals_the_jax_package(tmp_path, capsys, pattern):
    """--gpuids 0,2,4 against --tpuids 0,2,4: a mesh of three devices,
    and 1024 words padded to 1026 to divide by three."""
    jrec, prec, jax_out, port_out = run_both(
        pattern, ["-s", "24K", "-b", "4K"], tmp_path, capsys, ids="0,2,4")
    assert_same_record(jrec, prec)
    assert prec["BytesLast"] == 2 * 3 * 4104
    want = ("NOTE: collective block size adjusted to 4104 bytes "
            "(word-aligned and divisible by 3 chips); accounted bytes per "
            "step use the adjusted size")
    assert want in note_lines(port_out) and want in note_lines(jax_out)
    assert "over 3 device(s)" in port_out
