"""The port's multi-device dry run (``entry.dryrun_multigpu``) and its
measured slice capture (``entry.capture_multigpu``) on CPU slots, against
the JAX package's ``__graft_entry__`` passes and ``bench.capture_multichip``
at tolerance 0: the ingest step's shards and fingerprints, the shard
placement of ``host_shard_to_devices``, the collectives against their
plain version, and the capture's record-shape keys."""

import json

import jax
import numpy as np
import pytest
import torch

from elbencho_tpu.cli import main as jax_main
from elbencho_tpu.parallel import ingest as jax_ingest
from elbencho_tpu.parallel.mesh import make_ingest_mesh as jax_mesh
from elbencho_tpu_torch import entry
from elbencho_tpu_torch.cli import main as port_main
from elbencho_tpu_torch.parallel import ingest
from elbencho_tpu_torch.parallel.mesh import make_ingest_mesh
from test_torch_slice import assert_same_slice_record, records, slice_record

torch.set_num_threads(1)

PASS_LINES = ("dryrun_multigpu pass 1:", "dryrun_multigpu pass 2:",
              "dryrun_multigpu pass 3:", "dryrun_multigpu pass 4:",
              "MULTIGPU_MEASURED ")


def measured_line(out: str) -> dict:
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("MULTIGPU_MEASURED ")]
    return json.loads(line.split(" ", 1)[1])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_passes_on_cpu_slots(n, tmp_path, capsys):
    measured = entry.dryrun_multigpu(n, device="cpu", work_dir=str(tmp_path))
    out = capsys.readouterr().out
    for head in PASS_LINES:
        assert head in out, head
    # pass 3 names every pattern, each over all n slots on the CPU
    for pattern in ("ici", "allgather", "reducescatter", "alltoall",
                    "psum"):
        assert f"pass 3: {pattern} over " in out
        assert "one step equals the plain version" in out
    assert "no kernel is built on the CPU" in out
    assert measured_line(out) == measured
    assert measured["tier"] == "cpu_slots" and measured["n_devices"] == n
    assert measured["metric"].startswith("MULTIGPU slice (cpu_slots, NOT")
    # 4 MiB in stripes of n x 128 KiB, every byte ingested and moved once
    assert measured["stripes"] == 32 // n
    assert measured["shard_ingest_mib"] == measured["ici_redist_mib"] == 4
    assert measured["per_chip_bytes"] == {str(d): (4 << 20) // n
                                          for d in range(n)}
    assert measured["value"] > 0 and measured["ici_redist_usec"] > 0
    assert list(tmp_path.iterdir()) == []  # the capture cleans up


def flipping_step(monkeypatch, at_call: int):
    """Patch make_ingest_step so that the step it builds at its
    ``at_call``-th call flips one word of shard 0's output."""
    real = ingest.make_ingest_step
    calls = {"n": 0}

    def make(mesh):
        calls["n"] += 1
        step = real(mesh)
        if calls["n"] != at_call:
            return step

        def flipped(shards, bits):
            out, total, xor = step(shards, bits)
            out[0].view(-1)[3] ^= 1 << 9
            return out, total, xor
        return flipped

    monkeypatch.setattr(ingest, "make_ingest_step", make)


@pytest.mark.parametrize("at_call,name", [(1, "pass 1"), (2, "pass 2"),
                                          (3, "pass 2")])
def test_a_flipped_word_fails_the_pass_that_made_it(monkeypatch, at_call,
                                                    name):
    flipping_step(monkeypatch, at_call)
    with pytest.raises(entry.DryRunError,
                       match=f"dryrun_multigpu {name}: shard 0 .*numpy"):
        entry.dryrun_multigpu(4, device="cpu")


def test_a_wrong_global_fingerprint_fails_the_pass(monkeypatch):
    real = ingest.make_ingest_step

    def make(mesh):
        step = real(mesh)
        return lambda shards, bits: (lambda o, s, x: (o, s ^ 1, x))(
            *step(shards, bits))

    monkeypatch.setattr(ingest, "make_ingest_step", make)
    with pytest.raises(entry.DryRunError,
                       match=r"pass 1: global \(sum, xor\)"):
        entry.dryrun_multigpu(2, device="cpu")


@pytest.mark.parametrize("call", ["dryrun", "capture", "slots"])
def test_without_device_and_without_cuda_it_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"dryrun": lambda: entry.dryrun_multigpu(2),
          "capture": lambda: entry.capture_multigpu(2, "2M", "64K"),
          "slots": lambda: entry.mesh_slots(2)}[call]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()


def test_mesh_slots_on_the_cpu_and_a_bad_device():
    assert entry.mesh_slots(3, device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="at least one slot"):
        entry.mesh_slots(0, device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        entry.mesh_slots(2, device="meta")


def test_capture_equals_the_jax_capture_on_the_record_shape_keys(tmp_path):
    import bench
    jax_cap = bench.capture_multichip(8, "2M", "64K")
    port_cap = entry.capture_multigpu(8, "2M", "64K", device="cpu",
                                      work_dir=str(tmp_path))
    assert jax_cap["value"] is not None and port_cap["value"] is not None
    assert set(port_cap) == set(jax_cap)
    for key in ("n_devices", "unit", "redist_spec", "shard_ingest_mib",
                "ici_redist_mib", "stripes", "per_chip_bytes"):
        assert port_cap[key] == jax_cap[key], key
    assert port_cap["stripes"] == 4 and port_cap["shard_ingest_mib"] == 2
    assert port_cap["tier"] == "cpu_slots"
    assert jax_cap["tier"] == "virtual_cpu_mesh"


@pytest.mark.parametrize("n", [1, 2, 4])
def test_a_capture_over_fewer_cards_than_the_host_has_one_row_each(
        monkeypatch, tmp_path, n):
    """With more cards than n the capture names --gpuids 0..n-1: the
    record's per-device rows, one per worker's card, are then the n mesh
    devices. The CLI runs on CPU slots standing for the cards."""
    import elbencho_tpu_torch.cli as cli
    argvs, real_main = [], cli.main

    def on_cpu_slots(argv, device=None):
        argvs.append(argv)
        return real_main(argv, device="cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(entry, "_card_label", lambda: "a card, 700 W")
    monkeypatch.setattr(cli, "main", on_cpu_slots)
    cap = entry.capture_multigpu(n, "1M", "64K", work_dir=str(tmp_path))
    ids = argvs[0][argvs[0].index("--gpuids") + 1]
    assert ids == ",".join(map(str, range(n)))
    assert cap["value"] is not None and cap["tier"] == "cuda_devices"
    assert cap["n_devices"] == len(cap["per_chip_bytes"]) == n
    assert sum(cap["per_chip_bytes"].values()) == 1 << 20
    assert len(set(cap["per_chip_bytes"].values())) == 1


def test_a_failed_capture_run_returns_no_value(tmp_path):
    cap = entry.capture_multigpu(2, "1M", "3", device="cpu",
                                 work_dir=str(tmp_path))
    assert cap["value"] is None and "exited 1" in cap["error"]
    assert cap["tier"] == "cpu_slots" and cap["n_devices"] == 2


def test_a_meshshape_without_ids_spans_as_many_cpu_slots(tmp_path):
    """The capture's CPU mesh: --gpuslice --meshshape 2x4 without --gpuids
    runs over 8 CPU slots, one per-device row each, as the JAX package's
    8 virtual devices do without --tpuids."""
    flags = ["-w", "--gpuslice", "-t", "2", "-s", "4M", "-b", "128K",
             "--meshshape", "2x4", "--nolive"]
    jf, pf = tmp_path / "jax.json", tmp_path / "port.json"
    assert jax_main([f.replace("--gpu", "--tpu") for f in flags]
                    + ["--jsonfile", str(jf), str(tmp_path / "j.bin")]) == 0
    assert port_main(flags + ["--jsonfile", str(pf),
                              str(tmp_path / "p.bin")], device="cpu") == 0
    prec, jrec = slice_record(records(pf)), slice_record(records(jf))
    assert_same_slice_record(jrec, prec)
    assert {k: v["Bytes"] for k, v in prec["TpuPerChip"].items()} == \
        {str(d): 512 << 10 for d in range(8)}


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_shard_placement_equals_the_jax_package(shape):
    """host_shard_to_devices of both packages place one numpy batch
    identically, shard by shard, at each mesh position."""
    hosts, chips = shape
    n = hosts * chips
    rows, cols = hosts * 24, chips * 40
    batch = np.random.default_rng(3).integers(
        0, 1 << 32, size=(rows, cols), dtype=np.uint64).astype(np.uint32)
    jmesh = jax_mesh(jax.devices("cpu")[:n], shape=shape)
    pmesh = make_ingest_mesh([torch.device("cpu")] * n, shape=shape)
    placed = jax_ingest.host_shard_to_devices(jmesh, batch)
    by_device = {s.device: np.asarray(s.data)
                 for s in placed.addressable_shards}
    port = ingest.host_shard_to_devices(pmesh, batch)
    assert len(port) == len(by_device) == n
    for pos, jdev in enumerate(jmesh.devices.flat):
        got = port[pos].numpy().view(np.uint32)
        assert got.shape == by_device[jdev].shape
        assert np.array_equal(got, by_device[jdev]), pos


def test_the_build_cache_check_fails_where_a_fresh_process_finds_no_kernel(
        monkeypatch, tmp_path):
    """Pass 2's check on the card: a child process must load the kernel
    from _build/ as cached. Here no kernel was ever built (no nvcc), so
    the child fails and the check raises naming pass 2."""
    from elbencho_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(entry.DryRunError,
                       match="pass 2: a fresh process did not reuse"):
        entry._build_cache_check()
