"""File mode over several files and block devices: the port's CLI
(device="cpu") against the JAX package's CLI.

A worker's offsets run over one range of len(paths) x file size, and
offset o lands at o % size in file o // size. Both packages must write
the same bytes into every file, count the same work in the WRITE, STAT,
READ and RMFILES records, and read each other's files under --verify.
Block devices cannot be made here, so a regular file is made to look like
one to both packages (stat.S_ISBLK) and its size comes from lseek, as a
device's would. Tolerance 0 throughout.
"""

import stat

import pytest
import torch

from test_torch_dirmode import (_jax_python_loop, _error_line,  # noqa: F401
                                assert_same_counts, run_both, run_jax,
                                run_port)

torch.set_num_threads(1)

STRIPE_WORKLOAD = ["-s", "64K", "-b", "4K", "--iodepth", "2",
                   "--verify", "7"]


def stripe_paths(tmp_path, prefix, count=4):
    return [tmp_path / f"{prefix}-f{i}" for i in range(count)]


@pytest.mark.parametrize("flags", [["-t", "2"], ["-t", "3"],
                                   ["-t", "1", "--rand"]],
                         ids=["seq-2-threads", "seq-3-threads", "rand"])
def test_striped_files_and_counts_equal_the_jax_package(tmp_path, flags):
    jax_paths = stripe_paths(tmp_path, "jax")
    port_paths = stripe_paths(tmp_path, "port")
    jax_recs, port_recs = run_both(
        ["-w", "--stat", "-r", "-F", "--gpuverify", *flags,
         *STRIPE_WORKLOAD], jax_paths, port_paths, tmp_path, "stripe")
    assert [r["Phase"] for r in port_recs] == \
        ["WRITE", "STAT", "READ", "RMFILES"]
    threads = int(flags[1])
    assert_same_counts(jax_recs, port_recs, threads, rand="--rand" in flags)
    write, stat_rec, read, delete = port_recs
    assert write["BytesLast"] == read["BytesLast"] \
        == read["TpuHbmBytes"] == 4 * (64 << 10)
    # one device copy per block read; three workers' slices of the 256K
    # range are not block multiples, so their blocks are cut (66, not 64)
    assert read["TpuH2dStagedOps"] == read["IOLatHisto"]["LatNumValues"] \
        == (66 if threads == 3 else 4 * 16)
    # every worker stats every path; the deletes go round-robin
    assert stat_rec["EntriesLast"] == 4 * threads
    assert delete["EntriesLast"] == 4
    assert not any(p.exists() for p in jax_paths + port_paths)


def test_each_package_reads_the_others_striped_files(tmp_path):
    jax_paths = stripe_paths(tmp_path, "jax")
    port_paths = stripe_paths(tmp_path, "port")
    flags = ["-t", "2", *STRIPE_WORKLOAD]
    assert run_jax(["-w", *flags], jax_paths) == 0
    assert run_port(["-w", *flags], port_paths) == 0
    for jp, pp in zip(jax_paths, port_paths):
        assert pp.read_bytes() == jp.read_bytes()
        assert len(pp.read_bytes()) == 64 << 10
    # the stripe mapping: file k holds the verify pattern of its own
    # offsets 0..size, so its first word is offset 0 + salt
    assert all(p.read_bytes()[:8] == (7).to_bytes(8, "little")
               for p in port_paths)
    assert run_port(["-r", "--gpuverify", *flags], jax_paths) == 0
    assert run_port(["-r", *flags], jax_paths) == 0
    assert run_jax(["-r", "--gpuverify", *flags], port_paths) == 0


def test_flipped_byte_in_the_third_file_names_its_offset(tmp_path, capsys):
    paths = stripe_paths(tmp_path, "port")
    flags = ["-t", "2", *STRIPE_WORKLOAD]
    assert run_port(["-w", *flags], paths) == 0
    data = bytearray(paths[2].read_bytes())
    data[(3 << 12) + 100] ^= 0x01
    paths[2].write_bytes(bytes(data))
    capsys.readouterr()
    assert run_port(["-r", "--gpuverify", *flags], paths) == 1
    assert "on-device integrity check failed for block at offset 12288" \
        in capsys.readouterr().err


@pytest.fixture
def files_look_like_block_devices(monkeypatch):
    """Regular files are block devices to both packages' path typing."""
    is_blk = stat.S_ISBLK
    monkeypatch.setattr(stat, "S_ISBLK",
                        lambda mode: is_blk(mode) or stat.S_ISREG(mode))


def _fake_bdevs(tmp_path, prefix, sizes):
    paths = stripe_paths(tmp_path, prefix, len(sizes))
    for p, size in zip(paths, sizes):
        p.write_bytes(bytes(size))
    return paths


def test_blockdev_size_is_detected_and_striped(
        tmp_path, capsys, files_look_like_block_devices):
    # the smallest device sets the size: 32K of each
    sizes = [48 << 10, 32 << 10, 40 << 10]
    jax_paths = _fake_bdevs(tmp_path, "jax", sizes)
    port_paths = _fake_bdevs(tmp_path, "port", sizes)
    capsys.readouterr()
    jax_recs, port_recs = run_both(
        ["-w", "-r", "-t", "2", "-b", "4K", "--iodepth", "2", "--verify",
         "7", "--gpuverify"], jax_paths, port_paths, tmp_path, "bdev")
    notes = [ln.split(" ", 2)[2] for ln in capsys.readouterr().out
             .splitlines() if "NOTE: Setting file size" in ln]
    assert notes == ["NOTE: Setting file size to block dev size: 32768"] * 2
    assert_same_counts(jax_recs, port_recs, threads=2)
    assert port_recs[1]["BytesLast"] == 3 * (32 << 10)
    for jp, pp in zip(jax_paths, port_paths):
        assert pp.read_bytes() == jp.read_bytes()


def test_blockdev_size_smaller_than_s_is_refused_as_by_the_jax_package(
        tmp_path, capsys, files_look_like_block_devices):
    paths = _fake_bdevs(tmp_path, "dev", [16 << 10, 16 << 10])
    capsys.readouterr()
    assert run_jax(["-r", "-s", "64K"], paths) == 1
    jax_err = _error_line(capsys.readouterr().err)
    assert run_port(["-r", "-s", "64K"], paths) == 1
    port_err = _error_line(capsys.readouterr().err)
    assert port_err == jax_err == (
        "given size to use is larger than detected block device size. "
        "Detected size: 16384; Given size: 65536")


def test_read_only_size_larger_than_a_file_is_refused(tmp_path, capsys):
    """The size probe looks at every path, not only the first."""
    paths = stripe_paths(tmp_path, "f", 2)
    paths[0].write_bytes(bytes(64 << 10))
    paths[1].write_bytes(bytes(16 << 10))
    capsys.readouterr()
    assert run_jax(["-r", "-s", "64K"], paths) == 1
    jax_err = _error_line(capsys.readouterr().err)
    assert run_port(["-r", "-s", "64K"], paths) == 1
    assert _error_line(capsys.readouterr().err) == jax_err
    assert "Detected size: 16384" in jax_err
