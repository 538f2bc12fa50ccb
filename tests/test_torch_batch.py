"""--gpubatch, the port's host->device aggregation ring, against the JAX
package's --tpubatch: the same reads must make the same number of copies
(a partial last batch included), flush once per dir-mode file, land the
same bytes on the device, clamp to the same memory budget with the same
NOTE lines, and be refused with --gpuverify in the same words. Also the
speculative verify-pattern ring of the write path, which a dir-mode
--rand run drove into a fault of the port. Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

from elbencho_tpu.tpu.device import TpuWorkerContext
from elbencho_tpu_torch.cuda.device import CudaWorkerContext
from test_torch_dirmode import (_error_line, _jax_python_loop,  # noqa: F401
                                assert_same_counts, make_dirs, run_both,
                                run_jax, run_port)

torch.set_num_threads(1)


def _notes(text, word):
    """NOTE lines that mention `word`, without their timestamps."""
    return [ln.split(" ", 2)[2] for ln in text.splitlines()
            if "NOTE:" in ln and word in ln]


# name: (flags, file size, H2D copies of the read)
READ_CASES = {
    # -b 6: a block gives one whole word, the span is rounded up to 5
    # words, so a batch closes after 5 blocks, not 3: 10 blocks, 2 copies
    "b6-batch3": (["-t", "1", "-b", "6", "--gpubatch", "3"], 60, 2),
    "partial-last-batch": (["-t", "1", "-b", "4K", "--gpubatch", "3"],
                           40 << 10, 4),
    "two-threads-iodepth2": (["-t", "2", "-b", "4K", "--gpubatch", "3",
                              "--iodepth", "2"], 40 << 10, 4),
    "direct": (["-t", "2", "-b", "4K", "--gpubatch", "4", "--gpudirect",
                "--iodepth", "2"], 40 << 10, 4),
    "unbatched": (["-t", "2", "-b", "4K"], 40 << 10, 10),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_batched_read_copies_equal_the_jax_package(tmp_path, case):
    flags, size, copies = READ_CASES[case]
    path = tmp_path / "data.bin"
    path.write_bytes(np.random.default_rng(5).integers(
        0, 256, size, dtype=np.uint8).tobytes())
    jax_recs, port_recs = run_both(["-r", *flags], [path], [path], tmp_path,
                                   "read")
    assert_same_counts(jax_recs, port_recs, threads=int(flags[1]))
    (read,) = port_recs
    assert read["TpuHbmBytes"] == read["BytesLast"] == size
    key = "TpuH2dDirectOps" if "--gpudirect" in flags else "TpuH2dStagedOps"
    assert read[key] == copies
    assert read["TpuH2dDirectOps"] + read["TpuH2dStagedOps"] == copies


def test_a_batch_never_spans_two_dir_mode_files(tmp_path):
    """The batch is flushed at the end of each file's block loop: 5
    blocks per file at --gpubatch 2 are 3 copies (2, 2, 1) per file."""
    jax_dirs = make_dirs(tmp_path, "jax", 1)
    port_dirs = make_dirs(tmp_path, "port", 1)
    jax_recs, port_recs = run_both(
        ["-d", "-w", "-r", "-t", "2", "-n", "1", "-N", "3", "-s", "20K",
         "-b", "4K", "--gpubatch", "2", "--verify", "7"],
        jax_dirs, port_dirs, tmp_path, "dirbatch")
    assert_same_counts(jax_recs, port_recs, threads=2)
    read = port_recs[-1]
    assert read["Phase"] == "READ" and read["EntriesLast"] == 6
    assert read["TpuH2dStagedOps"] == 6 * 3


def _ingested(ctx) -> bytes:
    """The bytes of a context's last device copy."""
    arr = ctx._last_ingested
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy().tobytes()
    return np.asarray(arr).tobytes()


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("block_size,batch", [(6, 3), (4096, 3), (4100, 4)])
def test_batched_bytes_on_the_device_equal_the_jax_packages(direct,
                                                            block_size,
                                                            batch):
    """Feed both contexts the same 11 blocks (the last one short); after
    every call that made a copy, and after the final flush, the device
    holds the same bytes on both sides."""
    rng = np.random.default_rng(block_size)
    port = CudaWorkerContext(chip_id=0, block_size=block_size, direct=direct,
                             batch_blocks=batch, pipeline_depth=2,
                             device="cpu")
    jax = TpuWorkerContext(chip_id=0, block_size=block_size, direct=direct,
                           batch_blocks=batch, pipeline_depth=2)
    copies = []

    def step(call):
        before = port.h2d_staged_ops + port.h2d_direct_ops
        call(port)
        call(jax)
        if port.h2d_staged_ops + port.h2d_direct_ops > before:
            copies.append(_ingested(port))
            assert _ingested(port) == _ingested(jax)

    try:
        for i in range(11):
            length = block_size if i < 10 else max(block_size // 2, 1)
            buf = memoryview(bytearray(rng.integers(
                0, 256, block_size, dtype=np.uint8).tobytes()))
            step(lambda ctx: ctx.host_to_device(buf, length))
        step(lambda ctx: ctx.flush())
        for attr in ("h2d_staged_ops", "h2d_direct_ops"):
            assert getattr(port, attr) == getattr(jax, attr)
        assert port.pipe_inflight_hwm == jax.pipe_inflight_hwm
        assert (port.h2d_direct_ops > 0) == direct
        # every whole word of the 11 blocks reached the device, in order
        assert len(b"".join(copies)) == 4 * (10 * (block_size // 4)
                                             + max(block_size // 2, 1) // 4)
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("block_size,batch,depth", [
    (64 << 20, 16, 4), (32 << 20, 16, 8), (128 << 20, 4, 4),
    (1 << 20, 16, 8), (4096, 3, 2)])
def test_budget_clamp_and_its_notes_equal_the_jax_packages(capsys,
                                                           block_size, batch,
                                                           depth):
    """The batch is clamped to the memory budget (1 GiB for a device
    without memory stats, on both sides) before the ring depth, which is
    then divided by twice the batch."""
    capsys.readouterr()
    jax = TpuWorkerContext(chip_id=0, block_size=block_size,
                           batch_blocks=batch, pipeline_depth=depth)
    jax_notes = _notes(capsys.readouterr().out, "batch")
    port = CudaWorkerContext(chip_id=0, block_size=block_size,
                             batch_blocks=batch, pipeline_depth=depth,
                             device="cpu")
    port_notes = _notes(capsys.readouterr().out, "batch")
    try:
        assert (port.batch_blocks, port.pipeline_depth) == \
            (jax.batch_blocks, jax.pipeline_depth)
        assert port_notes == [n.replace("--tpubatch", "--gpubatch")
                              for n in jax_notes]
        assert bool(port_notes) == (port.batch_blocks < batch)
    finally:
        port.close()
        jax.close()


def test_batch_clamp_notes_through_the_cli(tmp_path, capsys):
    """-b 64M --gpubatch 16 reaches the clamp on the CPU's 1 GiB budget."""
    path = tmp_path / "sparse.bin"
    with open(path, "wb") as f:
        f.truncate(64 << 20)
    capsys.readouterr()
    args = ["-r", "-t", "1", "-s", "64M", "-b", "64M", "--gpubatch", "16"]
    assert run_jax(args, [path]) == 0
    jax_notes = _notes(capsys.readouterr().out, "batch")
    assert run_port(args, [path]) == 0
    port_notes = _notes(capsys.readouterr().out, "batch")
    assert port_notes == ["NOTE: --gpubatch 16 exceeds the HBM staging "
                          "budget; clamped to 5"]
    assert port_notes == [n.replace("--tpubatch", "--gpubatch")
                          for n in jax_notes]


def test_batch_is_ignored_under_on_device_verify(capsys):
    capsys.readouterr()
    jax = TpuWorkerContext(chip_id=0, block_size=4096, batch_blocks=4,
                           verify_on_device=True)
    jax_notes = _notes(capsys.readouterr().out, "batch")
    port = CudaWorkerContext(chip_id=0, block_size=4096, batch_blocks=4,
                             verify_on_device=True, device="cpu")
    port_notes = _notes(capsys.readouterr().out, "batch")
    try:
        assert port.batch_blocks == jax.batch_blocks == 1
        assert port_notes == ["NOTE: --gpubatch is ignored with --gpuverify "
                              "(per-block on-device checks)"]
        assert port_notes == [n.replace("--tpu", "--gpu") for n in jax_notes]
    finally:
        port.close()
        jax.close()


def test_batch_with_on_device_verify_is_refused_in_the_jax_packages_words(
        tmp_path, capsys):
    path = tmp_path / "f.bin"
    path.write_bytes(bytes(8192))
    args = ["-r", "-s", "8K", "-b", "4K", "--verify", "7", "--gpuverify",
            "--gpubatch", "2"]
    capsys.readouterr()
    assert run_jax(args, [path]) == 1
    jax_err = _error_line(capsys.readouterr().err)
    assert run_port(args, [path]) == 1
    port_err = _error_line(capsys.readouterr().err)
    assert port_err == jax_err.replace("--tpu", "--gpu")
    assert port_err.startswith("--gpubatch > 1 cannot be combined with "
                               "--gpuverify")


@pytest.mark.parametrize("order", [(0, 2, 3, 1), (0, 1, 3, 2, 5, 4, 7, 6),
                                   (4, 0, 1, 2, 3, 6, 5)])
@pytest.mark.parametrize("depth", [2, 3])
def test_speculated_verify_blocks_equal_the_jax_packages(order, depth):
    """The write path's speculative verify-pattern ring serves every
    offset its own pattern, whatever order the offsets come in: a stream
    that skips a speculated offset and comes back to it later must not
    get a buffer that a later speculation has overwritten."""
    port = CudaWorkerContext(chip_id=0, block_size=4096,
                             pipeline_depth=depth, device="cpu")
    jax = TpuWorkerContext(chip_id=0, block_size=4096, pipeline_depth=depth)
    port_buf, jax_buf = memoryview(bytearray(4096)), memoryview(
        bytearray(4096))
    try:
        for blk in order:
            port.device_to_host(port_buf, 4096, verify_salt=7,
                                file_offset=blk * 4096)
            jax.device_to_host(jax_buf, 4096, verify_salt=7,
                               file_offset=blk * 4096)
            assert bytes(port_buf) == bytes(jax_buf)
            assert int(np.frombuffer(port_buf, np.uint64)[0]) == \
                blk * 4096 + 7
        assert (port.d2h_prefetch_hits, port.d2h_prefetch_misses) == \
            (jax.d2h_prefetch_hits, jax.d2h_prefetch_misses)
    finally:
        port.close()
        jax.close()
