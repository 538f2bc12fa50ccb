"""The port's device context (elbencho_tpu_torch/cuda/device.py) on an
explicitly requested CPU device, held against the JAX package's
TpuWorkerContext on its CPU backend: the same calls must land the same
bytes and count the same path-audit events. The CUDA stream and event
handling runs on the card (chip_smoke.py)."""

import mmap

import numpy as np
import pytest
import torch

from elbencho_tpu.tpu.device import PATH_AUDIT_COUNTERS as JAX_COUNTERS
from elbencho_tpu.tpu.device import TpuWorkerContext
from elbencho_tpu_torch.cuda.device import (PATH_AUDIT_COUNTERS,
                                            CudaWorkerContext,
                                            TransferPipeline)
from elbencho_tpu_torch.utils.staging_pool import SLOT_ALIGN, StagingPool

torch.set_num_threads(1)

#: counters whose value depends on timing (whether a copy had finished
#: when the ring filled), not on the calls made
TIMING_KEYS = {"TpuPipeFullStalls"}


def _port_ctx(**kwargs) -> CudaWorkerContext:
    return CudaWorkerContext(chip_id=0, device="cpu", **kwargs)


def _counters(ctx, keys_of):
    return {key: getattr(ctx, attr) for attr, key in keys_of
            if key not in TIMING_KEYS}


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for():
    """No silent CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        CudaWorkerContext(chip_id=0, block_size=4096)


def test_host_to_device_pipelined_ring_and_flush():
    ctx = _port_ctx(block_size=65536, pipeline_depth=4)
    buf = memoryview(bytearray(65536))
    for i in range(10):
        buf[:8] = i.to_bytes(8, "little")
        ctx.host_to_device(buf, 65536)
        assert len(ctx._inflight) <= 3  # drained to depth-1 per submit
    assert ctx.pipe_inflight_hwm == 4
    assert ctx.h2d_staged_ops == 10 and ctx.h2d_direct_ops == 0
    ctx.flush()
    assert not ctx._inflight
    ctx.close()


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("length", [65536, 65536 - 4, 6])
def test_bytes_landing_on_the_device_equal_the_source(direct, length):
    pool = StagingPool(2, 65536)
    ctx = _port_ctx(block_size=65536, pipeline_depth=2, direct=direct,
                    staging_pool=pool)
    rng = np.random.default_rng(length)
    for slot in range(3):
        src = pool.views[slot % 2]
        src[:length] = rng.integers(0, 256, size=length,
                                    dtype=np.uint8).tobytes()
        ctx.host_to_device(src, length)
        n = (length // 4) * 4  # the device block holds whole words
        assert bytes(ctx._last_ingested.numpy()) == bytes(src[:n])
    ctx.flush()
    assert (ctx.h2d_direct_ops, ctx.h2d_staged_ops) == \
        ((3, 0) if direct else (0, 3))
    ctx.close()
    pool.close()


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("length", [4096, 4096 + 4, 4096 + 6, 2])
def test_device_to_host_verify_matches_jax(direct, length):
    """The on-device verify pattern lands in the host buffer byte for byte
    as the JAX package's does, tails included."""
    port = _port_ctx(block_size=8192, direct=direct)
    jax_ctx = TpuWorkerContext(chip_id=0, block_size=8192, direct=direct)
    for offset in (81920, 81920 + length, (1 << 64) - 8192):
        got = memoryview(bytearray(b"\xee" * length))
        want = memoryview(bytearray(b"\xee" * length))
        port.device_to_host(got, length, verify_salt=42, file_offset=offset)
        jax_ctx.device_to_host(want, length, verify_salt=42,
                               file_offset=offset)
        assert bytes(got) == bytes(want)
    port.close()
    jax_ctx.close()


@pytest.mark.parametrize("direct", [False, True])
def test_device_to_host_fill_pool_serves_device_blocks(direct):
    ctx = _port_ctx(block_size=4096, direct=direct)
    ctx.warmup_fill()
    blocks = [bytes(b.numpy().view(np.uint8)) for b, _ in ctx._fill_pool]
    assert len(blocks) == CudaWorkerContext._FILL_POOL_BLOCKS
    for i in range(6):
        buf = memoryview(bytearray(4096))
        ctx.device_to_host(buf, 4096)
        assert bytes(buf) == blocks[(i + 1) % len(blocks)]
    assert (ctx.d2h_direct_ops, ctx.d2h_staged_ops) == \
        ((6, 0) if direct else (0, 6))
    ctx.close()


def _drive(ctx):
    """The same call sequence for either package: a pipelined H2D stream,
    a sequential D2H verify stream, then a random one."""
    buf = memoryview(mmap.mmap(-1, 4096))
    for i in range(7):
        buf[:8] = i.to_bytes(8, "little")
        ctx.host_to_device(buf, 4096)
    ctx.flush()
    for k in range(6):
        ctx.device_to_host(buf, 4096, verify_salt=7, file_offset=k * 4096)
    rng = np.random.default_rng(5)
    for off in rng.permutation(64)[:12]:
        ctx.device_to_host(buf, 4096, verify_salt=7,
                           file_offset=(1 << 20) + int(off) * 4096)
    ctx.flush()


def test_path_audit_counters_equal_the_jax_contexts():
    port = _port_ctx(block_size=4096, pipeline_depth=3)
    jax_ctx = TpuWorkerContext(chip_id=0, block_size=4096, pipeline_depth=3)
    _drive(port)
    _drive(jax_ctx)
    port_keys = {key for _attr, key in PATH_AUDIT_COUNTERS}
    want = _counters(jax_ctx, [(attr, key) for attr, key, _ in JAX_COUNTERS
                               if key in port_keys])
    assert _counters(port, PATH_AUDIT_COUNTERS) == want
    assert port.d2h_prefetch_hits == 5  # sequential stream hits
    assert port.d2h_prefetch_misses == \
        CudaWorkerContext._D2H_SPEC_MISS_LIMIT  # then self-disables
    port.reset_path_counters()
    assert all(v == 0 for v in _counters(port, PATH_AUDIT_COUNTERS).values())
    port.close()
    jax_ctx.close()


def test_speculation_resumes_after_a_phase_reset():
    ctx = _port_ctx(block_size=4096, pipeline_depth=2)
    buf = memoryview(bytearray(4096))
    for off in range(0, 40 * 4096, 4 * 4096):  # strided: every call misses
        ctx.device_to_host(buf, 4096, verify_salt=3, file_offset=off)
    assert ctx.d2h_prefetch_misses == CudaWorkerContext._D2H_SPEC_MISS_LIMIT
    ctx.reset_path_counters()
    for k in range(4):
        ctx.device_to_host(buf, 4096, verify_salt=3, file_offset=k * 4096)
    assert ctx.d2h_prefetch_hits == 3
    ctx.close()


def test_block_larger_than_the_memory_budget_is_refused():
    with pytest.raises(RuntimeError, match="fits fewer than 3 blocks"):
        _port_ctx(block_size=1 << 30, hbm_limit_pct=90)


def test_depth_is_clamped_to_the_memory_budget():
    # 1 GiB default budget on a CPU device / 64 MiB blocks = 16 blocks:
    # 4 fill-pool blocks + 1 sink leave (16-4-1)//2 = 5 ring slots
    ctx = _port_ctx(block_size=64 << 20, pipeline_depth=32)
    assert ctx.pipeline_depth == 5
    ctx.close()


def test_dispatch_budget_fails_loudly():
    pipe = TransferPipeline(depth=2, budget_usec=1)
    pipe.note_dispatch(50)
    with pytest.raises(RuntimeError, match="--gpubudget exceeded"):
        pipe.flush()
    pipe.flush(check_budget=False)  # teardown never raises


def test_staging_pool_slots_are_page_aligned_and_prefilled():
    from elbencho_tpu_torch.toolkits.random_algos import RandAlgoGoldenPrime
    pool = StagingPool(3, 10000, fill_algo=RandAlgoGoldenPrime(seed=1))
    addrs = [np.frombuffer(v, dtype=np.uint8).ctypes.data
             for v in pool.views]
    assert all(a % SLOT_ALIGN == 0 for a in addrs)
    assert all(len(v) == 10000 and any(v) for v in pool.views)
    aux = pool.alloc_aux(2, 5000)
    assert [len(v) for v in aux] == [5000, 5000]
    assert not pool.registered
    pool.close()
    assert pool.views == []
