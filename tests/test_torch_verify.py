"""Parity of the port's on-device verify (elbencho_tpu_torch/ops/verify.py)
with the JAX package's: the plain version of the CUDA fingerprint kernel
against fingerprint_block_jnp and against the Pallas kernel run in
interpret mode, the closed-form expected fingerprint, and the corruption
error. Fingerprints are integer sums mod 2^32 and xors, so the tolerance
is 0 everywhere. The CUDA kernel itself runs on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from elbencho_tpu.ops import verify as jax_verify
from elbencho_tpu.workers.local_worker import LocalWorker as JaxLocalWorker
from elbencho_tpu_torch.ops import verify as port_verify

torch.set_num_threads(1)

MASK = 0xFFFFFFFF


def _blocks():
    rng = np.random.default_rng(20261017)
    cases = [(f"random-{n}", rng.integers(0, 1 << 32, size=n, dtype=np.uint32))
             for n in (1, 127, 128, 4097, 262144)]
    for n in (4096, 4097):
        cases.append((f"ones-{n}", np.full(n, MASK, dtype=np.uint32)))
        cases.append((f"zeros-{n}", np.zeros(n, dtype=np.uint32)))
    return cases


BLOCKS = _blocks()


def _port_fingerprint(words_u32: np.ndarray) -> "list[int]":
    out = port_verify.fingerprint_u32(
        torch.from_numpy(words_u32.view(np.int32).copy()))
    assert out.dtype == torch.int32 and out.shape == (2,)
    return [v & MASK for v in out.tolist()]


def _pallas_interpret(words_u32: np.ndarray) -> "list[int]":
    """The JAX package's Pallas kernel, run as its CPU tests can: in
    interpret mode (the compiled call only lowers on a TPU). The kernel
    takes (rows, 128) words; a block of another length is zero-padded to
    that shape, which changes neither its sum nor its xor."""
    call = pl.pallas_call(
        jax_verify._fingerprint_kernel,
        out_shape=(jax.ShapeDtypeStruct((1, 1), jnp.uint32),
                   jax.ShapeDtypeStruct((1, 1), jnp.uint32)),
        interpret=True)
    padded = np.zeros(-(-len(words_u32) // 128) * 128, dtype=np.uint32)
    padded[:len(words_u32)] = words_u32
    s, x = call(jnp.asarray(padded.reshape(-1, 128)))
    return [int(s[0, 0]), int(x[0, 0])]


@pytest.mark.parametrize("name,words", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_plain_fingerprint_matches_jnp(name, words):
    s, x = jax_verify.fingerprint_block_jnp(jnp.asarray(words))
    assert _port_fingerprint(words) == [int(s), int(x)]


@pytest.mark.parametrize("name,words", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_plain_fingerprint_matches_pallas_interpret(name, words):
    assert _port_fingerprint(words) == _pallas_interpret(words)


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    """A CPU tensor goes through the plain version; only a kernel launch
    counts."""
    before = port_verify.fingerprint_u32.launches.count
    port_verify.fingerprint_u32(torch.arange(1000, dtype=torch.int32))
    assert port_verify.fingerprint_u32.launches.count == before


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.int64),
    torch.zeros(2, 4, dtype=torch.int32),
])
def test_wrapper_rejects_wrong_dtype_or_shape(bad):
    with pytest.raises(ValueError, match="1-D int32"):
        port_verify.fingerprint_u32(bad)


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="unsupported device"):
        port_verify.fingerprint_u32(torch.zeros(8, dtype=torch.int32,
                                                device="meta"))


EXPECTED_CASES = [
    (0, 4096, 7),
    (81920, 1 << 20, 42),
    (12345678 * 8, 8192, 99),
    ((1 << 64) - 4096, 8192, 7),        # offset + salt wraps 2^64
    ((1 << 64) - 3, 64, 5),             # wraps inside the first word
    (4096, 4100, 7),                    # length % 8 == 4
    (8, 4, 1),                          # shorter than one 64-bit word
    (0xFFFFFFFF - 40, 1024, 1),         # lo word carries into hi
]


@pytest.mark.parametrize("offset,length,salt", EXPECTED_CASES)
def test_expected_fingerprint_matches_jax(offset, length, salt):
    assert port_verify.expected_fingerprint_host(offset, length, salt) \
        == jax_verify.expected_fingerprint_host(offset, length, salt)


def _host_pattern(offset, length, salt) -> bytearray:
    buf = bytearray(length)
    JaxLocalWorker._fill_verify_pattern(memoryview(buf), offset, length, salt)
    return buf


@pytest.mark.parametrize("offset,length,salt",
                         [c for c in EXPECTED_CASES if c[1] % 4 == 0])
def test_expected_fingerprint_is_the_fingerprint_of_the_pattern(
        offset, length, salt):
    words = np.frombuffer(bytes(_host_pattern(offset, length, salt)),
                          dtype=np.uint32)
    assert tuple(_port_fingerprint(words)) == \
        port_verify.expected_fingerprint_host(offset, length, salt)


def test_verify_block_on_device_raises_the_jax_error_text():
    offset, length, salt = 4096, 4096, 7
    pattern = _host_pattern(offset, length, salt)
    good = np.frombuffer(bytes(pattern), dtype=np.uint32)
    port_verify.verify_block_on_device(
        torch.from_numpy(good.view(np.int32).copy()), offset, length, salt)
    pattern[100] ^= 0xFF
    bad = np.frombuffer(bytes(pattern), dtype=np.uint32)
    with pytest.raises(ValueError, match="integrity") as port_err:
        port_verify.verify_block_on_device(
            torch.from_numpy(bad.view(np.int32).copy()), offset, length,
            salt)
    with pytest.raises(ValueError) as jax_err:
        jax_verify.verify_block_on_device(jnp.asarray(bad), offset, length,
                                          salt, use_pallas=False)
    assert str(port_err.value) == str(jax_err.value)


# --- the kernel's chunk plan (ops/verify.py::fingerprint_plan) -------------

def _plan_ranges(plan, n):
    """[lo, hi) word ranges of the plan, in the kernel's order: the head,
    one range per block, the tail."""
    body = plan.head + 4 * plan.n_vec
    ranges = [(0, plan.head)]
    for b in range(plan.grid):
        ranges.append((plan.head + 4 * b * plan.chunk,
                       plan.head + 4 * min((b + 1) * plan.chunk,
                                           plan.n_vec)))
    ranges.append((body, body + plan.tail))
    return ranges


def assert_plan_covers_every_word_once(n, addr, sms, per_sm):
    """The plan's head, block chunks and tail cover [0, n) exactly once,
    with no idle block and the body on a 16-byte boundary."""
    plan = port_verify.fingerprint_plan(n, addr, sms, per_sm)
    assert 1 <= plan.grid <= sms * per_sm
    assert plan.chunk % port_verify.TILE_VECS == 0
    assert 0 <= plan.head <= 3 and 0 <= plan.tail <= 3
    if n > plan.head:   # the body starts on a 16-byte boundary
        assert (addr + 4 * plan.head) % 16 == 0
    ranges = _plan_ranges(plan, n)
    assert all(0 <= lo <= hi <= n for lo, hi in ranges)
    # no block is idle, unless it is the only one
    assert all(lo < hi for lo, hi in ranges[2:-1])
    # count coverage over the segments between the ranges' edges, so the
    # counter stays small for 2^26 words
    edges = np.unique(np.array([0, n] + [e for r in ranges for e in r]))
    counts = np.zeros(max(len(edges) - 1, 0), dtype=np.int64)
    for lo, hi in ranges:
        counts[np.searchsorted(edges, lo):np.searchsorted(edges, hi)] += 1
    assert np.all(counts == 1)


_STEP_WORDS = 4 * port_verify.TILE_VECS


@pytest.mark.parametrize("n", [
    0, 1, 3, 4, 7, _STEP_WORDS - 1, _STEP_WORDS + 3,
    132 * 8 * _STEP_WORDS - 1, 132 * 8 * _STEP_WORDS + 5, 16 << 18,
    (1 << 26) - 1, 1 << 26])
@pytest.mark.parametrize("addr", [0, 4, 8, 12])
@pytest.mark.parametrize("sms,per_sm", [(1, 1), (7, 4), (132, 8)])
def test_plan_covers_every_word_exactly_once(n, addr, sms, per_sm):
    assert_plan_covers_every_word_once(n, addr, sms, per_sm)


@pytest.mark.parametrize("args", [
    (16, 2, 1, 1), (16, 1, 1, 1), (-1, 0, 1, 1), (16, 0, 0, 1),
    (16, 0, 1, 0)])
def test_plan_rejects_bad_arguments(args):
    with pytest.raises(ValueError, match="fingerprint_plan"):
        port_verify.fingerprint_plan(*args)


def _walk_plan(words_u32, plan):
    """The kernel's arithmetic in numpy: each block's (sum, xor) partial
    over its range (block 0 with the head and tail), then the last
    block's fold of all partials."""
    ranges = _plan_ranges(plan, len(words_u32))
    head, tail = ranges[0], ranges[-1]
    partials = []
    for b, (lo, hi) in enumerate(ranges[1:-1]):
        seg = words_u32[lo:hi]
        if b == 0:
            seg = np.concatenate([words_u32[head[0]:head[1]], seg,
                                  words_u32[tail[0]:tail[1]]])
        partials.append((int(seg.sum(dtype=np.uint64)) & MASK,
                         int(np.bitwise_xor.reduce(seg)) if len(seg) else 0))
    s = x = 0
    for ps, px in partials:
        s = (s + ps) & MASK
        x ^= px
    return [s, x]


WALK_CASES = [(n, offset_words, sms, per_sm)
              for n in (0, 1, 3, 4, 5, _STEP_WORDS - 1, _STEP_WORDS + 5,
                        7 * _STEP_WORDS + 3, 9 * _STEP_WORDS + 6)
              for offset_words in (0, 1, 2, 3)
              for sms, per_sm in ((1, 1), (7, 1), (3, 2))]
WALK_DATA = np.random.default_rng(20261018).integers(
    0, 1 << 32, size=9 * _STEP_WORDS + 16, dtype=np.uint32)


@pytest.mark.parametrize("n,offset_words,sms,per_sm", WALK_CASES)
def test_plan_walk_gives_the_plain_fingerprint(n, offset_words, sms, per_sm):
    base = torch.from_numpy(WALK_DATA.view(np.int32).copy())
    # the tensor's own address decides the head, as in the wrapper
    start = offset_words + (-(base.data_ptr() // 4)) % 4
    words = base[start:start + n]
    plan = port_verify.fingerprint_plan(n, words.data_ptr() % 16, sms,
                                        per_sm)
    assert plan.head == min(n, (4 - offset_words) % 4)
    words_u32 = words.numpy().view(np.uint32)
    walked = _walk_plan(words_u32, plan)
    assert walked == [v & MASK for v in
                      port_verify.fingerprint_u32_plain(words).tolist()]
    if n:
        s, x = jax_verify.fingerprint_block_jnp(jnp.asarray(words_u32))
        assert walked == [int(s), int(x)]
        assert walked == _pallas_interpret(words_u32)


def test_scratch_is_kept_per_device_and_stream(monkeypatch):
    monkeypatch.setattr(port_verify, "_scratches", {})
    made = []

    def make():
        made.append(torch.zeros(4, dtype=torch.int32))
        return made[-1]

    a = port_verify.stream_scratch(0, 1111, make)
    assert port_verify.stream_scratch(0, 1111, make) is a
    b = port_verify.stream_scratch(0, 2222, make)
    c = port_verify.stream_scratch(1, 1111, make)
    assert len({id(a), id(b), id(c)}) == 3 and len(made) == 3
    assert port_verify.stream_scratch(1, 1111, make) is c
    assert len(made) == 3
