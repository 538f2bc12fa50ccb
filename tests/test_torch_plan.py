"""Property test of the port's fingerprint chunk plan
(elbencho_tpu_torch/ops/verify.py::fingerprint_plan): over random word
counts up to 2^26, every 4-byte offset and a range of grid shapes, the
head, per-block chunks and tail cover every word exactly once. Runs on the
CPU; skipped where hypothesis is not installed (the fixed sweep in
test_torch_verify.py checks the same property without it)."""

import pytest

hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies

from test_torch_verify import assert_plan_covers_every_word_once  # noqa: E402


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(n=st.integers(0, 1 << 26),
                  addr=st.sampled_from([0, 4, 8, 12]),
                  sms=st.sampled_from([1, 7, 132]),
                  per_sm=st.sampled_from([1, 4, 8]))
def test_plan_covers_every_word_exactly_once_property(n, addr, sms, per_sm):
    assert_plan_covers_every_word_once(n, addr, sms, per_sm)
