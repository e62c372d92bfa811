"""The traffic generator: the schedule is the mix's, the tokens the
seed's."""
import numpy as np

from ocbench.tests.smoke import SHARED, UNSHARED
from ocbench.traffic import (Tokens, prefix_lengths, schedule,
                             warmup_requests)


def test_schedule_is_fixed_and_a_shorter_window_is_its_prefix():
    a, b = schedule(SHARED, 4.0), schedule(SHARED, 4.0)
    assert a == b and len(a) > 15
    short = schedule(SHARED, 2.0)
    assert short == a[:len(short)]
    assert all(r.due_s < 2.0 for r in short)


def test_rate_scales_the_gaps_only():
    a, b = schedule(SHARED, 10.0, 10.0)[:40], schedule(SHARED, 5.0, 20.0)[:40]
    assert [(r.prefix, r.suffix_len) for r in a] == \
        [(r.prefix, r.suffix_len) for r in b]
    assert np.allclose([r.due_s for r in a], [2 * r.due_s for r in b])


def test_lengths_in_range():
    lens = prefix_lengths(SHARED)
    assert len(lens) == SHARED["prefixes"]
    assert all(l % 16 == 0 and 32 <= l <= 96 for l in lens)
    for r in schedule(SHARED, 4.0):
        assert 16 <= r.suffix_len <= 40 and r.prefix_len == lens[r.prefix]
    for r in schedule(UNSHARED, 4.0):
        assert r.prefix == -1 and r.prefix_len == 0
        assert 8 <= r.suffix_len <= 64


def test_tokens_are_deterministic_per_seed():
    reqs = schedule(SHARED, 2.0)

    def prompts(seed):
        t = Tokens(SHARED, seed, 256)
        t.draw(reqs)
        return [t.prompt(r) for r in reqs], \
            [t.warm_prompt(r) for r in warmup_requests(SHARED)]
    seed = 2**31 + 11  # wider than 32 signed bits
    (a, wa), (b, wb), (c, _) = prompts(seed), prompts(seed), prompts(seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a + wa, b + wb))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    for r, p in zip(reqs, a):
        assert len(p) == r.prompt_len and p.min() >= 0 and p.max() < 256
        # requests that share a prefix share its tokens
        if r.prefix == reqs[0].prefix:
            assert np.array_equal(p[:r.prefix_len], a[0][:r.prefix_len])


def test_warmup_covers_the_extremes():
    w = warmup_requests(SHARED)
    lens = prefix_lengths(SHARED)
    assert {r.prefix_len for r in w} >= {max(lens), min(lens)}
    assert {r.suffix_len for r in w} >= set(SHARED["suffix_tokens"])


def test_arrivals_are_poisson_at_the_rate():
    reqs = schedule(SHARED, 1000.0)
    gaps = np.diff([0.0] + [r.due_s for r in reqs])
    assert abs(len(reqs) / 1000.0 / SHARED["rate_rps"] - 1) < 0.05
    # exponential gaps: the spread about equals the mean
    assert 0.9 < gaps.std() / gaps.mean() < 1.1
