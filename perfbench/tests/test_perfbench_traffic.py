"""The traffic generator: the same seed gives the same traffic, every seed
the same sizes, at the stated lengths and Zipf law."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.traffic import (Traffic, loguniform_quantiles, zipf_law,
                               zipf_sample)

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


POOLED = {"unique_short": {}, "unique_short.pool": {"pool": 2048,
                                                   "zipf_s": 1.1}}


def _mixes(name):
    base, _, _ = name.partition(".")
    return {**_mix(base), **POOLED[name]}


@pytest.mark.parametrize("name", sorted(POOLED))
def test_same_seed_same_prompts(name):
    a, b = (Traffic(_mixes(name), 1000, 2 ** 33 + 7) for _ in range(2))
    for c in list(a.contents(0, 50)) + list(a.contents(3, 20)):
        assert np.array_equal(a.prompt(int(c)), b.prompt(int(c)))
    assert np.array_equal(a.contents(2, 64), b.contents(2, 64))


@pytest.mark.parametrize("name", sorted(POOLED))
def test_lengths_in_range_and_a_fixed_set(name):
    mix = _mixes(name)
    lens = []
    for seed in (1, 2):
        t = Traffic(mix, 1000, seed)
        n = mix.get("pool") or 256
        ls = sorted(t.length(c) for c in range(n))
        assert mix["len_lo"] <= ls[0] and ls[-1] <= mix["len_hi"]
        lens.append(ls)
        assert len(t.prompt(0)) == t.length(0)
        assert t.prompt(0).max() < 1000
    assert lens[0] == lens[1]          # one set of sizes, another order


def test_loguniform_quantiles_median():
    q = loguniform_quantiles(128, 1024, 1001)
    assert q[500] == round(np.sqrt(128 * 1024))


def test_zipf_ranks_follow_the_law():
    s, pool, n = 1.1, 2048, 200000
    ranks = zipf_sample(s, pool, n, 0)
    p = zipf_law(s, pool)
    for r in (0, 1, 9, 99):
        sd = np.sqrt(p[r] * (1 - p[r]) / n)
        assert abs((ranks == r).mean() - p[r]) < 5 * sd
    # the same multiset of ranks for every seed, in another order
    a, b = (Traffic(_mixes("unique_short.pool"), 1000, sd).contents(1, 500)
            for sd in (5, 6))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    # blocks do not share their tail: another block is another sample
    assert sorted(zipf_sample(s, pool, 400, 2)) != \
        sorted(zipf_sample(s, pool, 400, 0))


def test_backlog_content_is_the_block_draw():
    t = Traffic(_mixes("unique_short.pool"), 1000, 9)
    blk = t.contents(1, 256)
    assert [t.content(256 + i) for i in (0, 7, 255)] == \
        [int(blk[0]), int(blk[7]), int(blk[255])]
    u = Traffic(_mix("unique_short"), 1000, 9)
    ids = [u.content(k) for k in range(600)]
    assert len(set(ids)) == 600


def test_unique_contents_never_repeat():
    t = Traffic(_mix("unique_short"), 32000, 3)
    ids = np.concatenate([t.contents(b, 300) for b in range(3)])
    assert len(set(ids.tolist())) == len(ids)


def test_shared_prefix():
    mix = {**_mix("unique_short"), "shared_prefix": 64}
    t = Traffic(mix, 1000, 4)
    assert np.array_equal(t.prompt(0)[:64], t.prompt(1)[:64])
    assert len(t.prompt(2)) == t.length(2)

