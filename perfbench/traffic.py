"""The one traffic generator: it reads a mix's parameters
(``traffic/<name>.json``) and makes every prompt and length from
``--seed``.

Every seed gets the same set of sizes in another order: a length is a
quantile of the log-uniform [lo, hi] law at (i + 0.5) / n, each block of n
permuted by the seed.  With a pool, the popularity ranks of a block of
requests are one Zipf(s) sample over the pool drawn from a fixed stream
(not quantiles: a block of quantiles asks for the same few tail entries as
every other block whose size divides it), permuted by the seed.  So runs
on different seeds do the same work, and the seed changes the order, the
token ids and which pool entry is popular.

Mix keys:
  arrivals      "backlog": outstanding requests kept at max_batch +
                ``waiting``
  pool          distinct prompts drawn by Zipf(``zipf_s``); 0: every
                request a prompt of its own
  len_lo, len_hi  prompt lengths in tokens (log-uniform quantiles)
  shared_prefix tokens of one system prompt every prompt starts with
                (counted in its length), 0 for none
  warm          {"ramp_steps", "settle_steps"}: the first max_batch
                requests spread over ``ramp_steps`` engine steps (so rows
                do not finish in step), then ``settle_steps`` steps topped
                up
  max_per_step  the most requests sent between two engine steps (the
                engine extracts the descriptors of everything sent since
                its last step in one batch)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_BLOCK = 256          # lengths of unique prompts: quantile blocks this big
_FIXED = 0x2B1F       # the stream of the popularity sample, seed-free


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *tags])


def loguniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                    ).astype(np.int64)


def zipf_law(s: float, pool: int) -> np.ndarray:
    p = np.arange(1, pool + 1, dtype=np.float64) ** -s
    return p / p.sum()


def zipf_sample(s: float, pool: int, n: int, block: int) -> np.ndarray:
    """n ranks (0 = most popular) drawn from Zipf(s) over ``pool``, the same
    for every seed (a fixed stream per block and size)."""
    rng = np.random.default_rng([_FIXED, block, n])
    return rng.choice(pool, size=n, p=zipf_law(s, pool))


# block tags: each kind of draw has its own stream (4 is unused)
_T_POOL_LEN, _T_TOKENS, _T_RANKS, _, _T_LENS, _T_PREFIX = range(6)


class Traffic:
    """Prompts of one mix under one seed."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab = vocab_size
        self.seed = seed
        self.pool = int(mix.get("pool", 0))
        self.lo, self.hi = int(mix["len_lo"]), int(mix["len_hi"])
        self.prefix_len = int(mix.get("shared_prefix", 0))
        self._prefix = (_rng(seed, _T_PREFIX).integers(
            0, vocab_size, self.prefix_len).astype(np.int32))
        if self.pool:
            lens = loguniform_quantiles(self.lo, self.hi, self.pool)
            self._pool_len = _rng(seed, _T_POOL_LEN).permutation(lens)
        self._prompts: Dict[int, np.ndarray] = {}
        self._len_blocks: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    def length(self, content: int) -> int:
        if self.pool:
            return int(self._pool_len[content])
        b, i = divmod(content, _BLOCK)
        blk = self._len_blocks.get(b)
        if blk is None:
            blk = self._len_blocks[b] = _rng(self.seed, _T_LENS, b) \
                .permutation(loguniform_quantiles(self.lo, self.hi, _BLOCK))
        return int(blk[i])

    def prompt(self, content: int) -> np.ndarray:
        """The prompt of pool entry (or unique request) ``content``."""
        p = self._prompts.get(content)
        if p is None:
            n = self.length(content)
            body = _rng(self.seed, _T_TOKENS, content).integers(
                0, self.vocab, max(0, n - self.prefix_len)).astype(np.int32)
            p = np.concatenate([self._prefix[:n], body])
            if self.pool:
                self._prompts[content] = p
        return p

    def contents(self, block: int, n: int) -> np.ndarray:
        """The contents of ``n`` requests of block ``block``: Zipf ranks
        over the pool, or (pool 0) fresh ids ``block * 2**20 + i``."""
        if not self.pool:
            return block * (1 << 20) + np.arange(n)
        ranks = zipf_sample(float(self.mix["zipf_s"]), self.pool, n, block)
        return _rng(self.seed, _T_RANKS, block).permutation(ranks)

    def content(self, k: int) -> int:
        """The content of the ``k``-th request of a backlog (blocks of
        ``_BLOCK`` drawn as ``contents`` draws them)."""
        b, i = divmod(k, _BLOCK)
        return int(self.contents(b, _BLOCK)[i])
