"""Deterministic synthetic data — the port of ``repro/data/pipeline.py``.

Markov-chain token streams, deterministic per (seed, step, host_id): a
restart reproduces the exact batch sequence from any step, which the
checkpoint/restart checks rely on.  Each host materialises only its
``host_rows`` slice of the global batch.  Batches are numpy (the package
boundary), bit-identical to the reference's for every (seed, step,
host_id): the same ``SeedSequence`` and the same draws in the same order.
``shard_batch`` places a host batch over a mesh: each rank keeps its own
rows.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    image_patches: int = 0           # vlm stub: emit image_embeds too
    d_model: int = 0
    encdec: bool = False             # whisper stub: enc_embeds + dec_tokens
    dec_len: int = 0

    def _rows(self) -> slice:
        per = self.global_batch // self.num_hosts
        return slice(self.host_id * per, (self.host_id + 1) * per)

    def batch_at(self, step: int) -> dict:
        """Host-local slice of the global batch for ``step``: tokens (n,
        seq_len) int32, with image_embeds (n, P, d_model) float32; for an
        encoder-decoder, enc_embeds (n, seq_len, d_model) and dec_tokens
        (n, dec_len) instead."""
        rows = self._rows()
        n = rows.stop - rows.start
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        # order-2 Markov-ish stream: correlated tokens compress-ably
        base = rng.integers(0, self.vocab_size, size=(n, self.seq_len),
                            dtype=np.int32)
        walk = np.cumsum(rng.integers(0, 7, size=(n, self.seq_len)), axis=1)
        tokens = ((base // 7) + walk) % self.vocab_size
        batch = {"tokens": tokens.astype(np.int32)}
        if self.image_patches:
            batch["image_embeds"] = rng.standard_normal(
                (n, self.image_patches, self.d_model), dtype=np.float32)
        if self.encdec:
            batch = {
                "enc_embeds": rng.standard_normal(
                    (n, self.seq_len, self.d_model), dtype=np.float32),
                "dec_tokens": rng.integers(
                    0, self.vocab_size, size=(n, self.dec_len)
                ).astype(np.int32),
            }
        return batch

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def shard_batch(batch: dict, mesh, rules, device="cuda") -> dict:
    """This rank's part of a host batch (every rank holds the whole one):
    each leaf's batch dim placed over (pod, data) as the rule set says
    (replicated where it does not divide), other dims replicated; tensors
    on ``device``, each rank's slice and no communication."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = (v.to(dev) if isinstance(v, torch.Tensor)
             else torch.as_tensor(np.asarray(v), device=dev))
        axes = ("batch",) + (None,) * (t.dim() - 1)
        out[k] = rules.sharding_for(axes, tuple(t.shape), mesh).place(t)
    return out
