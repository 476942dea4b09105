"""The yardstick: the chip's peaks, and the operations and bytes that a
window's traffic needs, worked out from the configuration's sizes and the
benchmark's own record of prompt lengths and tokens (never from the
program's counters).

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM 3.35 TB/s (the
data sheet, at the full 700 W; a card set lower reaches less).

Counting rules (what the inputs need, whatever implements them): each
layer's own counts come from the configuration's reference module
(``family.py``: ``layer_flops``, ``pair_flops``, ``query_bytes``,
``key_bytes``; ``refs/dense.py`` for the GQA decoder), summed layer by
layer.  A prompt token (prefill) and a decoded token each cost every
layer's FLOPs a token; a descriptor token those of its ``k_layers``; each
generated token (the prefill's first and every decoded one) also the head,
2 x d_model x vocab; attention adds, per layer and per (query, visible key)
pair, the layer's pair FLOPs, a query at position t seeing min(t + 1,
window) keys.  Attention's bytes: a prefill reads each position's query
and key bytes once per layer (q, k, v read, the output written); a decoded
token reads the key bytes of its visible keys and its query bytes.  Pads,
recomputation and re-reads are not counted.
"""
from __future__ import annotations

from typing import NamedTuple

from perfbench import family as F

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3


def head_flops(spec: dict) -> int:
    return 2 * spec["d_model"] * spec["vocab_size"]


def keys_prefill(S: int, window: int) -> int:
    """Visible (query, key) pairs of a causal pass over S positions."""
    if window <= 0 or S <= window:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def keys_decode(pos: int, window: int) -> int:
    """Keys visible to the token at position ``pos``."""
    return pos + 1 if window <= 0 else min(pos + 1, window)


class _Layers(NamedTuple):
    """Counts of a run of layers, summed layer by layer."""
    flops: int            # a token, outside attention's pairs
    pair: int             # a visible (query, key) pair
    query_bytes: int
    key_bytes: int


def _per_token(spec: dict, layers) -> _Layers:
    ref = F.of(spec)
    return _Layers(*(sum(f(spec, i) for i in layers)
                     for f in (ref.layer_flops, ref.pair_flops,
                               ref.query_bytes, ref.key_bytes)))


class Work:
    """Running totals of a window's work."""

    def __init__(self, spec: dict, k_layers: int):
        self.spec = spec
        L = spec["num_layers"]
        self.window = spec.get("sliding_window", 0)
        self.all = _per_token(spec, range(L))
        self.desc = _per_token(spec, range(min(k_layers, L)))
        self.model_flops = 0.0
        self.prefill_attn_flops = 0.0
        self.prefill_attn_bytes = 0.0
        self.decode_attn_flops = 0.0
        self.decode_attn_bytes = 0.0
        self.tokens_generated = 0

    def _prompt(self, S: int, layers: _Layers) -> int:
        """A causal pass of S positions through ``layers``: attention's
        work added, the FLOPs returned."""
        attn = layers.pair * keys_prefill(S, self.window)
        self.prefill_attn_flops += attn
        self.prefill_attn_bytes += S * (layers.query_bytes + layers.key_bytes)
        return layers.flops * S + attn

    def descriptor(self, S: int) -> None:
        self.model_flops += self._prompt(S, self.desc)

    def prefill(self, S: int) -> None:
        self.model_flops += self._prompt(S, self.all) + head_flops(self.spec)
        self.tokens_generated += 1

    def decode(self, pos: int) -> None:
        """The token at position ``pos`` goes through the model and yields
        the next token."""
        keys = keys_decode(pos, self.window)
        a = self.all
        self.model_flops += (a.flops + a.pair * keys
                             + head_flops(self.spec))
        self.decode_attn_flops += a.pair * keys
        self.decode_attn_bytes += keys * a.key_bytes + a.query_bytes
        self.tokens_generated += 1

    def least_prefill_attn_s(self) -> float:
        return max(self.prefill_attn_flops / PEAK_FLOPS,
                   self.prefill_attn_bytes / PEAK_BYTES)

    def least_decode_attn_s(self) -> float:
        return max(self.decode_attn_flops / PEAK_FLOPS,
                   self.decode_attn_bytes / PEAK_BYTES)
