"""The yardstick: the chip's peaks, and the operations and bytes that a
window's traffic needs, worked out from the configuration's sizes and the
benchmark's own record of prompt lengths and tokens (never from the
program's counters).

Peaks: one NVIDIA H100 SXM, dense bf16 989 TFLOP/s, HBM 3.35 TB/s (the
data sheet, at the full 700 W; a card set lower reaches less).

Counting rules (what the inputs need, whatever implements them):
  a prompt token (prefill) and a decoded token each cost 2 x the
  parameters of the layers; a descriptor token 2 x the parameters of its
  ``k_layers``; each generated token (the prefill's first and every
  decoded one) also the head, 2 x d_model x vocab; attention adds, per
  layer and per (query, visible key) pair, 4 x heads x head_dim (QK^T and
  PV), a query at position t seeing min(t + 1, window) keys.  Attention's
  bytes: a prefill reads q, k, v and writes its output once per layer; a
  decoded token reads the K and V of its visible keys and its q and
  writes its output.  Pads, recomputation and re-reads are not counted.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3


def layer_params(spec: dict) -> int:
    D, H, K, Dh, F = (spec["d_model"], spec["num_heads"],
                      spec["num_kv_heads"], spec["head_dim"], spec["d_ff"])
    attn = D * H * Dh + 2 * D * K * Dh + H * Dh * D
    mlp = (2 * D * F + F + D) if spec["mlp_kind"] == "gelu" else 3 * D * F
    return attn + mlp + 2 * D


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


def attn_flops_per_pair(spec: dict) -> int:
    return 4 * spec["num_heads"] * spec["head_dim"]


class Work:
    """Running totals of a window's work."""

    def __init__(self, spec: dict, k_layers: int):
        self.spec = spec
        self.L = spec["num_layers"]
        self.k = min(k_layers, self.L)
        self.window = spec.get("sliding_window", 0)
        self.P = layer_params(spec)
        self.pair = attn_flops_per_pair(spec)
        H, K, Dh = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
        self.qo_bytes = 2 * H * Dh * 2            # q read + out written, bf16
        self.kv_bytes = 2 * K * Dh * 2            # k + v of one position
        self.model_flops = 0.0
        self.prefill_attn_flops = 0.0
        self.prefill_attn_bytes = 0.0
        self.decode_attn_flops = 0.0
        self.decode_attn_bytes = 0.0
        self.tokens_generated = 0

    def descriptor(self, S: int) -> None:
        pairs = keys_prefill(S, self.window)
        self.model_flops += 2 * self.P * self.k * S + self.pair * pairs * self.k
        self.prefill_attn_flops += self.pair * pairs * self.k
        self.prefill_attn_bytes += self.k * S * (self.qo_bytes + self.kv_bytes)

    def prefill(self, S: int) -> None:
        pairs = keys_prefill(S, self.window)
        self.model_flops += (2 * self.P * self.L * S + self.pair * pairs * self.L
                             + head_flops(self.spec))
        self.prefill_attn_flops += self.pair * pairs * self.L
        self.prefill_attn_bytes += self.L * S * (self.qo_bytes + self.kv_bytes)
        self.tokens_generated += 1

    def decode(self, pos: int) -> None:
        """The token at position ``pos`` goes through the model and yields
        the next token."""
        keys = keys_decode(pos, self.window)
        self.model_flops += (2 * self.P * self.L + self.pair * keys * self.L
                             + head_flops(self.spec))
        self.decode_attn_flops += self.pair * keys * self.L
        self.decode_attn_bytes += self.L * (keys * self.kv_bytes
                                            + self.qo_bytes)
        self.tokens_generated += 1

    def least_prefill_attn_s(self) -> float:
        return max(self.prefill_attn_flops / PEAK_FLOPS,
                   self.prefill_attn_bytes / PEAK_BYTES)

    def least_decode_attn_s(self) -> float:
        return max(self.decode_attn_flops / PEAK_FLOPS,
                   self.decode_attn_bytes / PEAK_BYTES)
