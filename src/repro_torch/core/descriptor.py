"""Feature descriptors — the CoIC "client pre-processing" step.

The port of ``repro/core/descriptor.py``:

* ``PrefixDescriptor`` — mean-pooled hidden state of the first *k*
  transformer layers (the DNN-feature-vector analogue).
* ``NgramSketchDescriptor`` — model-free hashed n-gram sketch.  The
  reference hashes in uint32; PyTorch's uint32 arithmetic is limited, so
  the hash runs in int64 masked to 32 bits, which gives the same buckets
  and signs bit for bit (a ``-1`` pad becomes ``0xFFFFFFFF`` as in the
  reference's cast).

Descriptors are L2-normalized so cosine similarity == dot product.
"""
from __future__ import annotations

import dataclasses

import torch

_U32 = 0xFFFFFFFF


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return xf / n.clamp(min=eps)


@dataclasses.dataclass
class NgramSketchDescriptor:
    """Hashed n-gram count sketch over token ids."""

    dim: int = 256
    n: int = 3
    seed: int = 0x5EED

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int (padded with -1 beyond the prompt).  Returns
        (B, dim) fp32 unit descriptors."""
        B, S = tokens.shape
        W = S - self.n + 1
        t = tokens.long() & _U32
        valid = tokens >= 0
        h = torch.zeros((B, W), dtype=torch.int64, device=tokens.device)
        ok = torch.ones((B, W), dtype=torch.bool, device=tokens.device)
        for i in range(self.n):
            # (h * 1000003 + win * (seed | 1)) mod 2^32: < 2^53, exact in int64
            h = (h * 1000003 + t[:, i:i + W] * (self.seed | 1)) & _U32
            ok &= valid[:, i:i + W]
        bucket = h % self.dim
        sign = torch.where((h >> 16) & 1 == 1, 1.0, -1.0)
        contrib = torch.where(ok, sign, 0.0)
        sketch = torch.zeros((B, self.dim), dtype=torch.float32,
                             device=tokens.device)
        sketch.scatter_add_(1, bucket, contrib)
        return l2_normalize(sketch)


@dataclasses.dataclass
class PrefixDescriptor:
    """Mean-pooled hidden state after the first ``k_layers`` of ``model``
    (a ``DecoderLM``), so descriptor quality tracks the serving model."""

    model: object
    k_layers: int = 2
    out_dim: int = 0  # 0 => d_model (no projection)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int (pads < 0 are masked out of the pool).
        Returns (B, D) fp32 unit descriptors."""
        hidden = self.model.forward_hidden(tokens.clamp(min=0),
                                           num_layers=self.k_layers)
        mask = (tokens >= 0).float()[..., None]
        pooled = (hidden.float() * mask).sum(1) / mask.sum(1).clamp(min=1.0)
        return l2_normalize(pooled)
