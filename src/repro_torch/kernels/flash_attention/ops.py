"""Public wrapper for flash attention (prefill): backend selection.

``flash_attention`` keeps the reference's sequence-major public layout
(q (B, S, H, D), k/v (B, S, K, D); ``repro/kernels/flash_attention/
ops.py``).  ``impl="auto"`` launches the CUDA kernel for CUDA tensors and
runs the plain version for CPU tensors; ``impl="ref"`` forces the plain
version, ``impl="cuda"`` the kernel, which raises for a CPU tensor.  The
CUDA kernel needs no block padding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.similarity.ops import resolve_impl


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Causal (``causal``) GQA attention over positions 0..S-1, keys
    limited to the last ``window`` positions when ``window > 0``.
    q: (B, S, H, D); k/v: (B, S, K, D) with H % K == 0.  Returns
    (B, S, H, D) in q's dtype; softmax and PV in fp32."""
    if resolve_impl(impl, q) == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)
