"""Public wrapper for flash attention (prefill): backend selection.

``flash_attention`` keeps the reference's sequence-major public layout
(q (B, S, H, D), k/v (B, S, K, D); ``repro/kernels/flash_attention/
ops.py``).  ``impl="auto"`` launches the CUDA kernel for CUDA tensors and
runs the plain version for CPU tensors; ``impl="ref"`` forces the plain
version, ``impl="cuda"`` the kernel, which raises for a CPU tensor.  The
CUDA kernel needs no block padding.

Under autograd (``auto`` / ``cuda``) the call goes through
``FlashAttention``, whose forward is the kernel (the plain version on a
CPU tensor) and whose backward recomputes the plain version from the
saved q, k, v and differentiates it: the gradient the reference takes,
XLA's autodiff of plain attention (the JAX package has no backward
kernel).  ``impl="ref"`` is plain autograd throughout.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.similarity.ops import resolve_impl


class FlashAttention(torch.autograd.Function):
    """K8 forward (``route`` "cuda"; "ref" runs its plain version, the
    CPU route), plain backward.  The tensors saved are the ones the
    forward launched on."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, route: str):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if route == "cuda":
            return flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
        return flash_attention_ref(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        saved = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_ref(*saved, causal=ctx.causal,
                                      window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, saved, grad)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Causal (``causal``) GQA attention over positions 0..S-1, keys
    limited to the last ``window`` positions when ``window > 0``.
    q: (B, S, H, D); k/v: (B, S, K, D) with H % K == 0.  Returns
    (B, S, H, D) in q's dtype; softmax and PV in fp32.  Under autograd
    (any input requiring grad), ``auto`` and ``cuda`` go through
    ``FlashAttention``."""
    route = resolve_impl(impl, q)
    if route == "cuda":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if (impl != "ref" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return FlashAttention.apply(q, k, v, causal, window, route)
    if route == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
