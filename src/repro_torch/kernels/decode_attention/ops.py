"""Public wrapper for flash-decode: backend selection and byte model.

``decode_attention`` keeps the reference's public layout (q (B, H, D),
k/v (B, S, K, D) sequence-major, as the slotted cache stores them;
``repro/kernels/decode_attention/ops.py``).  ``impl="auto"`` launches the
CUDA kernel for CUDA tensors and runs the plain version for CPU tensors;
``impl="ref"`` forces the plain version, ``impl="cuda"`` the kernel, which
raises for a CPU tensor.  When a profiler is installed each call records
its time and the reference's modeled bytes under
``kernel/decode_attention/<impl>/...``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.similarity.ops import _run, resolve_impl
from repro_torch.obs.profile import decode_attention_bytes


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, impl: str = "auto",
                     return_lse: bool = False):
    """q: (B, H, D); k/v: (B, S, K, D); kv_len: (B,) valid leading slots per
    row.  Returns (B, H, D); with ``return_lse``, (out, lse (B, H) fp32):
    lse = log sum_s exp(q.k_s / sqrt(D)) over the valid slots, natural
    log, -inf for a row with ``kv_len == 0``.  The sequence-sharded decode
    merges ranks' partial results by it (``layers.merge_partials``)."""
    impl = resolve_impl(impl, q)
    if impl == "ref":
        def fn(q, k, v, kv_len):
            return decode_attention_ref(q, k, v, kv_len, return_lse)
    else:
        def fn(q, k, v, kv_len):
            args = (q.contiguous(), k.contiguous(), v.contiguous(),
                    kv_len.to(torch.int32).contiguous())
            if return_lse:
                return decode_attention_cuda(*args, return_lse=True)
            return decode_attention_cuda(*args)
    B, S, K, D = (int(s) for s in k.shape)
    return _run("decode_attention", impl, fn, (q, k, v, kv_len),
                lambda: decode_attention_bytes(B, S, K, D,
                                               k.element_size()))
