"""Gradient compression for cross-pod data parallelism — the port of
``repro/optim/grad_compress.py``.

At 2+ pods the inter-pod all-reduce crosses the slow links; error-feedback
compression cuts those bytes:

* ``ef_int8`` — per-tensor symmetric int8 quantization with an error-feedback
  accumulator (the quantization residual is added back before the next step),
  4x fewer bytes than fp32, unbiased in the long run (Karimireddy et al.,
  arXiv:1901.09847).
* ``topk`` — magnitude top-k sparsification with error feedback (Deep
  Gradient Compression, arXiv:1712.01887).

``compressed_cross_pod_mean`` composes quantize -> sum over the pod
group -> dequantize (see ``train/trainer.py::make_train_step_compressed``);
its collectives are ``parallel/collectives.py``'s (a ``gloo`` group's CUDA
tensors staged through the host).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_reduce


class CompressionState(NamedTuple):
    error: Dict[str, torch.Tensor]      # error-feedback residuals (fp32)


def init_compression_state(grads: dict) -> CompressionState:
    return CompressionState(error={k: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device)
                                   for k, g in grads.items()})


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round half to even, as ``jnp.round``, then clip to [-127, 127]."""
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale fp32 scalar, new_error)."""
    g = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
    q = _quantize(g, scale)
    return q, scale, g - q.float() * scale


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_compress(g: torch.Tensor, err: torch.Tensor, k_ratio: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sparse_dense fp32 with all but top-k zeroed, new_error)."""
    g = g.float() + err
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * k_ratio))
    thresh = torch.sort(torch.abs(flat), descending=True).values[k - 1]
    kept = torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))
    return kept, g - kept


def compressed_cross_pod_mean(grads: dict, state: CompressionState, group
                              ) -> Tuple[dict, CompressionState]:
    """int8 error-feedback mean over the ranks of ``group`` (the 'pod'
    dimension's).  Every rank of the group calls it with its own
    gradients.  The int8 payload is what crosses the inter-pod links; the
    sum itself runs in int32 to avoid overflow (worst case pods * 127 <<
    2^31).

    All pods quantize with a *shared* scale (the max of the per-pod
    absmax — one extra scalar all-reduce) so the summed int8 payload
    dequantizes exactly and the error-feedback residual equals the true
    wire error ``g - q*scale``.  Leaves go in sorted name order, the
    reference's."""
    n = dist.get_world_size(group)
    outs, new_errs = {}, {}
    for k in sorted(grads):
        g = grads[k].float() + state.error[k]
        absmax = all_reduce(torch.max(torch.abs(g)), group,
                            dist.ReduceOp.MAX)
        scale = torch.clamp(absmax / 127.0, min=1e-12)
        q = _quantize(g, scale)
        q_sum = all_reduce(q.to(torch.int32), group)
        outs[k] = q_sum.float() * scale / n
        new_errs[k] = g - q.float() * scale
    return outs, CompressionState(error=new_errs)
