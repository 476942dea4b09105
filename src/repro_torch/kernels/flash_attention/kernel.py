"""ctypes wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the TPU
``flash_attention_kernel``.

The kernel reads q, k, v and writes the output in the model's
sequence-major layout, so the wrapper transposes nothing and pads nothing
(the kernel masks the ragged edge).  It checks device, dtype, shape,
contiguity and 16-byte alignment, allocates the output with
``torch.empty``, launches on the current stream, raises on a launch
error, and counts the launch in ``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import LAUNCHES, check, load

D_MAX = 128              # head_dim the kernel's tiles hold

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 4 + [_I] * 7 + [ctypes.c_float, _I, _VP]
        fn.restype = ctypes.c_int
    return fn


def check_attention_inputs(q: torch.Tensor, named_shapes) -> None:
    """What the attention kernels (K7, K8) take: CUDA tensors of the
    stated shapes, contiguous, 16-byte aligned, float32 or bfloat16 for
    the floating ones, head_dim a multiple of 8 up to ``D_MAX`` (16-byte
    row loads)."""
    for name, t, shape in named_shapes:
        if not t.is_cuda:
            raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor "
                             f"(got {t.device})")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must be 16-byte aligned")
        if t.is_floating_point() and t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype} != q's {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q: dtype {q.dtype} not float32/bfloat16")
    D = q.shape[-1]
    if D % 8 or D > D_MAX:
        raise ValueError(f"head_dim {D}: need a multiple of 8 up to {D_MAX}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, K, D) f32/bf16 -> (B, S, H, D)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    check_attention_inputs(q, (("q", q, (B, S, H, D)),
                               ("k", k, (B, S, K, D)),
                               ("v", v, (B, S, K, D))))
    if H % K:
        raise ValueError(f"need H % K == 0 (H={H}, K={K})")
    out = torch.empty_like(q)
    if B and S:
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, H, K, D, int(causal), int(window),
                    float(1.0 / np.sqrt(D)), int(q.dtype == torch.bfloat16),
                    torch.cuda.current_stream(q.device).cuda_stream)
        check("flash_attention", err, "flash_attention")
        LAUNCHES["flash_attention"] += 1
    return out
