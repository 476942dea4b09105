"""arch config -> model constructor."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


def build_model(cfg: ModelConfig, *, attention_impl: str = "auto",
                moe_impl: Optional[str] = None, device="cuda",
                generator: Optional[torch.Generator] = None):
    """A ``DecoderLM`` for ``cfg`` on ``device``, or an ``EncDecLM`` for
    an encoder-decoder config (``family == "encdec"``; its attention is
    plain, as in the reference, so it takes neither switch).
    ``attention_impl`` (``auto`` | ``cuda`` | ``ref``) picks the attention
    kernels (K7, K8) or their plain versions; ``moe_impl`` (``dense`` |
    ``dropless``; None: the reference's rule by d_model) the MoE dispatch.
    With ``generator`` the weights are drawn at random (``init``);
    without, they are left for ``models/convert.py::params_from_jax`` to
    fill."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDecLM

        model = EncDecLM(cfg, device=device)
    else:
        from repro_torch.models.transformer import DecoderLM

        model = DecoderLM(cfg, device=device, attention_impl=attention_impl,
                          moe_impl=moe_impl)
    if generator is not None:
        model.init(generator)
    return model
