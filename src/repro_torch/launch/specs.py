"""Abstract inputs (``ShapeDtype``) of each (arch x shape) cell's step —
the port of ``repro/launch/specs.py``.

Nothing is allocated: the dry run (``launch/dryrun.py``) makes ``meta``
tensors of these.  The modality front ends are stubs, as in the
reference: whisper takes precomputed frame embeddings (``enc_embeds``),
llava precomputed patch embeddings (``image_embeds``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.layers import ShapeDtype


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, ShapeDtype]:
    """Inputs of one train or prefill step (the ``batch`` argument)."""
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        dec_len = max(1, int(S * cfg.encdec.decoder_len_ratio))
        return {"enc_embeds": ShapeDtype((B, S, cfg.d_model), torch.float32),
                "dec_tokens": ShapeDtype((B, dec_len), torch.int32)}
    if cfg.num_image_patches:
        n_img = cfg.num_image_patches
        return {"tokens": ShapeDtype((B, S - n_img), torch.int32),
                "image_embeds": ShapeDtype((B, n_img, cfg.d_model),
                                           torch.float32)}
    return {"tokens": ShapeDtype((B, S), torch.int32)}


def decode_specs(model, cfg: ModelConfig, cell: ShapeCell
                 ) -> Tuple[Dict[str, ShapeDtype], Dict[str, ShapeDtype]]:
    """(cache, step inputs) of one decode step over a cache of
    ``cell.seq_len`` (an encoder-decoder's encoder states as long)."""
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "encdec":
        cache = model.cache_specs(B, S, enc_len=S)
    else:
        cache = model.cache_specs(B, S)
    cache = {k: ShapeDtype(tuple(s), d) for k, (s, d) in cache.items()}
    inputs = {"tokens": ShapeDtype((B,), torch.int32),
              "lengths": ShapeDtype((B,), torch.int32)}
    return cache, inputs


def input_specs(model, cfg: ModelConfig, cell: ShapeCell
                ) -> Dict[str, ShapeDtype]:
    """Every abstract input of the cell's step, one flat dict (the cache's
    leaves under ``cache/``)."""
    if cell.kind in ("train", "prefill"):
        return batch_specs(cfg, cell)
    cache, inputs = decode_specs(model, cfg, cell)
    return {**{f"cache/{k}": v for k, v in cache.items()}, **inputs}
