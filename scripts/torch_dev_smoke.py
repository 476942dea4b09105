#!/usr/bin/env python
"""Dev loop of the PyTorch port: instantiate every reduced arch, run
loss / prefill / decode (the port of ``scripts/dev_smoke.py``).

Every arch of ``ARCH_IDS`` at ``reduced_config``: build with random
weights, ``loss``, ``prefill(max_len=S + 8)`` (whisper: ``prefill(enc,
dec, max_len=24)``) and one ``decode_step``, asserting shapes and finite
values.  Prints ``OK <arch> loss=...`` per arch, then ``all smoke OK``.

    PYTHONPATH=src python scripts/torch_dev_smoke.py                # the card
    PYTHONPATH=src python scripts/torch_dev_smoke.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import build_model

B, S = 2, 32            # batch and prompt length
DEC = 16                # whisper's decoder tokens
DEC_MAX_LEN = 24        # whisper's cache length


def make_inputs(cfg) -> dict:
    """The numpy inputs for ``cfg`` (seed 0): tokens (B, S) and, where
    the config has image patches, image_embeds (B, P, d_model); for an
    encoder-decoder, enc_embeds (B, S, d_model) and dec_tokens (B, 16)."""
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        return {"enc_embeds": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "dec_tokens": rng.integers(
                    0, cfg.vocab_size, size=(B, DEC)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  size=(B, S)).astype(np.int32)}
    if cfg.num_image_patches:
        out["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_patches, cfg.d_model)).astype(np.float32)
    return out


@torch.no_grad()
def run_arch(arch: str, device="cuda", attention_impl: str = "auto",
             inputs=None, *, dtype=None, model=None):
    """``arch`` at ``reduced_config`` (``dtype`` replacing the config's)
    with random weights from seed 0 on ``device``, or ``model`` when
    given: loss, prefill and one greedy decode step on ``inputs``
    (``make_inputs(cfg)`` by default), shapes and finite values asserted.
    Returns (loss, decode logits (B, V) fp32 on the CPU)."""
    if model is None:
        cfg = reduced_config(get_config(arch))
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        model = build_model(
            cfg, attention_impl=attention_impl, device=device,
            generator=torch.Generator(device=device).manual_seed(0))
    cfg = model.cfg
    if inputs is None:
        inputs = make_inputs(cfg)
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in inputs.items()}
    loss, _ = model.loss(batch)
    loss = float(loss)
    assert math.isfinite(loss), (arch, loss)
    if cfg.family == "encdec":
        logits, cache, lengths = model.prefill(
            batch["enc_embeds"], batch["dec_tokens"], max_len=DEC_MAX_LEN)
    else:
        logits, cache, lengths = model.prefill(
            batch["tokens"], max_len=S + 8,
            image_embeds=batch.get("image_embeds"))
    nxt = torch.argmax(logits, -1).to(torch.int32)
    logits2, cache, lengths = model.decode_step(cache, nxt, lengths)
    logits2 = logits2.float().cpu()
    assert logits2.shape == (B, cfg.vocab_size), (arch, logits2.shape)
    assert bool(torch.isfinite(logits2).all()), arch
    return loss, logits2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    for arch in ARCH_IDS:
        loss, _ = run_arch(arch, args.device)
        print(f"OK {arch:28s} loss={loss:.4f}", flush=True)
    print("all smoke OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
