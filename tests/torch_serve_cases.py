"""The sharded serve steps' cases (``serving/sharded.py``), run on four CPU
``gloo`` ranks spawned by ``torch_multicard_cases.run_world``: each rank
runs the sharded prefill and greedy decode steps of every case of its
world, and rank 0 also the one-rank ``prefill`` / ``decode_step`` on the
same weights.  The test modules hold the results against each other and
against the JAX package in the parent.  This module imports torch and
``repro_torch`` only, so the spawned ranks never load JAX."""
import dataclasses

import numpy as np
import torch

# name: (config, config fields replaced, moe_impl, rules, geometry)
#   geometry: B rows, S prompt tokens, max_len, steps, and optionally the
#   right-padded rows' lengths and whisper's encoder frames (enc)
CASES = {
    "llama": ("llama3.2-1b", {}, None, "serve",
              dict(B=4, S=12, max_len=32, steps=8, lengths=(12, 9, 12, 5))),
    "llama-long": ("llama3.2-1b", {}, None, "long",
                   dict(B=2, S=12, max_len=32, steps=8)),
    "h2o-long": ("h2o-danube3-4b", {}, None, "long",
                 dict(B=2, S=20, max_len=32, steps=8)),
    "granite-20b": ("granite-20b", {}, None, "serve",
                    dict(B=4, S=12, max_len=32, steps=8)),
    "qwen2": ("qwen2-72b", {}, None, "serve",
              dict(B=4, S=12, max_len=32, steps=8)),
    "moe-dropless": ("granite-moe-3b-a800m", {}, "dropless", "serve",
                     dict(B=4, S=12, max_len=32, steps=8)),
    "llava": ("llava-next-34b", {}, None, "serve",
              dict(B=4, S=8, max_len=32, steps=8)),
    "mla": ("deepseek-v2-lite-16b", {}, None, "serve",
            dict(B=4, S=12, max_len=32, steps=8)),
    "ssm": ("mamba2-2.7b", {}, None, "serve",
            dict(B=4, S=12, max_len=32, steps=8)),
    "hybrid": ("jamba-v0.1-52b", {}, None, "serve",
               dict(B=4, S=12, max_len=32, steps=8)),
    "whisper": ("whisper-small", {}, None, "serve",
                dict(B=4, S=6, max_len=16, steps=8, enc=16)),
}


def config(name):
    """The case's reduced config, fp32."""
    from repro_torch.configs import get_config, reduced_config
    arch, repl, _, _, _ = CASES[name]
    return dataclasses.replace(reduced_config(get_config(arch)),
                               dtype="float32", **repl)


def inputs(name, cfg):
    """(host batch, lengths or None) of the case, numpy, from seed 3."""
    g = CASES[name][4]
    rng = np.random.default_rng(3)
    B, S = g["B"], g["S"]
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.family == "encdec":
        enc = rng.standard_normal((B, g["enc"], cfg.d_model)).astype(
            np.float32)
        return {"enc_embeds": enc, "dec_tokens": toks}, None
    batch = {"tokens": toks}
    if cfg.num_image_patches:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.num_image_patches, cfg.d_model)).astype(np.float32)
    lengths = g.get("lengths")
    return batch, None if lengths is None else np.asarray(lengths, np.int32)


def prompt_len(name, cfg) -> int:
    g = CASES[name][4]
    return g["S"] + (cfg.num_image_patches or 0)


def _np(t):
    return t.detach().cpu().numpy()


def _one_rank(model, batch, lengths, g):
    """The unsharded prefill and greedy decode: (logits per step, tokens
    per step, the cache)."""
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "enc_embeds" in t:
        lg, cache, ln = model.prefill(t["enc_embeds"], t["dec_tokens"],
                                      max_len=g["max_len"])
    else:
        lg, cache, ln = model.prefill(
            t["tokens"], image_embeds=t.get("image_embeds"),
            max_len=g["max_len"],
            lengths=None if lengths is None else torch.from_numpy(lengths))
    logits, toks = [_np(lg)], []
    for _ in range(g["steps"]):
        tok = lg.argmax(-1).to(torch.int32)
        toks.append(_np(tok))
        lg, cache, ln = model.decode_step(cache, tok, ln)
        logits.append(_np(lg))
    return logits, toks, {k: _np(v) for k, v in cache.items()}


def serve_cases(rank, names, params):
    """Every case of ``names`` on (data 2, model 2): the sharded prefill
    and ``steps`` greedy decode steps, each step's logits and tokens
    gathered whole, the cache unsharded at the end; on rank 0 also the
    one-rank run."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax
    from repro_torch.parallel.sharding import RULES_SERVE, RULES_SERVE_LONG
    from repro_torch.serving.sharded import (gather_batch, place_params,
                                             serve_shardings,
                                             sharded_decode_step,
                                             sharded_prefill_step,
                                             unshard_cache)

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name in names:
        _, _, moe_impl, rules_name, g = CASES[name]
        rules = RULES_SERVE_LONG if rules_name == "long" else RULES_SERVE
        cfg = config(name)
        model = build_model(cfg, device="cpu", moe_impl=moe_impl)
        params_from_jax(params[name], model)
        batch, lengths = inputs(name, cfg)
        B = g["B"]
        enc = g.get("enc")
        sh = serve_shardings(model, mesh, rules, B, g["max_len"], enc)
        weights = place_params(model, sh.params)
        prefill = sharded_prefill_step(model, mesh, rules)
        decode = sharded_decode_step(model, mesh, rules,
                                     max_len=g["max_len"], enc_len=enc)
        lg, cache, _ = prefill(weights, batch, max_len=g["max_len"],
                               lengths=lengths)
        ln = (np.full((B,), prompt_len(name, cfg), np.int32)
              if lengths is None else lengths.copy())
        logits, toks = [_np(gather_batch(lg, mesh, rules, B))], []
        for _ in range(g["steps"]):
            tok = gather_batch(lg.argmax(-1).to(torch.int32), mesh, rules, B)
            toks.append(_np(tok))
            lg, cache, _ = decode(weights, cache, tok, torch.from_numpy(ln))
            ln = ln + 1
            logits.append(_np(gather_batch(lg, mesh, rules, B)))
        whole = {k: _np(v) for k, v in unshard_cache(cache,
                                                     sh.cache).items()}
        row = {"logits": logits, "tokens": toks,
               "local": {k: tuple(v.shape) for k, v in cache.items()},
               "specs": {k: v.spec for k, v in sh.cache.items()}}
        if rank == 0:
            row["cache"] = whole
            row["one"] = _one_rank(model, batch, lengths, g)
        out[name] = row
    return out
