"""Sharded prefill and decode steps — the serve counterpart of
``train/trainer.py::sharded_train_step``, and the port of the SPMD
programs that the reference's dry run lowers for its serve cells
(``jax.jit(model.prefill / model.decode_step, in_shardings=...)`` under
``RULES_SERVE``, or ``RULES_SERVE_LONG`` for ``long_500k``).

The weights are this rank's slices, laid out by the rules
(``serve_shardings``, ``place_params``: ``embed`` over data as FSDP
storage, heads / kv heads / mlp / vocab / experts over model).  A step
gathers each weight over the axes other than 'model' at use, and over
'model' too unless the forward computes with its slice
(``DecoderLM.tp_leaves``: GQA attention, whose heads run K8 per rank, the
dense MLPs and the vocabulary, their partial outputs summed over 'model';
an ``EncDecLM`` computes with every weight whole).  The inputs are the
host batch, the same on every rank; ``shard_batch`` keeps this rank's
rows by the batch rule.

The cache is laid out by the model's ``cache_axes`` under the same rules.
``spec_for`` gives mesh axes to dims in order, so a cache's slots
(``cache_seq``) take 'model' (and, under ``RULES_SERVE_LONG``, 'pod' and
'data') before its kv heads could: every rank holds its rows' range of
each leaf's slots, and an SSM layer's conv and state split by channels
and heads.  The models read this layout from the activation sharder
(``set_activation_sharder(mesh, rows, heads, cache)``): ``prefill`` keeps
each rank's range of slots, and a decode step attends over them and
merges the ranks' partial softmaxes (``layers.merge_partials``), K7
giving each rank's log-sum-exp.  Both steps compute the unsharded
``prefill`` / ``decode_step`` (the same function, up to the order of
floating-point sums), and return this rank's rows: (logits (B_local, V),
the cache — this rank's slices, written in place by a decode step —,
lengths (B_local,)).  With no mesh they are the unsharded entry points on
the weights given.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.data.pipeline import shard_batch
from repro_torch.models.convert import master_params, module_params
from repro_torch.parallel.collectives import gather_over
from repro_torch.parallel.sharding import (RULES_SERVE, Sharding,
                                           batch_rows, compute_weight,
                                           set_activation_sharder, tp_dims)


class ServeShardings(NamedTuple):
    params: Dict[str, Sharding]
    cache: Dict[str, Sharding]       # empty without a cache geometry


def _encdec(model) -> bool:
    return model.cfg.family == "encdec"


def cache_shapes(model, batch: int, max_len: int,
                 enc_len: Optional[int] = None) -> Dict[str, tuple]:
    """{leaf: whole shape} of the slotted cache (an encoder-decoder's of
    ``enc_len`` encoder positions)."""
    specs = (model.cache_specs(batch, max_len, enc_len) if _encdec(model)
             else model.cache_specs(batch, max_len))
    return {k: tuple(s) for k, (s, _) in specs.items()}


def serve_shardings(model, mesh, rules=RULES_SERVE,
                    batch: Optional[int] = None,
                    max_len: Optional[int] = None,
                    enc_len: Optional[int] = None) -> ServeShardings:
    """A ``Sharding`` for every weight (its logical axes) and, given the
    cache's geometry, every cache leaf (``cache_axes``), by ``rules``."""
    axes, shapes = model.logical_axes(), model.init_shapes()
    params = {k: rules.sharding_for(axes[k], v.shape, mesh)
              for k, v in shapes.items()}
    cache = {}
    if batch is not None:
        c_axes = model.cache_axes()
        cache = {k: rules.sharding_for(c_axes[k], s, mesh)
                 for k, s in cache_shapes(model, batch, max_len,
                                          enc_len).items()}
    return ServeShardings(params, cache)


def place_params(model, shardings: Dict[str, Sharding]) -> dict:
    """This rank's slices of the model's weights (its dtype, the
    reference's flat layout): no communication."""
    return {k: shardings[k].place(v)
            for k, v in master_params(model, model.dtype).items()}


def unshard_cache(cache: dict, shardings: Dict[str, Sharding]) -> dict:
    """The whole cache from every rank's slices (collective over the
    mesh): the one-rank layout."""
    return {k: shardings[k].unshard(v) for k, v in cache.items()}


def gather_batch(t: torch.Tensor, mesh, rules, batch: int) -> torch.Tensor:
    """The whole batch of ``batch`` rows from each rank's rows ``t`` (e.g.
    the next tokens that a step's logits give): all-gathers over the
    batch rule's mesh dims."""
    return gather_over(t, mesh, batch_rows(rules, mesh, batch), 0)


class _Call(nn.Module):
    """``model.<method>(*args, **kw)`` as a module call, so that
    ``functional_call`` binds the weights given for the call's length."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, method, args, kw):
        return getattr(self.model, method)(*args, **kw)


def _bind(model, params: dict, method: str, *args, **kw):
    bound = {f"model.{k}": v for k, v in module_params(model,
                                                        params).items()}
    return torch.func.functional_call(_Call(model), bound, (method, args, kw),
                                      strict=True)


def _weights(model, shardings: Dict[str, Sharding]):
    """compute(name, local) -> the weight a rank computes with
    (``compute_weight``: gathered at use, its 'model' slice kept where the
    forward computes with it)."""
    keeps = tp_dims(model, shardings)
    return lambda name, local: compute_weight(local, shardings[name],
                                              keeps[name])


def _on(model, batch: dict) -> dict:
    return {k: (v.to(model.device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(v, device=model.device))
            for k, v in batch.items()}


def _prefill_call(model, params, batch, max_len, lengths):
    if _encdec(model):
        return _bind(model, params, "prefill", batch["enc_embeds"],
                     batch["dec_tokens"], max_len=max_len)
    return _bind(model, params, "prefill", batch["tokens"],
                 image_embeds=batch.get("image_embeds"), max_len=max_len,
                 lengths=lengths)


def _layout(model, mesh, rules, batch, max_len, enc_len):
    """(rows, heads, cache shardings) of one step's shapes."""
    heads = rules.spec_for(("heads",), (model.cfg.num_heads,), mesh)
    heads = () if not heads else (heads[0] if isinstance(heads[0], tuple)
                                  else (heads[0],))
    cache = serve_shardings(model, mesh, rules, batch, max_len,
                            enc_len).cache
    return batch_rows(rules, mesh, batch), heads, cache


def sharded_prefill_step(model, mesh=None, rules=RULES_SERVE):
    """step(params, batch, *, max_len=None, lengths=None) -> (logits,
    cache, lengths) of this rank's rows.  ``batch``: {"tokens" (B, S)
    [, "image_embeds" (B, P, D)]} or an encoder-decoder's {"enc_embeds",
    "dec_tokens"}, the host batch; ``lengths`` (B,) a right-padded batch's
    true lengths.  The cache holds ``max_len`` positions (default: the
    prompt's, patches included; an encoder-decoder's decoder tokens)."""
    if mesh is not None:
        compute = _weights(model, serve_shardings(model, mesh,
                                                  rules).params)

    def step(params, batch, *, max_len=None, lengths=None):
        if mesh is None:
            b = _on(model, batch)
            ln = None if lengths is None else _on(model, {"l": lengths})["l"]
            return _prefill_call(model, params, b, max_len, ln)
        if _encdec(model):
            B, S = batch["dec_tokens"].shape[:2]
            enc_len = batch["enc_embeds"].shape[1]
        else:
            B, S = batch["tokens"].shape[:2]
            S += (batch["image_embeds"].shape[1]
                  if batch.get("image_embeds") is not None else 0)
            enc_len = None
        max_len = max_len or S
        host = dict(batch)
        if lengths is not None:
            host["lengths"] = lengths
        local = shard_batch(host, mesh, rules, model.device)
        weights = {k: compute(k, v) for k, v in params.items()}
        with set_activation_sharder(mesh, *_layout(model, mesh, rules, B,
                                                   max_len, enc_len)):
            return _prefill_call(model, weights, local, max_len,
                                 local.get("lengths"))

    return step


def sharded_decode_step(model, mesh=None, rules=RULES_SERVE, *,
                        max_len: Optional[int] = None,
                        enc_len: Optional[int] = None):
    """step(params, cache, tokens, lengths) -> (logits, cache, lengths + 1)
    of this rank's rows.  ``tokens`` / ``lengths`` (B,): the host batch;
    ``cache``: this rank's slices of a cache of ``max_len`` positions (an
    encoder-decoder's cross cache of ``enc_len``), as the sharded prefill
    left it, written in place."""
    if mesh is not None:
        assert max_len is not None, "a sharded decode step needs max_len"
        compute = _weights(model, serve_shardings(model, mesh,
                                                  rules).params)

    def step(params, cache, tokens, lengths):
        if mesh is None:
            b = _on(model, {"t": tokens, "l": lengths})
            return _bind(model, params, "decode_step", cache, b["t"], b["l"])
        B = int(tokens.shape[0])
        local = shard_batch({"tokens": tokens, "lengths": lengths}, mesh,
                            rules, model.device)
        weights = {k: compute(k, v) for k, v in params.items()}
        with set_activation_sharder(mesh, *_layout(model, mesh, rules, B,
                                                   max_len, enc_len)):
            return _bind(model, weights, "decode_step", cache,
                         local["tokens"], local["lengths"])

    return step
