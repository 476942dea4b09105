"""Whisper-style encoder-decoder — the port of ``repro/models/encdec.py``.

The conv/mel front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  LayerNorm with bias,
the GELU MLP, sinusoidal positions in the encoder and learned ones in the
decoder; the attention projections have biases on q, v and out (none on
k), all heads full (MHA).  The encoder attends without a mask, the
decoder causally over itself and fully over the encoder's output.
Attention is plain PyTorch, q-chunked once a sequence reaches
``CHUNKED_ATTN_THRESHOLD`` (``layers.plain_attention``): the reference
computes it with einsums, outside any Pallas kernel.

``EncDecLM`` is an ``nn.Module`` with one module per layer.  Weights keep
the reference's names and layouts (``enc/l/attn/wq`` (D, H, Dh), ...);
the reference stacks every ``enc/l/`` and ``dec/l/`` leaf over its layers,
and ``leaves`` gives each its layer index, so ``models/convert.py`` moves
weights across as for ``DecoderLM``.  Serving: ``prefill`` encodes,
projects each decoder layer's cross K/V once and fills the decoder's self
K/V; ``decode_step`` writes one token's K/V in place (a row whose length
has reached the cache drops its write, as JAX's scatter does) and
attends.  The serving engine does not take this model, as in the
reference, whose engine asks ``cache_specs(1, max_len)``.  Under the
sharded serve steps (``serving/sharded.py``; every weight gathered whole,
as the model has no tensor-parallel layer) ``prefill`` runs the rank's
rows and keeps its range of each cache leaf's slots, and ``decode_step``
attends over them: the self-attention over the rank's slots at or before
``lengths`` and the cross attention over its encoder positions, each
with ``layers.partial_attention`` and ``layers.merge_partials``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import serve_sharder


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding (length, channels), fp32."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def _params(module: nn.Module, shapes: dict, dtype, device) -> None:
    for name, shape in shapes.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))


class _Attn(nn.Module):
    """One attention's projections: wq, wk, wv (D, H, Dh), wo (H, Dh, D)
    and the biases bq, bv (H, Dh), bo (D,)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        D, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        _params(self, {"wq": (D, H, Dh), "bq": (H, Dh), "wk": (D, H, Dh),
                       "wv": (D, H, Dh), "bv": (H, Dh), "wo": (H, Dh, D),
                       "bo": (D,)}, dtype, device)

    def q(self, x):
        return torch.einsum("bsd,dhe->bshe", x, self.wq) + self.bq

    def kv(self, x):
        return (torch.einsum("bsd,dhe->bshe", x, self.wk),
                torch.einsum("bsd,dhe->bshe", x, self.wv) + self.bv)

    def out(self, attn):
        return torch.einsum("bshe,hed->bsd", attn, self.wo) + self.bo


class _LN(nn.Module):
    def __init__(self, D, dtype, device):
        super().__init__()
        _params(self, {"w": (D,), "b": (D,)}, dtype, device)

    def forward(self, x, eps):
        return L.layer_norm(x, self.w, self.b, eps)


class _MLP(nn.Module):
    """The GELU MLP: w_in (D, F), b_in (F,), w_out (F, D), b_out (D,)."""

    def __init__(self, D, F, dtype, device):
        super().__init__()
        _params(self, {"w_in": (D, F), "b_in": (F,), "w_out": (F, D),
                       "b_out": (D,)}, dtype, device)


# reference path component -> submodule attribute
SUBMODULE = {"self": "self_attn"}
# a leaf's init by its parameter name ("normal" when not listed)
_INIT = {"w": "ones", "b": "zeros", "bq": "zeros", "bv": "zeros",
         "bo": "zeros", "b_in": "zeros", "b_out": "zeros"}


# logical axes: the top-level leaves by name, a layer's by its parameter
# name (a layer norm's w / b and a projection's bias on "embed")
ENC_DEC_TOP_AXES = {"embed/tokens": ("vocab", "embed"),
                    "embed/dec_pos": ("cache_seq", "embed")}
ENC_DEC_AXES = {"w": ("embed",), "b": ("embed",), "bo": ("embed",),
                "wq": ("embed", "heads", "qk_dim"),
                "wk": ("embed", "heads", "qk_dim"),
                "wv": ("embed", "heads", "qk_dim"),
                "bq": ("heads", "qk_dim"), "bv": ("heads", "qk_dim"),
                "wo": ("heads", "qk_dim", "embed"),
                "w_in": ("embed", "mlp"), "b_in": ("mlp",),
                "w_out": ("mlp", "embed"), "b_out": ("embed",)}


class _Layer(nn.Module):
    """One encoder layer (attn_ln, attn, mlp_ln, mlp) or decoder layer
    (self_ln, self, cross_ln, cross, mlp_ln, mlp), submodules named by
    the reference's path component (``self`` is held as ``self_attn``)."""

    def __init__(self, cfg, dtype, device, decoder: bool):
        super().__init__()
        D = cfg.d_model
        attns = ("self", "cross") if decoder else ("attn",)
        for a in attns:
            self.add_module(f"{a}_ln", _LN(D, dtype, device))
            self.add_module(SUBMODULE.get(a, a), _Attn(cfg, dtype, device))
        self.mlp_ln = _LN(D, dtype, device)
        self.mlp = _MLP(D, cfg.d_ff, dtype, device)


class EncDecLM(nn.Module):
    """Encoder-decoder LM with the reference's ``encode`` /
    ``decode_full`` / ``forward`` / ``loss`` / ``prefill`` /
    ``decode_step``."""

    MAX_DEC_POSITIONS = 32768  # as the reference: covers decode_32k

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.encdec is None:
            raise ValueError(f"{cfg.name} has no encdec config: "
                             "build_model gives it a DecoderLM")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        dev, dt = self.device, self.dtype
        _params(self, {"embed_tokens": (cfg.vocab_size, cfg.d_model),
                       "dec_pos": (self.MAX_DEC_POSITIONS, cfg.d_model)},
                dt, dev)
        self.enc_final_ln = _LN(cfg.d_model, dt, dev)
        self.dec_final_ln = _LN(cfg.d_model, dt, dev)
        self.enc_layers = nn.ModuleList(
            _Layer(cfg, dt, dev, decoder=False)
            for _ in range(cfg.encdec.num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            _Layer(cfg, dt, dev, decoder=True)
            for _ in range(cfg.num_layers))

    # ------------------------------------------------------------------
    def leaves(self):
        """(reference name, layer index or None, attr owner, attr, init)
        for every weight, as ``DecoderLM.leaves``: ``enc/l/`` and
        ``dec/l/`` leaves carry their layer index (the reference stacks
        them whatever the depth)."""
        yield "embed/tokens", None, self, "embed_tokens", "normal"
        yield "embed/dec_pos", None, self, "dec_pos", "normal"
        for side in ("enc", "dec"):
            ln = getattr(self, f"{side}_final_ln")
            for p in ("w", "b"):
                yield f"{side}/final_ln/{p}", None, ln, p, _INIT[p]
            for r, layer in enumerate(getattr(self, f"{side}_layers")):
                for sub, mod in layer.named_children():
                    ref = next((k for k, v in SUBMODULE.items()
                                if v == sub), sub)
                    for p, _ in mod.named_parameters(recurse=False):
                        yield (f"{side}/l/{ref}/{p}", r, mod, p,
                               _INIT.get(p, "normal"))

    def logical_axes(self) -> Dict[str, tuple]:
        """{reference name: logical axes}, layer leaves stacked, as the
        reference's ``logical_axes``."""
        return L.leaf_layout(self, self._axes_of)[0]

    def param_specs(self) -> Dict[str, L.ParamSpec]:
        """{reference name: ``ParamSpec``} of every weight, repeats
        stacked, as the reference's ``param_specs``."""
        return L.param_specs(self, self._axes_of)

    def init_shapes(self) -> Dict[str, L.ShapeDtype]:
        """{reference name: ``ShapeDtype``}, as the reference's
        ``init_shapes``."""
        return L.leaf_layout(self, self._axes_of)[1]

    @staticmethod
    def _axes_of(name: str) -> tuple:
        if name in ENC_DEC_TOP_AXES:
            return ENC_DEC_TOP_AXES[name]
        return ENC_DEC_AXES[name.rsplit("/", 1)[1]]

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights at the reference initializer's distribution (as
        ``DecoderLM.init``; the reference's salted keys cannot be
        re-derived, so parity runs convert its weights instead)."""
        for _, _, owner, attr, init in self.leaves():
            p = getattr(owner, attr)
            p.copy_(L.init_leaf(tuple(p.shape), init, p.dtype, generator,
                                p.device))
        return self

    # ------------------------------------------------------------------
    def _layer_remat(self) -> bool:
        """The reference's scanned layers run under ``jax.checkpoint``
        unless ``remat == "nothing"``; rematerialise them likewise when
        differentiating."""
        return (self.cfg.scan_layers and self.cfg.remat != "nothing"
                and torch.is_grad_enabled())

    def _run(self, body, layers, x, *extra):
        remat = self._layer_remat()
        for layer in layers:
            x = (checkpoint(body, layer, x, *extra, use_reentrant=False)
                 if remat else body(layer, x, *extra))
        return x

    def _enc_layer(self, layer, x):
        eps = self.cfg.norm_eps
        h = layer.attn_ln(x, eps)
        q, (k, v) = layer.attn.q(h), layer.attn.kv(h)
        x = x + layer.attn.out(L.plain_attention(q, k, v, causal=False))
        h = layer.mlp_ln(x, eps)
        return x + L.gelu_mlp_apply(layer.mlp, h)

    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds (B, S_enc, D), precomputed frame embeddings ->
        (B, S_enc, D)."""
        x = enc_embeds.to(device=self.device, dtype=self.dtype)
        x = x + sinusoids(x.shape[1], self.cfg.d_model,
                          self.device).to(self.dtype)[None]
        x = self._run(self._enc_layer, self.enc_layers, x)
        return self.enc_final_ln(x, self.cfg.norm_eps)

    def _dec_layer(self, layer, x, enc_out):
        eps = self.cfg.norm_eps
        h = layer.self_ln(x, eps)
        sa = layer.self_attn
        x = x + sa.out(L.plain_attention(sa.q(h), *sa.kv(h), causal=True))
        h = layer.cross_ln(x, eps)
        ca = layer.cross
        x = x + ca.out(L.plain_attention(ca.q(h), *ca.kv(enc_out),
                                         causal=False))
        h = layer.mlp_ln(x, eps)
        return x + L.gelu_mlp_apply(layer.mlp, h)

    def _logits(self, x):
        x = self.dec_final_ln(x, self.cfg.norm_eps)
        return torch.einsum("bsd,vd->bsv", x, self.embed_tokens)

    def decode_full(self, enc_out: torch.Tensor,
                    dec_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder pass: logits (B, Sd, V)."""
        Sd = dec_tokens.shape[1]
        x = self.embed_tokens[dec_tokens.long()] + self.dec_pos[:Sd][None]
        x = self._run(self._dec_layer, self.dec_layers, x, enc_out)
        return self._logits(x)

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: enc_embeds (B, S_enc, D), dec_tokens (B, Sd) ->
        logits (B, Sd, V)."""
        return self.decode_full(self.encode(batch["enc_embeds"]),
                                batch["dec_tokens"])

    def loss(self, batch: dict):
        """Mean next-token CE of the decoder tokens; (loss, {loss,
        aux_loss (zero), total_loss})."""
        logits = self.forward(batch).float()[:, :-1]
        targets = batch["dec_tokens"][:, 1:].long()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        loss = (logz - tgt).mean()
        return loss, {"loss": loss,
                      "aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=loss.device),
                      "total_loss": loss}

    # ------------------------------------------------------------------
    # Serving: prefill computes the encoder states and cross K/V, then
    # decode steps.
    # ------------------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, enc_len: int
                    ) -> Dict[str, tuple]:
        """(shape, dtype) of the cache leaves: the decoder's self K/V
        (layers, B, max_len, H, Dh) and the cross K/V (layers, B, S_enc,
        H, Dh)."""
        cfg = self.cfg
        nd, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
        self_kv = ((nd, batch, max_len, H, Dh), self.dtype)
        cross = ((nd, batch, enc_len, H, Dh), self.dtype)
        return {"dec/k": self_kv, "dec/v": self_kv, "cross/k": cross,
                "cross/v": cross}

    def cache_axes(self) -> Dict[str, tuple]:
        """Logical axes of each cache leaf, under ``cache_specs``'s
        names."""
        a = ("layers", "batch", "cache_seq", "heads", "qk_dim")
        return {"dec/k": a, "dec/v": a, "cross/k": a, "cross/v": a}

    @torch.no_grad()
    def prefill(self, enc_embeds: torch.Tensor, dec_tokens: torch.Tensor, *,
                max_len: Optional[int] = None):
        """Encode and run the teacher-forced decoder prefill.  Returns
        (last logits (B, V), cache, lengths (B,) = Sd)."""
        B, Sd = dec_tokens.shape
        max_len = max_len or Sd
        enc_out = self.encode(enc_embeds)
        sh = serve_sharder()
        cache = {k: torch.zeros(s if sh is None else sh.local_shape(k, s),
                                dtype=d, device=self.device)
                 for k, (s, d) in self.cache_specs(
                     B, max_len, enc_out.shape[1]).items()}

        def fill(name, i, val):          # this rank's slots of positions
            leaf = cache[name][i]
            n = leaf.shape[1]
            lo = 0 if sh is None else sh.slot_range(name, n)[0]
            m = max(0, min(val.shape[1] - lo, n))
            leaf[:, :m] = val[:, lo:lo + m]

        x = self.embed_tokens[dec_tokens.long()] + self.dec_pos[:Sd][None]
        eps = self.cfg.norm_eps
        for i, layer in enumerate(self.dec_layers):
            ck, cv = layer.cross.kv(enc_out)
            fill("cross/k", i, ck)
            fill("cross/v", i, cv)
            sa = layer.self_attn
            h = layer.self_ln(x, eps)
            k, v = sa.kv(h)
            fill("dec/k", i, k)
            fill("dec/v", i, v)
            x = x + sa.out(L.plain_attention(sa.q(h), k, v, causal=True))
            h = layer.cross_ln(x, eps)
            x = x + layer.cross.out(L.plain_attention(
                layer.cross.q(h), ck, cv, causal=False))
            h = layer.mlp_ln(x, eps)
            x = x + L.gelu_mlp_apply(layer.mlp, h)
        logits = self._logits(x[:, -1:])[:, 0]
        return logits, cache, torch.full((B,), Sd, dtype=torch.int32,
                                         device=self.device)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor):
        """One decode step: tokens (B,) at positions ``lengths`` (B,).
        Each layer writes the token's K/V at slot ``lengths`` in place (a
        row at or past the cache's end drops it) and attends over the
        slots at or before it, then over the encoder's cross K/V.
        Returns (logits (B, V), cache — the same dict —, lengths + 1)."""
        dev = self.device
        tokens, lengths = tokens.to(dev), lengths.to(dev)
        pos = lengths.long().clamp(0, self.MAX_DEC_POSITIONS - 1)
        x = (self.embed_tokens[tokens.long()] + self.dec_pos[pos])[:, None]
        sh = serve_sharder()
        if sh is not None:
            x = self._sharded_decode_layers(sh, x, cache, lengths)
            return self._logits(x)[:, 0], cache, lengths + 1
        Sk = cache["dec/k"].shape[2]
        mask = (torch.arange(Sk, device=dev)[None, :]
                <= lengths.long()[:, None])[:, None, :]
        rows = (lengths.long() < Sk).nonzero().squeeze(1)
        slots = lengths.long()[rows]
        eps = self.cfg.norm_eps
        for i, layer in enumerate(self.dec_layers):
            sa = layer.self_attn
            h = layer.self_ln(x, eps)
            k, v = sa.kv(h)
            kc, vc = cache["dec/k"][i], cache["dec/v"][i]
            kc[rows, slots] = k[rows, 0]                         # in place
            vc[rows, slots] = v[rows, 0]
            x = x + sa.out(L.gqa_attention(sa.q(h), kc, vc, mask))
            h = layer.cross_ln(x, eps)
            x = x + layer.cross.out(L.mha_cross_attention(
                layer.cross.q(h), cache["cross/k"][i], cache["cross/v"][i]))
            h = layer.mlp_ln(x, eps)
            x = x + L.gelu_mlp_apply(layer.mlp, h)
        return self._logits(x)[:, 0], cache, lengths + 1

    def _sharded_decode_layers(self, sh, x, cache, lengths):
        """``decode_step``'s layers over this rank's slots [lo, lo + n) of
        the self cache's Sk (a row at or past Sk drops its write, as the
        reference's scatter does) and its range of the encoder positions,
        merged over the slot dims (``layers.merge_partials``)."""
        mesh, eps = sh.mesh, self.cfg.norm_eps
        n = cache["dec/k"].shape[2]
        lo, _ = sh.slot_range("dec/k", n)
        rows = torch.arange(x.shape[0], device=x.device)
        at = lengths.long() - lo
        mine = ((at >= 0) & (at < n))[:, None, None]
        at = at.clamp(0, n - 1)
        kpos = lo + torch.arange(n, device=x.device)
        valid = (kpos[None, :] <= lengths.long()[:, None])[:, None, :]
        n_enc = cache["cross/k"].shape[2]
        every = torch.ones((1, 1, n_enc), dtype=torch.bool, device=x.device)
        for i, layer in enumerate(self.dec_layers):
            sa = layer.self_attn
            h = layer.self_ln(x, eps)
            k, v = sa.kv(h)
            kc, vc = cache["dec/k"][i], cache["dec/v"][i]
            kc[rows, at] = torch.where(mine, k[:, 0], kc[rows, at])
            vc[rows, at] = torch.where(mine, v[:, 0], vc[rows, at])
            attn = L.merge_partials(*L.partial_attention(sa.q(h), kc, vc,
                                                         valid),
                                    mesh, sh.slots("dec/k"))
            x = x + sa.out(attn)
            h = layer.cross_ln(x, eps)
            ca = layer.cross
            attn = L.merge_partials(*L.partial_attention(
                ca.q(h), cache["cross/k"][i], cache["cross/v"][i], every),
                mesh, sh.slots("cross/k"))
            x = x + ca.out(attn)
            h = layer.mlp_ln(x, eps)
            x = x + L.gelu_mlp_apply(layer.mlp, h)
        return x
