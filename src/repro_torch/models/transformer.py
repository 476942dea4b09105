"""Decoder-only LM, attention families — the port of
``repro/models/transformer.py``.

``DecoderLM`` is an ``nn.Module`` holding one ``DecoderBlock`` per layer,
with every weight in the reference's layout (``wq`` (D, H, Dh), ``wo``
(H, Dh, D), ...), so ``models/convert.py`` moves weights across by name.
Attention is GQA (MQA included), full or sliding-window, with optional
QKV biases; each layer's MLP is dense (gated SiLU or the two-matrix GELU,
by ``cfg.mlp_kind``) or a mixture of experts (``moe_impl`` ``dense`` |
``dropless``; the reference's rule picks ``dropless`` from d_model 1024).
MLA, SSM, encoder-decoder and image/audio front ends raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 13), as do MoE layouts
the reference splits into several segments (leading dense layers, a
period above 1).

``attention_impl`` (``auto`` | ``cuda`` | ``ref``) picks the attention of
full sequences (``forward``, ``forward_hidden``, ``prefill``: the
flash-attention kernel K8) and of slotted decode steps (the flash-decode
kernel K7), or their plain versions; ``auto`` launches the kernels on
CUDA tensors.  The reference reserves the switch (``attention_impl``) and
runs XLA attention whatever its value.

The KV cache is a flat dict of stacked leaves keyed like the reference
(``blocks/0/k``: (layers, B, Sk, K, Dh) slotted, or (layers, P, page, K,
Dh) as a paged pool).  A sliding-window model keeps a ring of Sk =
min(window, max_len) slots, slot = position % Sk; ``prefill`` rotates
the last Sk positions into that order and ``decode_step`` attends over
the first min(length + 1, Sk) slots, which is exactly the reference's
slot mask (valid slots are a prefix, and a ring no longer than the window
makes the window clause hold by itself).  Where JAX returned a new cache,
``prefill_chunk`` and ``decode_step`` write the caller's leaves IN PLACE
and hand the same dict back.  JAX drops out-of-bounds scatters (the
INVALID page sink, pad tokens); PyTorch raises, so each dispatch computes
its kept write targets once (one host sync) and writes only those.  JAX
clamps out-of-bounds gathers; the gathered view (``paged_gather_view``)
clamps INVALID entries to page P - 1 explicitly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_gather_view)
from repro_torch.models import layers as L

INVALID_PAGE = 2 ** 30

# reference param name suffix (under "blocks/0/") -> (DecoderBlock attr, init)
BLOCK_LEAVES = {
    "attn_norm": ("attn_norm", "ones"),
    "attn/wq": ("wq", "normal"),
    "attn/wk": ("wk", "normal"),
    "attn/wv": ("wv", "normal"),
    "attn/wo": ("wo", "normal"),
    "attn/bq": ("bq", "zeros"),
    "attn/bk": ("bk", "zeros"),
    "attn/bv": ("bv", "zeros"),
    "mlp_norm": ("mlp_norm", "ones"),
    "mlp/w_gate": ("w_gate", "normal"),
    "mlp/w_up": ("w_up", "normal"),
    "mlp/w_down": ("w_down", "normal"),
    "mlp/w_in": ("w_in", "normal"),
    "mlp/b_in": ("b_in", "zeros"),
    "mlp/w_out": ("w_out", "normal"),
    "mlp/b_out": ("b_out", "zeros"),
    "moe/router": ("router", "small_normal"),
    "moe/we_gate": ("we_gate", "normal"),
    "moe/we_up": ("we_up", "normal"),
    "moe/we_down": ("we_down", "normal"),
    "moe/shared/w_gate": ("shared_w_gate", "normal"),
    "moe/shared/w_up": ("shared_w_up", "normal"),
    "moe/shared/w_down": ("shared_w_down", "normal"),
}
# top-level reference param name -> (DecoderLM attr, init)
TOP_LEAVES = {
    "embed/tokens": ("embed_tokens", "normal"),
    "final_norm/w": ("final_norm", "ones"),
    "head/w": ("head", "normal"),
}


def _check_ported(cfg: ModelConfig) -> None:
    m = cfg.moe
    unported = {"mla": cfg.mla is not None,
                "ssm": cfg.ssm is not None or cfg.family in ("ssm", "hybrid"),
                "encdec": cfg.encdec is not None or cfg.family == "encdec",
                "image/audio front end": bool(cfg.num_image_patches
                                              or cfg.audio_frontend),
                "moe layer pattern": m is not None and (
                    m.first_dense_layers > 0 or m.expert_layer_period != 1
                    or m.expert_layer_offset != 0)}
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(bad)} not ported yet (ROADMAP.md Queue "
            "1 item 13, other model families); the port runs GQA attention "
            "with dense or MoE MLPs in every layer")


class DecoderBlock(nn.Module):
    """One layer's weights: attention, then the MLP of its kind (gated
    SiLU, GELU with biases, or routed experts and shared experts)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device,
                 mlp: str):
        super().__init__()
        D, H, K, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff)
        self.mlp = mlp
        shapes = {"attn_norm": (D,), "wq": (D, H, Dh), "wk": (D, K, Dh),
                  "wv": (D, K, Dh), "wo": (H, Dh, D), "mlp_norm": (D,)}
        if cfg.qkv_bias:
            shapes.update(bq=(H, Dh), bk=(K, Dh), bv=(K, Dh))
        if mlp == "moe":
            m = cfg.moe
            E, Fe = m.num_experts, m.d_ff_expert
            shapes.update(router=(D, E), we_gate=(E, D, Fe),
                          we_up=(E, D, Fe), we_down=(E, Fe, D))
            if m.num_shared_experts:
                Fs = m.d_ff_shared
                shapes.update(shared_w_gate=(D, Fs), shared_w_up=(D, Fs),
                              shared_w_down=(Fs, D))
        elif cfg.mlp_kind == "gelu":
            shapes.update(w_in=(D, F), b_in=(F,), w_out=(F, D), b_out=(D,))
        else:
            shapes.update(w_gate=(D, F), w_up=(D, F), w_down=(F, D))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))


class DecoderLM(nn.Module):
    """Dense decoder-only LM with the reference's forward / prefill /
    chunked-prefill / decode entry points."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 attention_impl: str = "auto",
                 moe_impl: Optional[str] = None):
        super().__init__()
        _check_ported(cfg)
        if attention_impl not in ("auto", "cuda", "ref"):
            raise ValueError(f"attention_impl {attention_impl!r} not in "
                             "auto | cuda | ref")
        self.cfg = cfg
        self.attention_impl = attention_impl
        # the reference's rule: the dispatch einsums of ``dense`` dominate
        # at scale, so wide models take the capacity buffers
        self.moe_impl = moe_impl or ("dropless" if cfg.d_model >= 1024
                                     else "dense")
        L.check_moe_impl(self.moe_impl)
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        dev, dt = self.device, self.dtype

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=dev),
                                requires_grad=False)

        self.embed_tokens = param(cfg.vocab_size, cfg.d_model)
        self.final_norm = param(cfg.d_model)
        self.head = (None if cfg.tie_embeddings
                     else param(cfg.d_model, cfg.vocab_size))
        # each layer's MLP kind: the MLP half of the reference's sub-layer
        # signature (``build_plan``)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, dt, dev,
                         "moe" if cfg.is_moe_layer(i) else "dense")
            for i in range(cfg.num_layers))

    # ------------------------------------------------------------------
    def leaves(self):
        """(reference name, layer or None, attr owner, attr, init) for every
        weight — the one table ``init`` and ``models/convert.py`` walk."""
        for name, (attr, init) in TOP_LEAVES.items():
            if getattr(self, attr) is not None:
                yield name, None, self, attr, init
        for suffix, (attr, init) in BLOCK_LEAVES.items():
            for layer, blk in enumerate(self.layers):
                if hasattr(blk, attr):
                    yield f"blocks/0/{suffix}", layer, blk, attr, init

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights at the reference initializer's distribution, drawn
        from ``generator`` (on this model's device).  The reference folds a
        per-process-salted ``hash(name)`` into each key, so its weights
        cannot be re-derived here: parity runs convert them instead."""
        for _, _, owner, attr, init in self.leaves():
            p = getattr(owner, attr)
            p.copy_(L.init_leaf(tuple(p.shape), init, p.dtype, generator,
                                p.device))
        return self

    # ------------------------------------------------------------------
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens[tokens.long()]

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return torch.einsum("bsd,vd->bsv", x, self.embed_tokens)
        return x @ self.head

    def _mlp(self, blk, x):
        """The layer's MLP half: norm, dense MLP or experts, residual.  The
        MoE aux loss is dropped (serving; training will read it)."""
        h = L.rms_norm(x, blk.mlp_norm, self.cfg.norm_eps)
        if blk.mlp == "moe":
            y, _ = L.moe_apply(self.cfg, blk, h, impl=self.moe_impl)
            return x + y
        return x + L.dense_mlp_apply(self.cfg, blk, h)

    def _layer_fwd(self, blk, x, positions):
        cfg = self.cfg
        h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
        q, k, v = L.attention_qkv(cfg, blk, h, positions)
        attn = L.causal_attention(q, k, v, window=cfg.sliding_window,
                                  impl=self.attention_impl)
        x = x + L.attention_out(blk, attn)
        return self._mlp(blk, x), (k, v)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device)[None, :].expand(B, S)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V)."""
        x = self.embed(tokens)
        positions = self._positions(*tokens.shape)
        for blk in self.layers:
            x, _ = self._layer_fwd(blk, x, positions)
        return self.unembed(x)

    @torch.no_grad()
    def forward_hidden(self, tokens: torch.Tensor, *,
                       num_layers: int) -> torch.Tensor:
        """Embedding + the first ``num_layers`` layers: hidden (B, S, D) —
        the CoIC descriptor-prefix path."""
        x = self.embed(tokens)
        positions = self._positions(*tokens.shape)
        for blk in self.layers[:num_layers]:
            x, _ = self._layer_fwd(blk, x, positions)
        return x

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        """Slots per row: the window's ring for sliding-window attention."""
        w = self.cfg.sliding_window
        return min(w, max_len) if w > 0 else max_len

    def cache_specs(self, batch: int, max_len: int
                    ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """(shape, dtype) of the slotted decode cache leaves."""
        cfg = self.cfg
        shp = (cfg.num_layers, batch, self._cache_len(max_len),
               cfg.num_kv_heads, cfg.head_dim)
        return {"blocks/0/k": (shp, self.dtype),
                "blocks/0/v": (shp, self.dtype)}

    def paged_cache_specs(self, num_pages: int, page_size: int
                          ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """(shape, dtype) of the paged pool leaves ``(layers, num_pages,
        page_size, K, Dh)``; page ``num_pages`` is the out-of-bounds
        sink.  A sliding-window ring rotates by position and does not
        page: those models raise, as in the reference."""
        cfg = self.cfg
        if cfg.sliding_window > 0:
            raise ValueError("paged KV needs linear caches (no SWA ring)")
        shp = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
               cfg.head_dim)
        return {"blocks/0/k": (shp, self.dtype),
                "blocks/0/v": (shp, self.dtype)}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(s, dtype=d, device=self.device)
                for k, (s, d) in self.cache_specs(batch, max_len).items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *, max_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None):
        """Run the full prompt and build a slotted cache of ``max_len``
        positions (a ring of ``min(window, max_len)`` slots under a sliding
        window).  Returns (last-position logits (B, V), cache, lengths);
        with ``lengths`` (a right-padded batch) logits come from each row's
        true last token.  A ring rotates by the padded length, so the
        serving engine prefills sliding-window models at exact lengths."""
        B, S = tokens.shape
        max_len = max_len or S
        cache = self.init_cache(B, max_len)
        kc, vc = cache["blocks/0/k"], cache["blocks/0/v"]
        Sk = kc.shape[2]
        x = self.embed(tokens)
        positions = self._positions(B, S)
        for i, blk in enumerate(self.layers):
            x, (k, v) = self._layer_fwd(blk, x, positions)
            if Sk < S:
                # ring: decode expects slot = position % Sk; the last Sk
                # positions start at S - Sk, so rotate them into ring order
                shift = (S - Sk) % Sk
                kc[i] = torch.roll(k[:, -Sk:], shift, dims=1)
                vc[i] = torch.roll(v[:, -Sk:], shift, dims=1)
            else:
                kc[i, :, :S] = k
                vc[i, :, :S] = v
        rows = torch.arange(B, device=self.device)
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=self.device)
            logits = self.unembed(x[:, -1:])[:, 0]
        else:
            lengths = lengths.to(torch.int32)
            last = (lengths.long() - 1).clamp(min=0)
            logits = self.unembed(x[rows, last][:, None])[:, 0]
        return logits, cache, lengths

    # ------------------------------------------------------------------
    @staticmethod
    def _page_targets(block_table: torch.Tensor, positions: torch.Tensor,
                      valid: Optional[torch.Tensor], page: int):
        """Physical (page, offset) scatter targets for token ``positions``
        (B, C) through ``block_table`` (B, n_pages).  Invalid positions are
        redirected to page ``INVALID_PAGE`` (out of bounds: dropped)."""
        n_pages = block_table.shape[1]
        lp = (positions // page).clamp(0, n_pages - 1)
        pp = torch.gather(block_table.long(), 1, lp.long())
        oob = positions // page >= n_pages
        if valid is not None:
            oob = oob | ~valid
        pp = torch.where(oob, INVALID_PAGE, pp)
        return pp, positions % page

    def _write_targets(self, cache, positions, valid, block_table):
        """The kept (token row, leaf index...) write targets of one
        dispatch, shared by every layer: JAX's ``mode="drop"`` scatter,
        with the dropped targets left out.  One host sync (``nonzero``)."""
        B, C = positions.shape
        leaf = cache["blocks/0/k"]
        if block_table is not None:
            P, page = leaf.shape[1], leaf.shape[2]
            pp, off = self._page_targets(block_table, positions.long(),
                                         valid, page)
            keep = (pp < P).reshape(-1)
            a, b = pp.reshape(-1), off.reshape(-1)
        else:
            S = leaf.shape[2]
            pos = positions.long()
            keep = pos < S
            if valid is not None:
                keep = keep & valid
            keep = keep.reshape(-1)
            a = torch.arange(B, device=pos.device).repeat_interleave(C)
            b = pos.reshape(-1)
        sel = keep.nonzero().squeeze(1)
        return sel, a[sel], b[sel]

    def _attend(self, q, ck, cv, positions, lengths, block_table, attn_impl):
        """Attention of chunk queries ``q`` (B, C, H, Dh) at ``positions``
        over one layer's (already written) cache leaves."""
        if block_table is not None and attn_impl != "gather":
            return paged_attention(q, ck, cv, block_table, lengths,
                                   impl=attn_impl)
        if block_table is not None:            # INVALID clamps to page P-1
            ck = paged_gather_view(ck, block_table)
            cv = paged_gather_view(cv, block_table)
        Sk = ck.shape[1]
        kpos = torch.arange(Sk, device=q.device)[None, :].expand(
            q.shape[0], Sk)
        return L.gqa_attention(q, ck, cv,
                               L.attention_mask(positions, kpos, causal=True))

    def _cached_layers(self, x, positions, lengths, cache, valid,
                       block_table, attn_impl):
        """Every layer of a prefill chunk / decode step: project, write the
        new k/v into the cache in place, attend over the cache."""
        cfg = self.cfg
        B, C, _ = x.shape
        sel, ia, ib = self._write_targets(cache, positions, valid,
                                          block_table)
        kc, vc = cache["blocks/0/k"], cache["blocks/0/v"]
        for i, blk in enumerate(self.layers):
            h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
            q, k, v = L.attention_qkv(cfg, blk, h, positions)
            flat = (B * C, cfg.num_kv_heads, cfg.head_dim)
            kc[i][ia, ib] = k.reshape(flat)[sel]      # in place
            vc[i][ia, ib] = v.reshape(flat)[sel]
            attn = self._attend(q, kc[i], vc[i], positions, lengths,
                                block_table, attn_impl)
            x = x + L.attention_out(blk, attn)
            x = self._mlp(blk, x)
        return x

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache: dict,
                      lengths: torch.Tensor,
                      widths: Optional[torch.Tensor] = None, *,
                      block_table: Optional[torch.Tensor] = None,
                      attn_impl: str = "gather"):
        """Run one chunk of prompt tokens against an existing cache.

        tokens: (B, C); lengths: (B,) cache fill per row (the chunk occupies
        positions lengths..lengths+C-1).  ``widths`` (B,) marks the VALID
        leading tokens of a width-padded chunk: pad tokens never write the
        cache and logits come from each row's true last token.
        ``block_table`` (B, n_pages) switches ``cache`` to the paged pool
        layout; ``attn_impl`` is ``"gather"`` (dense view of the pool) or a
        ``kernels/paged_attention`` impl (``auto`` | ``cuda`` | ``ref``)
        reading pages in place.  Returns (last logits (B, V), cache — the
        same dict, written in place —, new lengths).  Sliding-window ring
        caches raise, as in the reference."""
        if self.cfg.sliding_window > 0:
            raise NotImplementedError("chunked prefill with SWA ring caches")
        B, C = tokens.shape
        dev = self.device
        lengths = lengths.to(dev)
        x = self.embed(tokens.to(dev))
        positions = lengths.long()[:, None] + torch.arange(C, device=dev)
        valid = (None if widths is None else
                 torch.arange(C, device=dev)[None, :]
                 < widths.to(dev)[:, None])
        x = self._cached_layers(x, positions, lengths, cache, valid,
                                block_table, attn_impl)
        if widths is None:
            logits = self.unembed(x[:, -1:])[:, 0]
            return logits, cache, lengths + C
        widths = widths.to(dev)
        last = (widths.long() - 1).clamp(min=0)
        x_last = x[torch.arange(B, device=dev), last][:, None]
        return self.unembed(x_last)[:, 0], cache, lengths + widths

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, *,
                    block_table: Optional[torch.Tensor] = None,
                    attn_impl: str = "gather"):
        """One decode step.  tokens: (B,); lengths: (B,) cache fill per row
        (the position of the incoming token).  Returns (logits (B, V),
        cache — written in place —, lengths + 1).  With a block table,
        INVALID rows (idle / mid-prefill) drop their write; without, the
        slotted cache takes the token at slot ``lengths % Sk``."""
        dev = self.device
        lengths = lengths.to(dev)
        x = self.embed(tokens.to(dev))[:, None, :]
        positions = lengths.long()[:, None]
        if block_table is None:
            x = self._slotted_decode_layers(x, positions, lengths, cache)
        else:
            x = self._cached_layers(x, positions, lengths, cache, None,
                                    block_table, attn_impl)
        return self.unembed(x)[:, 0], cache, lengths + 1

    def _slotted_decode_layers(self, x, positions, lengths, cache):
        """Every layer of a slotted decode step: the new k/v goes to slot
        ``lengths % Sk`` in place, then flash-decode (K7) attends over the
        first ``min(lengths + 1, Sk)`` slots — the reference's slot mask
        (positions ``lengths - ((lengths - slot) % Sk)`` in [0, lengths]
        and, for a ring of Sk <= window slots, inside the window)."""
        cfg = self.cfg
        kc, vc = cache["blocks/0/k"], cache["blocks/0/v"]
        Sk = kc.shape[2]
        rows = torch.arange(x.shape[0], device=x.device)
        slot = lengths.long() % Sk
        kv_len = torch.clamp(lengths + 1, max=Sk).to(torch.int32)
        for i, blk in enumerate(self.layers):
            h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
            q, k, v = L.attention_qkv(cfg, blk, h, positions)
            kc[i][rows, slot] = k[:, 0]                # in place
            vc[i][rows, slot] = v[:, 0]
            attn = decode_attention(q[:, 0], kc[i], vc[i], kv_len,
                                    impl=self.attention_impl)
            x = x + L.attention_out(blk, attn[:, None])
            x = self._mlp(blk, x)
        return x
