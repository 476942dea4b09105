"""Decoder-only LM — the port of ``repro/models/transformer.py``.

Layers are organised as in the reference, into *segments* (``build_plan``):
a (pattern, repeats) pair where the pattern is a short tuple of sub-layer
signatures (attention kind ``attn | mla | ssm`` x MLP kind ``dense | moe
| none``).  Homogeneous models are one segment ``blocks``; DeepSeek's
leading dense layer is the segment ``prefix0``; Jamba's 1:7 attention:
Mamba interleave with MoE every other layer is one 8-layer pattern
repeated.  ``DecoderLM`` is an ``nn.Module`` holding one ``DecoderBlock``
per layer, built from its signature, with every weight in the
reference's layout (``wq`` (D, H, Dh), ``wo`` (H, Dh, D), ...) and named
``{segment}/{position}/{suffix}``; a segment that repeats stacks its
leaves along a leading axis in the reference (``models/convert.py`` moves
weights across by name).  Attention is GQA (MQA included), full or
sliding-window, with optional QKV biases, or DeepSeek's MLA; SSM layers
are Mamba-2 SSD blocks (``models/ssm.py``); each MLP is dense (gated SiLU
or the two-matrix GELU, by ``cfg.mlp_kind``), a mixture of experts
(``moe_impl`` ``dense`` | ``dropless``; the reference's rule picks
``dropless`` from d_model 1024; a config with no expert capacity takes the
port's drop-free ``grouped`` route) or none.  A vision-language model
(llava) takes precomputed patch embeddings, ``image_embeds`` (B, P, D),
placed before the token embeddings, as in the reference, whose vision
tower is a stub too.  Encoder-decoder configs build
``models/encdec.py::EncDecLM`` instead.

``loss`` is the reference's next-token cross-entropy over the text
positions, with the optional ``loss_mask``, chunked CE when
``cfg.loss_chunk`` divides S - 1 (each chunk's fp32 logits rebuilt in
backward by ``torch.utils.checkpoint``), and the MoE layers' router aux
loss weighted by ``router_aux_loss_coef``.  Its backbone rematerialises
each repeat of a repeating segment in backward, as the reference's
``jax.checkpoint`` does (``cfg.remat``: ``full`` keeps nothing, ``dots``
keeps the matmul outputs): memory, not numbers.  It reads the module's
weights, so ``train/trainer.py`` binds the cast master weights with
``torch.func.functional_call`` and differentiates inside that call.

Under the sharded train step (``train/trainer.py``) the weights bound to
the model may be this rank's 'model' slices (``tp_leaves``): GQA
attention then runs on the rank's heads (K8 per rank), a dense MLP on its
columns, the embedding and the logits on its vocabulary rows, and the
partial results are summed over 'model' (``parallel/collectives.py``).
``constrain`` marks the reference's activation-sharding sites.

Under the sharded serve steps (``serving/sharded.py``) the same forward
runs ``prefill`` on the rank's rows and heads, and each rank keeps its
range of every cache leaf's slots (its slice of an SSM layer's conv and
state), which ``init_cache`` allocates.  A slotted decode step then
attends over the rank's slots only: GQA gathers the query heads (and the
kv heads, when they are split) over 'model', the rank that owns slot
``lengths % Sk`` writes the new k/v (``torch.where``, no host sync), K7
returns its partial output and log-sum-exp over the rank's valid slots,
and ``layers.merge_partials`` combines the ranks; MLA does the same over
its latent (plain, ``layers.mla_partial``); an SSM layer gathers its
conv and state whole over the rank's rows, steps, and keeps its slice.

``attention_impl`` (``auto`` | ``cuda`` | ``ref``) picks the GQA
attention of full sequences (``forward``, ``forward_hidden``,
``prefill``: the flash-attention kernel K8) and of slotted decode steps
(the flash-decode kernel K7), or their plain versions; ``auto`` launches
the kernels on CUDA tensors.  The reference reserves the switch
(``attention_impl``) and runs XLA attention whatever its value.  MLA and
SSM layers are plain PyTorch: the reference computes them with einsums,
outside any Pallas kernel.

The KV cache is a flat dict of leaves keyed like the reference, one per
(segment, position), stacked over the segment's repeats: ``{base}/k``,
``{base}/v`` (R, B, Sk, K, Dh) for attention, ``{base}/c_kv`` (R, B, Sk,
r) and ``{base}/k_rope`` (R, B, Sk, dr) for MLA's latent,
``{base}/conv`` (R, B, W-1, conv_dim) and ``{base}/state`` (R, B, H, P,
N, fp32) for SSM; as a paged pool the seq-indexed leaves are (R, P,
page, ...) and recurrent ones refuse to page.  A sliding-window model
keeps a ring of Sk = min(window, max_len) slots, slot = position % Sk;
``prefill`` rotates the last Sk positions into that order and
``decode_step`` attends over the first min(length + 1, Sk) slots, which
is exactly the reference's slot mask (valid slots are a prefix, and a
ring no longer than the window makes the window clause hold by itself).
Where JAX returned a new cache, ``prefill_chunk`` and ``decode_step``
write the caller's leaves IN PLACE and hand the same dict back.  JAX
drops out-of-bounds scatters (the INVALID page sink, pad tokens);
PyTorch raises, so each dispatch computes its kept write targets once
(one host sync) and writes only those.  A packed chunk (a
``PackedChunk`` given to ``prefill_chunk``: the rows' chunk tokens in one
sequence, with no pad token) brings each token's page from the host and
drops nothing.  JAX clamps out-of-bounds
gathers; the gathered view (``paged_gather_view``) clamps INVALID
entries to page P - 1 explicitly.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_gather_view)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.parallel.collectives import (copy_to, gather_along,
                                              reduce_from, slice_over)
from repro_torch.parallel.sharding import (constrain, model_sharder,
                                           serve_sharder)

INVALID_PAGE = 2 ** 30


@dataclasses.dataclass
class PackedChunk:
    """One packed chunk launch (``pack_chunks``): the chunk tokens of
    ``rows`` rows concatenated into one (1, T) sequence, T the sum of
    their widths, with the indices every layer reads.  The dense layers
    run over the T tokens; the paged attention reads the queries through
    a (rows, width) view, ``width`` the widest row's, in which ``slot``
    (T,) places each token (None when every row is ``width`` wide: the
    view is the sequence itself)."""
    tokens: torch.Tensor         # (1, T) int64
    positions: torch.Tensor      # (1, T) int64, absolute
    pages: torch.Tensor          # (T,) int64 physical page of each token
    offsets: torch.Tensor        # (T,) int64 its offset in that page
    last: torch.Tensor           # (rows,) int64 each row's last token
    slot: Optional[torch.Tensor]  # (T,) int64 or None
    lengths: torch.Tensor        # (rows,) int32 fill before the launch
    block_table: torch.Tensor    # (rows, n_pages) int32
    width: int
    _view: Optional[torch.Tensor] = None   # the view's buffer; pads stay 0

    def to_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(1, T, ...) -> (rows, width, ...): one index write."""
        rows, tail = self.lengths.shape[0], tuple(t.shape[2:])
        if self.slot is None:
            return t.view((rows, self.width) + tail)
        if self._view is None:
            self._view = t.new_zeros((rows * self.width,) + tail)
        self._view.index_copy_(0, self.slot, t[0])
        return self._view.view((rows, self.width) + tail)

    def to_tokens(self, t: torch.Tensor) -> torch.Tensor:
        """(rows, width, ...) -> (1, T, ...): one gather."""
        if self.slot is None:
            return t.reshape((1, -1) + tuple(t.shape[2:]))
        return t.flatten(0, 1).index_select(0, self.slot)[None]


def pack_chunks(chunks, lengths, block_table: np.ndarray, page: int,
                device) -> PackedChunk:
    """Build a ``PackedChunk`` on the host and upload it (two copies).
    ``chunks``: each row's chunk tokens (at least one); ``lengths``: each
    row's fill before them (the chunk occupies positions lengths..lengths
    + width - 1); ``block_table`` (rows, n_pages) int32 host rows; every
    chunk token's page must be mapped."""
    widths = np.array([len(c) for c in chunks], np.int64)
    rows, width = len(chunks), int(widths.max())
    cu = np.zeros(rows + 1, np.int64)
    np.cumsum(widths, out=cu[1:])
    T = int(cu[-1])
    row = np.repeat(np.arange(rows), widths)
    within = np.arange(T) - cu[row]
    lengths = np.asarray(lengths, np.int64)
    pos = lengths[row] + within
    pages = block_table[row, pos // page].astype(np.int64)
    if (pages >= INVALID_PAGE).any():
        raise ValueError("a chunk token's page is not mapped")
    ragged = T < rows * width
    parts = [np.concatenate(chunks), pos, pages, pos % page, cu[1:] - 1]
    if ragged:
        parts.append(row * width + within)
    idx = torch.as_tensor(np.concatenate(parts).astype(np.int64),
                          device=device)
    meta = torch.as_tensor(np.concatenate(
        [lengths, block_table.reshape(-1)]).astype(np.int32), device=device)
    tokens, positions, pages_t, offsets, last = idx[:4 * T + rows].split(
        (T, T, T, T, rows))
    return PackedChunk(
        tokens=tokens[None], positions=positions[None], pages=pages_t,
        offsets=offsets, last=last,
        slot=idx[4 * T + rows:] if ragged else None,
        lengths=meta[:rows], block_table=meta[rows:].view(rows, -1),
        width=width)

# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: str                        # attn | mla | ssm
    mlp: str                         # dense | moe | none


@dataclasses.dataclass(frozen=True)
class Segment:
    name: str
    pattern: Tuple[SubLayer, ...]
    repeats: int


def build_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """The reference's plan: a ``prefix{i}`` segment per leading dense
    layer of an MoE model, then one ``blocks`` segment whose pattern is
    the lcm of the MoE and attention periods (one layer when the rest
    does not divide by it)."""
    def sig(i: int) -> SubLayer:
        kind = cfg.layer_kind(i)
        if kind == "attn" and cfg.mla is not None:
            kind = "mla"
        if cfg.family == "ssm":
            mlp = "none"
        elif cfg.is_moe_layer(i):
            mlp = "moe"
        else:
            mlp = "dense"
        return SubLayer(kind, mlp)

    sigs = [sig(i) for i in range(cfg.num_layers)]
    prefix = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    period = 1
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.expert_layer_period)
    if cfg.family == "hybrid" and cfg.attn_layer_period:
        period = math.lcm(period, cfg.attn_layer_period)

    segments = []
    for i in range(prefix):
        segments.append(Segment(f"prefix{i}", (sigs[i],), 1))
    tail = sigs[prefix:]
    if len(tail) % period != 0:
        period = 1  # fall back to per-layer pattern check
    pattern = tuple(tail[:period])
    repeats = len(tail) // period
    for r in range(repeats):
        if tuple(tail[r * period:(r + 1) * period]) != pattern:
            raise ValueError(f"{cfg.name}: layer pattern is not periodic")
    segments.append(Segment("blocks", pattern, repeats))
    return tuple(segments)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# reference param name suffix (under "{segment}/{position}/") ->
# (DecoderBlock attr, init); a block carries the leaves of its signature
BLOCK_LEAVES = {
    "attn_norm": ("attn_norm", "ones"),
    "attn/wq": ("wq", "normal"),
    "attn/wk": ("wk", "normal"),
    "attn/wv": ("wv", "normal"),
    "attn/wo": ("wo", "normal"),
    "attn/bq": ("bq", "zeros"),
    "attn/bk": ("bk", "zeros"),
    "attn/bv": ("bv", "zeros"),
    "attn/w_dkv": ("w_dkv", "normal"),
    "attn/w_krope": ("w_krope", "normal"),
    "attn/kv_norm": ("kv_norm", "ones"),
    "attn/w_uk": ("w_uk", "normal"),
    "attn/w_uv": ("w_uv", "normal"),
    "ssm_norm": ("ssm_norm", "ones"),
    **{f"ssm/{k}": v for k, v in S.SSM_LEAVES.items()},
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
# each weight's logical axes (the reference's ``ParamSpec.axes``), by the
# same names: the keys of the sharding rules (``parallel/sharding.py``)
BLOCK_AXES = {
    "attn_norm": ("embed",),
    "attn/wq": ("embed", "heads", "qk_dim"),
    "attn/wk": ("embed", "kv_heads", "qk_dim"),
    "attn/wv": ("embed", "kv_heads", "qk_dim"),
    "attn/wo": ("heads", "qk_dim", "embed"),
    "attn/bq": ("heads", "qk_dim"),
    "attn/bk": ("kv_heads", "qk_dim"),
    "attn/bv": ("kv_heads", "qk_dim"),
    "attn/w_dkv": ("embed", "kv_lora"),
    "attn/w_krope": ("embed", "qk_dim"),
    "attn/kv_norm": ("kv_lora",),
    "attn/w_uk": ("kv_lora", "heads", "qk_dim"),
    "attn/w_uv": ("kv_lora", "heads", "qk_dim"),
    "ssm_norm": ("embed",),
    **{f"ssm/{k}": v for k, v in S.SSM_AXES.items()},
    "mlp_norm": ("embed",),
    "mlp/w_gate": ("embed", "mlp"),
    "mlp/w_up": ("embed", "mlp"),
    "mlp/w_down": ("mlp", "embed"),
    "mlp/w_in": ("embed", "mlp"),
    "mlp/b_in": ("mlp",),
    "mlp/w_out": ("mlp", "embed"),
    "mlp/b_out": ("embed",),
    "moe/router": ("embed", "experts"),
    "moe/we_gate": ("experts", "embed", "mlp"),
    "moe/we_up": ("experts", "embed", "mlp"),
    "moe/we_down": ("experts", "mlp", "embed"),
    "moe/shared/w_gate": ("embed", "mlp"),
    "moe/shared/w_up": ("embed", "mlp"),
    "moe/shared/w_down": ("mlp", "embed"),
}
TOP_AXES = {"embed/tokens": ("vocab", "embed"), "final_norm/w": ("embed",),
            "head/w": ("embed", "vocab")}


# each attention kind's cache leaves, by suffix under "{segment}/{position}/"
CACHE_LEAVES = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope"),
                "ssm": ("conv", "state")}
_KV_AXES = ("layers", "batch", "cache_seq", "kv_heads", "qk_dim")
CACHE_AXES = {"attn": (_KV_AXES, _KV_AXES),
              "mla": (("layers", "batch", "cache_seq", "kv_lora"),
                      ("layers", "batch", "cache_seq", "qk_dim")),
              "ssm": (("layers", "batch", "conv_w", "ssm_inner"),
                      ("layers", "batch", "ssm_heads", "qk_dim",
                       "ssm_state"))}


# matmuls whose outputs ``remat="dots"`` keeps (JAX's checkpoint_dots)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(remat: str):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat``: ``full`` keeps
    nothing (the default context), ``dots`` keeps the matmul outputs,
    ``nothing`` (None) does not rematerialise."""
    if remat == "nothing":
        return None
    if remat == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _keep_dots)
    if remat == "full":
        return noop_context_fn
    raise ValueError(f"remat {remat!r} not in full | dots | nothing")


def _check_decoder_only(cfg: ModelConfig) -> None:
    if cfg.encdec is not None or cfg.family == "encdec":
        raise ValueError(f"{cfg.name} is an encoder-decoder config: "
                         "build_model gives it an EncDecLM "
                         "(models/encdec.py)")


def _tp_weights(cfg: ModelConfig, tp, blk):
    """The attention weights of a rank whose query heads are split over
    'model'.  When the kv heads are too few to split, every rank projects
    them whole and attends with some of them: their weights pass through
    ``copy_to``, so each rank's gradient is the sum over 'model'."""
    if blk.wk.shape[1] < cfg.num_kv_heads:
        return blk
    names = ["wq", "wk", "wv"] + (["bq", "bk", "bv"] if cfg.qkv_bias else [])
    return types.SimpleNamespace(**{
        n: (getattr(blk, n) if n in ("wq", "bq")
            else copy_to(getattr(blk, n), tp.mesh, ("model",)))
        for n in names})


def _local_kv(cfg: ModelConfig, tp, q, k, v):
    """The kv heads of this rank's query heads when the query heads are
    split over 'model' and the kv heads are not (too few to split: the
    projection ran whole): heads [lo, lo + H_local) read kv heads
    [lo // G, ...) of the G-to-1 grouping."""
    H_l, K = q.shape[2], k.shape[2]
    if K < cfg.num_kv_heads:                     # split alike: aligned
        return k, v
    G = cfg.num_heads // cfg.num_kv_heads
    assert H_l % G == 0 or G % H_l == 0, (H_l, G)
    lo = tp.mesh.get_local_rank("model") * H_l // G
    n = max(1, H_l // G)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


class DecoderBlock(nn.Module):
    """One layer's weights, by its sub-layer signature: the mixer (GQA
    attention, MLA or an SSM block), then the MLP of its kind (gated SiLU,
    GELU with biases, routed and shared experts, or none)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device,
                 sl: SubLayer):
        super().__init__()
        D, H, K, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff)
        self.kind, self.mlp = sl.kind, sl.mlp
        if sl.kind == "attn":
            shapes = {"attn_norm": (D,), "wq": (D, H, Dh), "wk": (D, K, Dh),
                      "wv": (D, K, Dh), "wo": (H, Dh, D)}
            if cfg.qkv_bias:
                shapes.update(bq=(H, Dh), bk=(K, Dh), bv=(K, Dh))
        elif sl.kind == "mla":
            shapes = {"attn_norm": (D,), **L.mla_specs(cfg)}
        else:
            shapes = {"ssm_norm": (D,)}
            shapes.update({S.SSM_LEAVES[k][0]: v
                           for k, v in S.ssm_specs(cfg).items()})
        if sl.mlp == "moe":
            m = cfg.moe
            E, Fe = m.num_experts, m.d_ff_expert
            shapes.update(mlp_norm=(D,), router=(D, E), we_gate=(E, D, Fe),
                          we_up=(E, D, Fe), we_down=(E, Fe, D))
            if m.num_shared_experts:
                Fs = m.d_ff_shared
                shapes.update(shared_w_gate=(D, Fs), shared_w_up=(D, Fs),
                              shared_w_down=(Fs, D))
        elif sl.mlp == "dense" and cfg.mlp_kind == "gelu":
            shapes.update(mlp_norm=(D,), w_in=(D, F), b_in=(F,),
                          w_out=(F, D), b_out=(D,))
        elif sl.mlp == "dense":
            shapes.update(mlp_norm=(D,), w_gate=(D, F), w_up=(D, F),
                          w_down=(F, D))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=dtype, device=device),
                requires_grad=False))


class DecoderLM(nn.Module):
    """Decoder-only LM with the reference's forward / prefill /
    chunked-prefill / decode entry points."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 attention_impl: str = "auto",
                 moe_impl: Optional[str] = None):
        super().__init__()
        _check_decoder_only(cfg)
        if attention_impl not in ("auto", "cuda", "ref"):
            raise ValueError(f"attention_impl {attention_impl!r} not in "
                             "auto | cuda | ref")
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.attention_impl = attention_impl
        # the reference's rule: the dispatch einsums of ``dense`` dominate
        # at scale, so wide models take the capacity buffers; a drop-free
        # config (``moe_drop_free``) takes the grouped route
        drop_free = cfg.moe is not None and cfg.moe_drop_free
        self.moe_impl = moe_impl or (
            "grouped" if drop_free
            else "dropless" if cfg.d_model >= 1024 else "dense")
        L.check_moe_impl(self.moe_impl)
        if drop_free and self.moe_impl in ("dropless", "ep"):
            raise ValueError(f"moe_impl {self.moe_impl!r} drops past a "
                             "capacity; moe_drop_free drops nothing")
        if cfg.yarn_factor != 1 and cfg.mla is None:
            raise ValueError("yarn_factor scales MLA's rope dims; "
                             f"{cfg.name} has no MLA")
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
        # one block per layer in plan order; ``_at[i]`` is layer i's
        # (leaf base "{segment}/{position}", repeat index, segment repeats);
        # ``_spans`` each repeat's (first, end) layers and whether its
        # segment repeats (the unit the reference rematerialises)
        blocks, self._at, self._spans = [], [], []
        for seg in self.plan:
            for r in range(seg.repeats):
                self._spans.append((len(blocks),
                                    len(blocks) + len(seg.pattern),
                                    seg.repeats > 1))
                for pos, sl in enumerate(seg.pattern):
                    blocks.append(DecoderBlock(cfg, dt, dev, sl))
                    self._at.append((f"{seg.name}/{pos}", r, seg.repeats))
        self.layers = nn.ModuleList(blocks)
        self._recurrent = any(sl.kind == "ssm" for seg in self.plan
                              for sl in seg.pattern)
        # a packed chunk (``PackedChunk``) needs per-token layers: GQA
        # attention, and MLPs whose result does not depend on the launch's
        # other tokens (a dropless MoE's capacity does)
        self._per_token = cfg.mla is None and all(
            b.kind == "attn" and (b.mlp != "moe"
                                  or self.moe_impl in ("dense", "grouped"))
            for b in blocks)
        # latent rows MLA has expanded to per-head K and V in the cache
        # launches (``prefill``, ``prefill_chunk``, ``decode_step``): rows x
        # the keys each row attends over, summed over MLA layers; a host
        # tally of shapes (no sync), which the serving engine reads and
        # clears after each launch
        self.mla_expanded = 0

    # ------------------------------------------------------------------
    def leaves(self):
        """(reference name, repeat index or None, attr owner, attr, init)
        for every weight — the one table ``init`` and
        ``models/convert.py`` walk.  The index is None unless the leaf's
        segment repeats (the reference stacks it then); a name's entries
        come in repeat order."""
        for name, (attr, init) in TOP_LEAVES.items():
            if getattr(self, attr) is not None:
                yield name, None, self, attr, init
        for suffix, (attr, init) in BLOCK_LEAVES.items():
            for blk, (base, r, reps) in zip(self.layers, self._at):
                if hasattr(blk, attr):
                    yield (f"{base}/{suffix}", r if reps > 1 else None, blk,
                           attr, init)

    def logical_axes(self) -> Dict[str, tuple]:
        """{reference name: logical axes} of every weight, repeats stacked
        (``("layers",) + axes``), as the reference's ``logical_axes``."""
        return L.leaf_layout(self, self._axes_of)[0]

    def param_specs(self) -> Dict[str, L.ParamSpec]:
        """{reference name: ``ParamSpec``} of every weight, repeats
        stacked, as the reference's ``param_specs``."""
        return L.param_specs(self, self._axes_of)

    def init_shapes(self) -> Dict[str, L.ShapeDtype]:
        """{reference name: ``ShapeDtype``} of every weight in the
        reference's flat layout, as its ``init_shapes``."""
        return L.leaf_layout(self, self._axes_of)[1]

    @staticmethod
    def _axes_of(name: str) -> tuple:
        return TOP_AXES.get(name) or BLOCK_AXES[name.split("/", 2)[2]]

    def tp_leaves(self) -> set:
        """The weights whose 'model'-axis slices the forward computes with
        under the sharded train step (GQA attention, the dense MLPs, the
        vocabulary); every other weight is gathered whole there."""
        out = {"embed/tokens", "head/w"}
        for name, _, owner, _, _ in self.leaves():
            if name in TOP_LEAVES:
                continue
            suffix = name.split("/", 2)[2]
            if (suffix.startswith("mlp/")
                    or (owner.kind == "attn" and suffix.startswith("attn/"))):
                out.add(name)
        return out

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
    def embed(self, tokens: torch.Tensor,
              image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, after the patch embeddings (cast to the
        weights' dtype) when ``image_embeds`` (B, P, D) is given."""
        table = self.embed_tokens
        tp = model_sharder() if table.shape[0] < self.cfg.vocab_size \
            else None
        if tp is None:
            x = table[tokens.long()]
        else:
            # the sharded train step: this rank holds vocab rows [lo, lo +
            # V_local); a token outside them reads zeros, and the sum over
            # 'model' has each token's row exactly once
            ids = tokens.long() - tp.mesh.get_local_rank("model") \
                * table.shape[0]
            inside = (ids >= 0) & (ids < table.shape[0])
            x = table[ids.clamp(0, table.shape[0] - 1)] \
                * inside[..., None].to(table.dtype)
            x = reduce_from(x, tp.mesh, ("model",))
        if image_embeds is not None:
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        return x

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed_tokens if self.cfg.tie_embeddings else self.head
        split = w.shape[0 if self.cfg.tie_embeddings else 1] \
            < self.cfg.vocab_size
        tp = model_sharder() if split else None
        if tp is not None:
            x = copy_to(x, tp.mesh, ("model",))
        if self.cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, w)
        else:
            logits = x @ w
        if tp is not None:
            # this rank's vocab columns, gathered whole for the CE
            logits = gather_along(logits, tp.mesh, ("model",), -1)
        return logits

    def _mlp(self, blk, x):
        """The layer's MLP half: norm, dense MLP or experts, residual (none
        for a pure SSM).  Returns (x, the MoE router's aux loss or None);
        serving drops the aux, ``loss`` sums it."""
        if blk.mlp == "none":
            return x, None
        h = L.rms_norm(x, blk.mlp_norm, self.cfg.norm_eps)
        if blk.mlp == "moe":
            y, aux = L.moe_apply(self.cfg, blk, h, impl=self.moe_impl)
            return x + y, aux
        F = (blk.w_in if self.cfg.mlp_kind == "gelu" else blk.w_gate).shape[1]
        tp = model_sharder() if F < self.cfg.d_ff else None
        if tp is None:
            return x + L.dense_mlp_apply(self.cfg, blk, h), None
        # the sharded train step: this rank's columns of the MLP, the
        # partial outputs summed over 'model' (before the output bias)
        y = L.dense_mlp_apply(
            self.cfg, blk, copy_to(h, tp.mesh, ("model",)),
            reduce=lambda t: reduce_from(t, tp.mesh, ("model",)))
        return x + y, None

    def _layer_fwd(self, blk, x, positions, for_cache: bool = False):
        """One layer over a full sequence: (x, the values its cache keeps:
        (k, v), (c_kv, k_rope) or (conv, state), the MoE aux or None).
        ``for_cache`` under split heads: (k, v) of every kv head, which a
        rank's slots of the cache hold (gathered over 'model' when the kv
        heads are split too)."""
        cfg = self.cfg
        if blk.kind == "ssm":
            h = L.rms_norm(x, blk.ssm_norm, cfg.norm_eps)
            y, new = S.ssm_apply(cfg, blk, h, return_state=True)
            x = x + y
        elif blk.kind == "mla":
            h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
            new = L.mla_latent(cfg, blk, h, positions)
            x = x + L.mla_attention(cfg, blk, h, *new, positions,
                                    k_positions=positions)
        else:
            h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
            tp = model_sharder() if blk.wq.shape[1] < cfg.num_heads else None
            w = blk
            if tp is not None:
                h = copy_to(h, tp.mesh, ("model",))
                w = _tp_weights(cfg, tp, blk)
            q, k, v = L.attention_qkv(cfg, w, h, positions)
            new = (k, v)
            if tp is not None:
                k, v = _local_kv(cfg, tp, q, k, v)
                if for_cache and new[0].shape[2] < cfg.num_kv_heads:
                    new = tuple(gather_along(t, tp.mesh, ("model",), 2)
                                for t in new)
            # the sharded train step: K8 on this rank's heads only
            attn = L.causal_attention(q, k, v, window=cfg.sliding_window,
                                      impl=self.attention_impl)
            out = L.attention_out(blk, attn)
            if tp is not None:
                out = reduce_from(out, tp.mesh, ("model",))
            x = x + out
            if not for_cache:
                new = (k, v)
        x, aux = self._mlp(blk, x)
        return x, new, aux

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device)[None, :].expand(B, S)

    def _names_of(self, i):
        """Layer i's cache leaf names."""
        return [f"{self._at[i][0]}/{n}"
                for n in CACHE_LEAVES[self.layers[i].kind]]

    def _leaves_of(self, cache, i):
        """Layer i's cache leaves (its repeat's row of each)."""
        r = self._at[i][1]
        return [cache[n][r] for n in self._names_of(i)]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, P + S, V), the P patch positions of
        ``image_embeds`` (B, P, D) first."""
        return self.unembed(self._backbone(tokens, image_embeds)[0])

    def _layers_fwd(self, lo, hi, positions, x):
        """Layers lo..hi-1 over a full sequence: (x, their summed aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # reference: transformer.py:211 (the segment body)
        x = constrain(x, ("batch", None, "act_embed"))
        for blk in self.layers[lo:hi]:
            x, _, a = self._layer_fwd(blk, x, positions)
            if a is not None:
                aux = aux + a
        return x, aux

    def _backbone(self, tokens: torch.Tensor,
                  image_embeds: Optional[torch.Tensor] = None):
        """Embedding and every layer, before the final norm: (hidden (B,
        P + S, D), the MoE aux summed over layers).  Under autograd each
        repeat of a repeating segment is rematerialised in backward
        (``cfg.remat``)."""
        x = self.embed(tokens, image_embeds)
        positions = self._positions(*x.shape[:2])
        remat = _remat_context(self.cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo, hi, repeated in self._spans:
            fn = functools.partial(self._layers_fwd, lo, hi, positions)
            if repeated and remat is not None and torch.is_grad_enabled():
                x, a = checkpoint(fn, x, use_reentrant=False,
                                  context_fn=remat)
            else:
                x, a = fn(x)
            aux = aux + a
        return x, aux

    def loss(self, batch: dict):
        """Next-token CE, as the reference's ``loss``.  ``batch``: tokens
        (B, S) int, optional loss_mask (B, S) and image_embeds (B, P, D)
        (tensors on this model's device).  The target of position i is
        token i + 1, over the text positions only.  With ``cfg.loss_chunk``
        dividing S - 1 (and below it) the fp32 logits exist one chunk at a
        time and are rebuilt in backward.  Returns (total, {loss, aux_loss,
        total_loss}); total adds ``router_aux_loss_coef`` x the MoE aux."""
        cfg = self.cfg
        tokens = batch["tokens"]
        hidden, aux = self._backbone(tokens, batch.get("image_embeds"))
        n_img = hidden.shape[1] - tokens.shape[1]
        if n_img > 0:
            hidden = hidden[:, n_img:]                    # text positions
        targets = tokens[:, 1:].long()
        mask = batch.get("loss_mask")
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=hidden.device) if mask is None
                else mask[:, 1:].float())
        hid = hidden[:, :-1]
        Sm1 = hid.shape[1]
        chunk = cfg.loss_chunk
        if chunk and Sm1 > chunk and Sm1 % chunk == 0:
            ce_sum = torch.zeros((), dtype=torch.float32, device=hid.device)
            for i in range(0, Sm1, chunk):
                part = slice(i, i + chunk)
                ce_sum = ce_sum + checkpoint(
                    self._ce_sum, hid[:, part], targets[:, part],
                    mask[:, part], use_reentrant=False)
        else:
            ce_sum = self._ce_sum(hid, targets, mask)
        loss = ce_sum / torch.clamp(mask.sum(), min=1.0)
        coef = cfg.moe.router_aux_loss_coef if cfg.moe is not None else 0.0
        total = loss + coef * aux
        return total, {"loss": loss, "aux_loss": aux, "total_loss": total}

    def _ce_sum(self, hid, targets, mask):
        """Summed masked CE of hidden rows against their targets, fp32."""
        logits = self.unembed(hid).float()
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        return ((logz - tgt) * mask).sum()

    def _prefix_depth(self, num_layers: int) -> int:
        """Layers that the reference's ``forward_hidden(num_layers)`` runs:
        it takes ``num_layers`` repeats, segment by segment, and each
        repeat runs its segment's whole pattern (jamba: 8 layers)."""
        n, remaining = 0, num_layers
        for seg in self.plan:
            if remaining <= 0:
                break
            take = min(remaining, seg.repeats)
            n += take * len(seg.pattern)
            remaining -= take
        return n

    @torch.no_grad()
    def forward_hidden(self, tokens: torch.Tensor, *,
                       num_layers: int) -> torch.Tensor:
        """Embedding + the first ``num_layers`` repeats of the plan
        (``_prefix_depth``): hidden (B, S, D) — the CoIC descriptor-prefix
        path."""
        x = self.embed(tokens)
        positions = self._positions(*tokens.shape)
        for blk in self.layers[:self._prefix_depth(num_layers)]:
            x, _, _ = self._layer_fwd(blk, x, positions)
        return x

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def _cache_len(self, max_len: int) -> int:
        """Slots per row: the window's ring for sliding-window attention."""
        w = self.cfg.sliding_window
        return min(w, max_len) if w > 0 else max_len

    def _leaf_specs(self, kind: str, R: int, rows: int, seq: int,
                    paged: bool):
        """(shape, dtype) of one (segment, position)'s leaves; ``rows`` is
        the batch (slotted) or the page count (paged), ``seq`` the slots
        per row or the page size."""
        cfg = self.cfg
        if kind == "attn":
            if not paged:
                seq = self._cache_len(seq)
            shp = (R, rows, seq, cfg.num_kv_heads, cfg.head_dim)
            return [(shp, self.dtype), (shp, self.dtype)]
        if kind == "mla":
            m = cfg.mla
            return [((R, rows, seq, m.kv_lora_rank), self.dtype),
                    ((R, rows, seq, m.qk_rope_head_dim), self.dtype)]
        if paged:
            raise ValueError("paged KV needs attention-family caches "
                             f"(got {kind} sub-layer)")
        s = cfg.ssm
        _, H, conv_dim = S.ssm_dims(cfg)
        return [((R, rows, s.d_conv - 1, conv_dim), self.dtype),
                ((R, rows, H, s.head_dim, s.d_state), torch.float32)]

    def _specs(self, rows: int, seq: int, paged: bool):
        specs = {}
        for seg in self.plan:
            for pos, sl in enumerate(seg.pattern):
                leaves = self._leaf_specs(sl.kind, seg.repeats, rows, seq,
                                          paged)
                for n, spec in zip(CACHE_LEAVES[sl.kind], leaves):
                    specs[f"{seg.name}/{pos}/{n}"] = spec
        return specs

    def cache_specs(self, batch: int, max_len: int
                    ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """(shape, dtype) of the slotted decode cache leaves; an SSM
        ``state`` is fp32 whatever the model's dtype."""
        return self._specs(batch, max_len, paged=False)

    def cache_axes(self) -> Dict[str, tuple]:
        """Logical axes of each slotted cache leaf, under
        ``cache_specs``'s names."""
        axes = {}
        for seg in self.plan:
            for pos, sl in enumerate(seg.pattern):
                for n, a in zip(CACHE_LEAVES[sl.kind], CACHE_AXES[sl.kind]):
                    axes[f"{seg.name}/{pos}/{n}"] = a
        return axes

    def paged_cache_specs(self, num_pages: int, page_size: int
                          ) -> Dict[str, Tuple[tuple, torch.dtype]]:
        """(shape, dtype) of the paged pool leaves ``(R, num_pages,
        page_size, ...)``; page ``num_pages`` is the out-of-bounds sink.
        A sliding-window ring rotates by position and a recurrent state
        is not seq-indexed: those models raise, as in the reference."""
        if self.cfg.sliding_window > 0:
            raise ValueError("paged KV needs linear caches (no SWA ring)")
        return self._specs(num_pages, page_size, paged=True)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """A zero slotted cache; under a serve sharder, this rank's part of
        one (``batch`` is then the rank's rows)."""
        sh = serve_sharder()
        return {k: torch.zeros(s if sh is None else sh.local_shape(k, s),
                               dtype=d, device=self.device)
                for k, (s, d) in self.cache_specs(batch, max_len).items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, *,
                image_embeds: Optional[torch.Tensor] = None,
                max_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None):
        """Run the full prompt (after the patch embeddings of
        ``image_embeds``, which take the first positions) and build a
        slotted cache of ``max_len`` positions (a ring of ``min(window,
        max_len)`` slots under a sliding window; an SSM layer keeps its
        final conv and SSD states).  Returns (last-position logits (B, V),
        cache, lengths); with ``lengths`` (a right-padded batch) logits
        come from each row's true last token.  A ring rotates by the
        padded length and a recurrent state absorbs the pads, so the
        serving engine prefills those models at exact lengths.  Under a
        serve sharder the rows are this rank's, and so is the cache: its
        range of the slots of each leaf (after the ring's rotation), its
        slice of an SSM layer's states."""
        x = self.embed(tokens, image_embeds)
        B, S = x.shape[:2]
        max_len = max_len or S
        cache = self.init_cache(B, max_len)
        positions = self._positions(B, S)
        sh = serve_sharder()
        for i, blk in enumerate(self.layers):
            # reference: transformer.py:552 (the prefill body)
            x = constrain(x, ("batch", None, "act_embed"))
            x, new, _ = self._layer_fwd(blk, x, positions, for_cache=True)
            if blk.kind == "mla":
                self.mla_expanded += B * S
            for name, leaf, val in zip(self._names_of(i),
                                       self._leaves_of(cache, i), new):
                if blk.kind == "ssm":
                    leaf.copy_(val if sh is None else sh.keep(name, val))
                    continue
                # this rank's slots [lo, lo + n) of the leaf's Sk
                n = leaf.shape[1]
                lo, Sk = (0, n) if sh is None else sh.slot_range(name, n)
                if Sk < S:
                    # ring: decode expects slot = position % Sk; the last
                    # Sk positions start at S - Sk, so rotate them into
                    # ring order
                    leaf.copy_(torch.roll(val[:, -Sk:], (S - Sk) % Sk,
                                          dims=1)[:, lo:lo + n])
                else:
                    m = max(0, min(S - lo, n))
                    leaf[:, :m] = val[:, lo:lo + m]
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
        dispatch, shared by every seq-indexed leaf: JAX's ``mode="drop"``
        scatter, with the dropped targets left out.  One host sync
        (``nonzero``); None for a model with no seq-indexed leaf."""
        leaf = next((v for k, v in cache.items()
                     if k.endswith(("/k", "/c_kv"))), None)
        if leaf is None:
            return None
        B, C = positions.shape
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

    @staticmethod
    def _scatter(leaf, vals, targets):
        """Write chunk values (B, C, ...) into one layer's leaf in place at
        the kept ``targets`` (every one when ``sel`` is None)."""
        sel, ia, ib = targets
        vals = vals.reshape((-1,) + tuple(vals.shape[2:]))
        leaf[ia, ib] = vals if sel is None else vals[sel]

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

    def _mla_cached(self, blk, h, positions, leaves, targets, block_table,
                    slot=None):
        """MLA over the latent cache: write the chunk's (c_kv, k_rope) in
        place (at ``targets``, or at ``slot`` per row for a slotted decode
        step), then attend over the whole (gathered, when paged) latent
        with the causal mask.  MLA always gathers, as in the reference."""
        cfg = self.cfg
        new = L.mla_latent(cfg, blk, h, positions)
        for leaf, val in zip(leaves, new):
            if slot is None:
                self._scatter(leaf, val, targets)
            else:
                leaf[torch.arange(h.shape[0], device=h.device), slot] = \
                    val[:, 0]
        ckv, krope = leaves
        if block_table is not None:
            ckv = paged_gather_view(ckv, block_table)
            krope = paged_gather_view(krope, block_table)
        Sk = ckv.shape[1]
        self.mla_expanded += h.shape[0] * Sk
        kpos = torch.arange(Sk, device=h.device)[None, :].expand(
            h.shape[0], Sk)
        mask = L.attention_mask(positions, kpos, causal=True)
        return L.mla_attention(cfg, blk, h, ckv, krope, positions, mask=mask)

    def _cached_layers(self, x, positions, lengths, cache, valid,
                       block_table, attn_impl, decode=False, pack=None):
        """Every layer of a prefill chunk / paged decode step: project,
        write the new k/v (latent) into the cache in place, attend over
        the cache; an SSM layer continues from its cached states (one
        recurrence step when ``decode``).  A packed chunk (``pack``)
        writes each token at its own page and attends through the
        (rows, width) query view."""
        cfg = self.cfg
        if pack is None:
            targets = self._write_targets(cache, positions, valid,
                                          block_table)
            qpos = positions
        else:                       # every token is real: nothing drops
            targets = (None, pack.pages, pack.offsets)
            qpos = lengths.long()[:, None] + torch.arange(pack.width,
                                                          device=x.device)
        for i, blk in enumerate(self.layers):
            # reference: transformer.py:768 (prefill_chunk's body; its paged
            # decode_step shares this loop)
            x = constrain(x, ("batch", None, "act_embed"))
            leaves = self._leaves_of(cache, i)
            if blk.kind == "ssm":
                h = L.rms_norm(x, blk.ssm_norm, cfg.norm_eps)
                y = self._ssm_cached(blk, h, leaves, decode)
            elif blk.kind == "mla":
                h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
                y = self._mla_cached(blk, h, positions, leaves, targets,
                                     block_table)
            else:
                h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
                q, k, v = L.attention_qkv(cfg, blk, h, positions)
                self._scatter(leaves[0], k, targets)          # in place
                self._scatter(leaves[1], v, targets)
                if pack is not None:
                    q = pack.to_rows(q)
                a = self._attend(q, *leaves, qpos, lengths, block_table,
                                 attn_impl)
                y = L.attention_out(blk, a if pack is None
                                    else pack.to_tokens(a))
            x, _ = self._mlp(blk, x + y)
        return x

    def _ssm_cached(self, blk, h, leaves, decode, names=None):
        """An SSM layer from its cached (conv, state), both written back in
        place: one recurrence step (``decode``) or the chunked scan.  Under
        a serve sharder (``names`` given) the step reads the states
        gathered whole over the dims that split them (the channels and
        heads over 'model'), and each rank keeps its slice."""
        conv, state = leaves
        sh = serve_sharder() if names is not None else None
        if sh is not None:
            y, new_conv, new_state = S.ssm_decode_step(
                self.cfg, blk, h, sh.whole(names[0], conv),
                sh.whole(names[1], state))
            conv.copy_(sh.keep(names[0], new_conv))
            state.copy_(sh.keep(names[1], new_state))
            return y
        if decode:
            y, new_conv, new_state = S.ssm_decode_step(self.cfg, blk, h,
                                                       conv, state)
        else:
            y, (new_conv, new_state) = S.ssm_apply(
                self.cfg, blk, h, conv_state=conv, ssd_state=state.float(),
                return_state=True)
        conv.copy_(new_conv)
        state.copy_(new_state)
        return y

    @torch.no_grad()
    def prefill_chunk(self, tokens, cache: dict,
                      lengths: Optional[torch.Tensor] = None,
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
        reading GQA pages in place (MLA always gathers).  Returns (last
        logits (B, V), cache — the same dict, written in place —, new
        lengths).  Sliding-window ring caches raise, as in the reference,
        and so do recurrent (SSM) layers given a block table or a pad
        mask: their state would absorb the pads.

        ``tokens`` may instead be a ``PackedChunk`` (``pack_chunks``): the
        chunk tokens of several paged rows in one sequence, with no pad,
        carrying its own lengths and block table, for a model whose layers
        are all per-token (``packs_chunks``).  The logits are then each
        row's last token's, (rows, V)."""
        if isinstance(tokens, PackedChunk):
            if not (lengths is None and widths is None
                    and block_table is None):
                raise ValueError("a PackedChunk carries its own lengths "
                                 "and block table")
            return self._prefill_packed(tokens, cache, attn_impl)
        if self.cfg.sliding_window > 0:
            raise NotImplementedError("chunked prefill with SWA ring caches")
        if self._recurrent and block_table is not None:
            raise NotImplementedError("paged KV with recurrent caches")
        if self._recurrent and widths is not None:
            raise NotImplementedError("width-padded chunks with recurrent "
                                      "caches")
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

    def packs_chunks(self) -> bool:
        """Whether ``prefill_chunk`` takes a ``PackedChunk`` here: every
        layer per-token (GQA attention, a dense MLP or a dense-dispatch
        or drop-free grouped MoE) and no serve sharder installed."""
        return self._per_token and serve_sharder() is None

    def _prefill_packed(self, pack: PackedChunk, cache: dict,
                        attn_impl: str):
        """``prefill_chunk`` over packed rows: the same positions, page
        writes and last-token logits as the padded launch, with the dense
        layers run over the T real tokens only."""
        if not self.packs_chunks():
            raise ValueError("packed chunks need per-token layers (GQA, "
                             "no dropless MoE) and no serve sharder")
        x = self.embed(pack.tokens)
        x = self._cached_layers(x, pack.positions, pack.lengths, cache, None,
                                pack.block_table, attn_impl, pack=pack)
        logits = self.unembed(x[:, pack.last])[0]
        return logits, cache, (pack.positions[0, pack.last] + 1).to(
            torch.int32)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    lengths: torch.Tensor, *,
                    block_table: Optional[torch.Tensor] = None,
                    attn_impl: str = "gather"):
        """One decode step.  tokens: (B,); lengths: (B,) cache fill per row
        (the position of the incoming token).  Returns (logits (B, V),
        cache — written in place —, lengths + 1).  With a block table,
        INVALID rows (idle / mid-prefill) drop their write; without, the
        slotted cache takes the token at slot ``lengths % Sk``.  SSM layers
        take one recurrence step."""
        dev = self.device
        lengths = lengths.to(dev)
        x = self.embed(tokens.to(dev))[:, None, :]
        positions = lengths.long()[:, None]
        if block_table is None:
            x = self._slotted_decode_layers(x, positions, lengths, cache)
        else:
            x = self._cached_layers(x, positions, lengths, cache, None,
                                    block_table, attn_impl, decode=True)
        return self.unembed(x)[:, 0], cache, lengths + 1

    def _slotted_decode_layers(self, x, positions, lengths, cache):
        """Every layer of a slotted decode step.  Attention: the new k/v
        goes to slot ``lengths % Sk`` in place, then flash-decode (K7)
        attends over the first ``min(lengths + 1, Sk)`` slots — the
        reference's slot mask (positions ``lengths - ((lengths - slot) %
        Sk)`` in [0, lengths] and, for a ring of Sk <= window slots, inside
        the window).  MLA: the latent goes to slot ``lengths % Sk``, then
        plain attention over the slots at or before ``lengths``.  SSM: one
        recurrence step.  Under a serve sharder each layer is its
        sequence-sharded form (``_sharded_decode``)."""
        cfg = self.cfg
        rows = torch.arange(x.shape[0], device=x.device)
        sh = serve_sharder()
        for i, blk in enumerate(self.layers):
            # reference: transformer.py:919 (the decode body)
            x = constrain(x, ("batch", None, "act_embed"))
            leaves = self._leaves_of(cache, i)
            if blk.kind == "ssm":
                h = L.rms_norm(x, blk.ssm_norm, cfg.norm_eps)
                y = self._ssm_cached(blk, h, leaves, decode=True,
                                     names=self._names_of(i))
            elif sh is not None:
                h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
                y = self._sharded_decode(sh, blk, h, positions, lengths,
                                         self._names_of(i), leaves)
            else:
                h = L.rms_norm(x, blk.attn_norm, cfg.norm_eps)
                Sk = leaves[0].shape[1]
                slot = lengths.long() % Sk
                if blk.kind == "mla":
                    y = self._mla_cached(blk, h, positions, leaves, None,
                                         None, slot=slot)
                else:
                    kc, vc = leaves
                    q, k, v = L.attention_qkv(cfg, blk, h, positions)
                    kc[rows, slot] = k[:, 0]                # in place
                    vc[rows, slot] = v[:, 0]
                    kv_len = torch.clamp(lengths + 1, max=Sk).to(torch.int32)
                    attn = decode_attention(q[:, 0], kc, vc, kv_len,
                                            impl=self.attention_impl)
                    y = L.attention_out(blk, attn[:, None])
            x, _ = self._mlp(blk, x + y)
        return x

    def _sharded_decode(self, sh, blk, h, positions, lengths, names, leaves):
        """One GQA or MLA layer of a decode step over this rank's range [lo,
        lo + n) of the Sk slots (``sh.slot_range``): the owner of slot
        ``lengths % Sk`` writes the token, the rank attends over its valid
        slots, min(lengths + 1, Sk) - lo of them clamped to [0, n], and
        ``merge_partials`` combines the ranks over the slot dims.  GQA with
        split heads gathers q (and split kv heads) over 'model' first and
        projects out its own heads' slice after the merge."""
        cfg, mesh = self.cfg, sh.mesh
        slots = sh.slots(names[0])
        n = leaves[0].shape[1]
        lo, Sk = sh.slot_range(names[0], n)
        rows = torch.arange(h.shape[0], device=h.device)
        at = lengths.long() % Sk - lo
        mine = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)

        def write(leaf, val):                      # in place, owner only
            keep = mine.reshape((-1,) + (1,) * (val.dim() - 1))
            leaf[rows, at] = torch.where(keep, val, leaf[rows, at])

        if blk.kind == "mla":
            for leaf, val in zip(leaves, L.mla_latent(cfg, blk, h,
                                                      positions)):
                write(leaf, val[:, 0])
            kpos = lo + torch.arange(n, device=h.device)
            valid = (kpos[None, :] <= lengths.long()[:, None])[:, None, :]
            self.mla_expanded += h.shape[0] * n
            attn, lse = L.mla_partial(cfg, blk, h, *leaves, positions, valid)
            attn = L.merge_partials(attn, lse, mesh, slots)
            return torch.einsum("bshe,hed->bsd", attn, blk.wo)
        tp = blk.wq.shape[1] < cfg.num_heads
        w = _tp_weights(cfg, sh, blk) if tp else blk
        q, k, v = L.attention_qkv(cfg, w, h, positions)
        if tp:
            q = gather_along(q, mesh, sh.heads, 2)
            if k.shape[2] < cfg.num_kv_heads:
                k, v = (gather_along(t, mesh, ("model",), 2) for t in (k, v))
        kc, vc = leaves
        write(kc, k[:, 0])
        write(vc, v[:, 0])
        kv_len = (torch.clamp(lengths + 1, max=Sk) - lo).clamp(0, n)
        out, lse = decode_attention(q[:, 0], kc, vc, kv_len.to(torch.int32),
                                    impl=self.attention_impl,
                                    return_lse=True)
        out = L.merge_partials(out, lse, mesh, slots)
        if tp:                                   # this rank's heads of wo
            out = slice_over(out, mesh, sh.heads, 1)
        y = L.attention_out(blk, out[:, None])
        return reduce_from(y, mesh, ("model",)) if tp else y
