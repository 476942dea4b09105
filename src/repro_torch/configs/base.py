"""Configuration system (PyTorch port's own copy of ``repro/configs/base.py``).

``ModelConfig`` carries every field of the reference dataclass so a config
compares field for field with its JAX twin.  One file per arch lives next
to this module and exports ``CONFIG``; ``repro_torch.configs.get_config``
resolves the ported ones (``PORTED_CONFIGS``).

Shape cells (assigned): ``train_4k``, ``prefill_32k``, ``decode_32k``,
``long_500k``.  ``decode_*``/``long_*`` lower ``serve_step`` (one new token
against a KV cache of ``seq_len``), not ``train_step``.  ``long_500k`` is only
defined for sub-quadratic archs (SWA / SSM / hybrid) — see
``supports_cell``.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts MLP block."""

    num_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int                 # hidden dim of each routed expert
    num_shared_experts: int = 0      # DeepSeek-style always-on shared experts
    d_ff_shared: int = 0             # hidden dim of the shared expert stack
    # Which layers are MoE: layer i is MoE iff
    #   i >= first_dense_layers and (i - expert_layer_offset) % expert_layer_period == 0
    expert_layer_period: int = 1
    expert_layer_offset: int = 0
    first_dense_layers: int = 0      # leading dense-MLP layers (DeepSeek: 1)
    router_aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int                # latent c_kv dim (512 for v2-lite)
    q_lora_rank: int = 0             # 0 => no q compression (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block."""

    d_state: int = 128
    head_dim: int = 64               # P in the SSD paper
    expand: int = 2                  # d_inner = expand * d_model
    d_conv: int = 4
    chunk_size: int = 256
    ngroups: int = 1                 # B/C groups (GVA)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper-style).  Frontend is a stub: the encoder
    consumes precomputed frame embeddings from input_specs()."""

    num_encoder_layers: int = 12
    # decoder length as a fraction of the cell seq_len for train/prefill cells
    decoder_len_ratio: float = 0.25


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    qkv_bias: bool = False
    mlp_kind: str = "gated_silu"     # gated_silu (3 mats) | gelu (2 mats)
    sliding_window: int = 0          # 0 => full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"

    # Port-only fields (the reference has none); each default computes the
    # reference's arithmetic.
    # YaRN on MLA's rope dims at this factor, with the rest of DeepSeek-V2's
    # published ``rope_scaling`` (``layers.YARN_*``); 1: plain RoPE and the
    # plain 1/sqrt(dn + dr) softmax scale
    yarn_factor: float = 1.0
    # False: the router's top-k softmax weights are used as they are
    # (DeepSeek-V2's ``norm_topk_prob``), not divided by their sum
    moe_norm_topk_prob: bool = True
    # True: no expert capacity, every assignment kept (``DecoderLM`` then
    # takes the drop-free ``grouped`` route)
    moe_drop_free: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None

    # hybrid (jamba): layer i is attention iff
    #   i % attn_layer_period == attn_layer_offset; otherwise mamba.
    attn_layer_period: int = 0       # 0 => all layers are attention (or SSM if family=="ssm")
    attn_layer_offset: int = 0

    # vlm stub frontend: number of image-patch embedding positions prepended
    num_image_patches: int = 0
    # audio stub frontend: encoder consumes precomputed frame embeddings
    audio_frontend: bool = False

    # scan-over-layers for O(1) HLO depth; turned off for tiny smoke configs
    scan_layers: bool = True
    remat: str = "full"              # full | nothing | dots
    loss_chunk: int = 0              # >0: chunked CE (fp32 logits never materialize)

    source: str = ""                 # citation tag from the assignment

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True iff attention cost doesn't grow quadratically with seq:
        SSM, hybrid (mamba-dominated), or sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for layer i of the backbone."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_layer_period > 0:
            return "attn" if i % self.attn_layer_period == self.attn_layer_offset else "ssm"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense_layers:
            return False
        return (i - m.expert_layer_offset) % m.expert_layer_period == 0

    def param_count(self) -> int:
        """Exact parameter count: the port's model built on the ``meta``
        device (nothing allocated, so any width is cheap), counted over
        ``init_shapes``, the reference's flat layout (tied embeddings
        without a head, whisper's full decoder position table)."""
        from repro_torch.models.registry import build_model  # no cycle

        model = build_model(self, device="meta")
        return int(sum(math.prod(s.shape)
                       for s in model.init_shapes().values()))

    def active_param_count_ratio(self) -> float:
        """active/total ratio for MoE archs (used for MODEL_FLOPS = 6*N_active*D)."""
        m = self.moe
        if m is None:
            return 1.0
        # per-MoE-layer FFN params: routed experts vs active (top_k + shared)
        total_ffn = m.num_experts * m.d_ff_expert + m.num_shared_experts * m.d_ff_shared
        active_ffn = m.top_k * m.d_ff_expert + m.num_shared_experts * m.d_ff_shared
        if total_ffn == 0:
            return 1.0
        return active_ffn / total_ffn  # FFN-only ratio; combined in roofline.py


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)

SHAPES = {c.name: c for c in SHAPE_CELLS}


def supports_cell(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % cfg.name
    return True, ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "h2o_danube3_4b",
    "granite_20b",
    "llama32_1b",
    "qwen2_72b",
    "mamba2_2p7b",
    "whisper_small",
    "deepseek_v2_lite_16b",
    "granite_moe_3b_a800m",
    "llava_next_34b",
    "jamba_v01_52b",
)

_ALIASES = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "granite-20b": "granite_20b",
    "llama3.2-1b": "llama32_1b",
    "qwen2-72b": "qwen2_72b",
    "mamba2-2.7b": "mamba2_2p7b",
    "whisper-small": "whisper_small",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llava-next-34b": "llava_next_34b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "coic-paper": "coic_paper",
}


# configurations this package carries a copy of: every one of the
# reference's
PORTED_CONFIGS = ("coic_paper", "llama32_1b", "h2o_danube3_4b", "granite_20b",
                  "qwen2_72b", "granite_moe_3b_a800m", "deepseek_v2_lite_16b",
                  "mamba2_2p7b", "jamba_v01_52b", "llava_next_34b",
                  "whisper_small")


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in PORTED_CONFIGS:
        raise ValueError(f"unknown config {name!r}; known: {PORTED_CONFIGS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (one fwd/train step)."""
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        num_layers=4 if cfg.family in ("hybrid",) else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        qkv_bias=cfg.qkv_bias,
        sliding_window=16 if cfg.sliding_window else 0,
        tie_embeddings=cfg.tie_embeddings,
        rope_theta=cfg.rope_theta,
        scan_layers=False,
        remat="nothing",
        attn_layer_period=0,
        attn_layer_offset=0,
        num_image_patches=0,
        audio_frontend=cfg.audio_frontend,
    )
    if cfg.family == "hybrid":
        kw["attn_layer_period"] = 4
        kw["attn_layer_offset"] = 1
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=4,
            top_k=2,
            d_ff_expert=32,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_shared=32 if cfg.moe.num_shared_experts else 0,
            expert_layer_period=cfg.moe.expert_layer_period,
            expert_layer_offset=min(cfg.moe.expert_layer_offset, 1),
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2, d_conv=4,
                              chunk_size=16, ngroups=1)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(num_encoder_layers=2, decoder_len_ratio=0.5)
    if cfg.num_image_patches:
        kw["num_image_patches"] = 4
    return ModelConfig(**kw)
