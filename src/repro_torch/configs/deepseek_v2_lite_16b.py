"""deepseek-v2-lite-16b [moe]: MLA (kv_lora_rank=512) + fine-grained MoE.

27L d_model=2048 16H (kv=16) vocab=102400.
MoE: 64 routed experts top-6, 2 shared experts, d_ff_expert=1408; the first
layer is dense (d_ff=10944).  The assignment bracket lists "64e top-6" with a
note "2 shared+160 routed" — 160 routed is the full V2 (236B); the lite model
(and the primary spec line) is 64 routed, which we follow.
[arXiv:2405.04434; hf]
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,              # MLA: latent cache; per-head kv materialized from c_kv
    head_dim=128,                 # qk_nope head dim (see MLAConfig)
    d_ff=10944,                   # dense-MLP dim for first_dense_layers
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=2816,
                  expert_layer_period=1, expert_layer_offset=1,
                  first_dense_layers=1),
    rope_theta=10000.0,
    source="arXiv:2405.04434",
)
