"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave + MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, head_dim=128.
Attention at layer i where i % 8 == 4 (1 attn : 7 mamba); MoE every other
layer (period 2, offset 1).  Mamba block: d_state=16, d_conv=4, expand=2.
[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk_size=256, ngroups=1),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  num_shared_experts=0, d_ff_shared=0,
                  expert_layer_period=2, expert_layer_offset=1,
                  first_dense_layers=0),
    attn_layer_period=8,
    attn_layer_offset=4,
    source="arXiv:2403.19887",
)
