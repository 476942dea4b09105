"""granite-moe-3b-a800m [moe]: 40 experts top-8 (assignment spec line).

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, head_dim=64.
The bracket cites hf:ibm-granite/granite-3.0-1b-a400m-base (32e top-8); the
assignment's primary spec line says 40e top-8, which we follow.
[hf:ibm-granite/granite-3.0-*-base]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,                     # expert hidden dim
    vocab_size=49155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                  num_shared_experts=0, d_ff_shared=0,
                  expert_layer_period=1, expert_layer_offset=0,
                  first_dense_layers=0),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
