"""granite-20b [dense]: gpt-bigcode-arch code model with MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152, head_dim=128.
2-matrix GELU MLP (not gated) — that is what lands this config at ~20B.
[arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,               # multi-query attention
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_kind="gelu",
    rope_theta=10000.0,
    source="arXiv:2405.04324",
)
