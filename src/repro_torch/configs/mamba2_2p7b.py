"""mamba2-2.7b [ssm]: SSD (state-space duality), attention-free.

64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, head_dim=64 => 80 SSD heads.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    head_dim=64,                  # SSD head dim (P)
    d_ff=0,                       # no separate MLP; the mamba block is the mixer+MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256, ngroups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
