"""whisper-small [audio]: encoder-decoder; conv/mel frontend is a STUB
(input_specs() provides precomputed frame embeddings).

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865, head_dim=64.
12 encoder layers + 12 decoder layers.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,                # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,              # MHA
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encdec=EncDecConfig(num_encoder_layers=12, decoder_len_ratio=0.25),
    audio_frontend=True,
    norm_eps=1e-5,
    source="arXiv:2212.04356",
)
