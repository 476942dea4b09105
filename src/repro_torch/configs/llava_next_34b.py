"""llava-next-34b [vlm]: Yi-34B-class dense backbone; anyres vision tower is a
STUB (input_specs() provides precomputed patch embeddings).

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, head_dim=128.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    num_image_patches=576,        # one anyres base tile of CLIP-ViT-L/14 @336px
    rope_theta=5000000.0,
    source="hf:llava-hf/llava-v1.6-34b-hf",
)
