"""The paper's own experiment scale: a small recognition DNN served behind the
CoIC edge cache.  Used by the Fig-2 reproduction benchmarks and the
end-to-end serving example — NOT part of the assigned-arch pool.

We model the recognizer as a compact decoder-only transformer whose pooled
final hidden state is the class logits path, matching the paper's "object
recognition via a DNN model" while staying in the LM substrate.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="coic-paper",
    family="dense",
    num_layers=6,
    d_model=256,
    num_heads=8,
    num_kv_heads=8,
    head_dim=32,
    d_ff=1024,
    vocab_size=4096,
    scan_layers=False,
    remat="nothing",
    source="CoIC SIGCOMM'18 poster, Section 3",
)
