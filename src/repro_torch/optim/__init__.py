# AdamW, the LR schedule and gradient compression, the port of
# repro/optim/.
from repro_torch.optim.adamw import AdamW, AdamWConfig, OptState
from repro_torch.optim.schedule import cosine_with_warmup
