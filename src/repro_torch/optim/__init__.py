# AdamW and the LR schedule, the port of repro/optim/ (grad_compress waits
# for the multi-card port, ROADMAP.md Queue 1 item 12).
from repro_torch.optim.adamw import AdamW, AdamWConfig, OptState
from repro_torch.optim.schedule import cosine_with_warmup
