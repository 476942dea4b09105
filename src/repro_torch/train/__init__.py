# The training loop, the port of repro/train/trainer.py (elastic waits for the multi-card port).
