# Training, the port of repro/train/: the trainer and elastic resizes.
