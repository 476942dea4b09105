"""Quickstart of the PyTorch port: the CoIC edge cache in 30 lines.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import CoICConfig, CoICEngine
from repro_torch.core.coic import recognition_cloud_fn
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # 1. a "cloud" model (the paper's recognition DNN, here a compact LM)
    cfg = get_config("coic-paper")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    cloud = recognition_cloud_fn(model, num_classes=64)

    # 2. the CoIC engine: descriptor -> edge cache -> cloud on miss
    engine = CoICEngine(model, CoICConfig(capacity=256, threshold=0.98,
                                          payload_dim=64),
                        cloud_fn=cloud, miss_bucket=4, device=dev)

    # 3. a redundant request stream (two users at the same crossroads)
    rng = np.random.default_rng(0)
    scenes = rng.integers(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)

    for round_ in range(3):
        results = engine.process_batch(scenes)
        srcs = [r.source for r in results]
        mean_coic = np.mean([r.coic.total_ms for r in results])
        mean_origin = np.mean([r.origin.total_ms for r in results])
        print(f"round {round_}: served from {srcs}, "
              f"CoIC {mean_coic:.1f} ms vs origin {mean_origin:.1f} ms")

    print("cache stats:", engine.stats())


if __name__ == "__main__":
    main()
