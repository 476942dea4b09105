"""Frame-deadline-aware serving on the PyTorch port: EDF vs FIFO admission.

Eight 30/60 FPS AR users share a 4-slot serving engine with background
bulk traffic (long prompts, no deadline).  Under FIFO a frame request
queues behind every bulk prefill submitted before it; under EDF it jumps
the backlog.  Chunked prefill keeps the long bulk prompts trickling
outside the shared pad bucket either way.

    PYTHONPATH=src python examples/torch_frame_pacing.py              # the card
    PYTHONPATH=src python examples/torch_frame_pacing.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.coic import CoICConfig
from repro_torch.data.workload import FramePacedWorkload
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    for policy in ("fifo", "edf"):
        wl = FramePacedWorkload(num_clusters=1, nodes_per_cluster=2,
                                frame_users_per_node=4, bulk_users_per_node=2,
                                bulk_rate=0.6, step_ms=2.0, pool_size=32,
                                seed=0)
        frame_p, bulk_p = wl.token_prompts(cfg.vocab_size, frame_len=12,
                                           bulk_len=64)
        eng = ServingEngine(model, ServingConfig(
            max_batch=4, max_len=80, max_new_tokens=4, queue_policy=policy,
            prefill_chunk=16, step_ms=wl.step_ms,
            coic=CoICConfig(capacity=24, threshold=0.98, descriptor="sketch",
                            descriptor_dim=64, num_nodes=2)), device=dev)
        is_frame = {}
        for round_ in wl.stream(150, seed=1):
            for fr in round_:
                rid = eng.submit(
                    bulk_p[fr.scene] if fr.bulk else frame_p[fr.scene],
                    node_id=fr.node, priority=fr.priority,
                    deadline_ms=fr.deadline_ms)
                is_frame[rid] = not fr.bulk
            eng.step()
        eng.run_until_drained()
        mtp = [r.completion_ms for r in eng.results if is_frame[r.req_id]]
        print(f"{policy:4s}: {len(mtp)} frames, "
              f"p50 {np.percentile(mtp, 50):6.1f} ms, "
              f"p99 {np.percentile(mtp, 99):6.1f} ms, "
              f"deadline miss rate {eng.deadline.miss_rate():.2f}")


if __name__ == "__main__":
    main()
