"""Serving launcher — the port of ``repro/launch/serve.py``: the CoIC edge
cache in front of a batched LM server.

Replays a Zipf request stream against the engine and reports the hit
rate and latency percentiles, the deployment shape of the paper's
evaluation.  The same flags, defaults, stream and printed lines as the
reference, plus ``--device`` (``cuda`` by default: without a GPU it
raises unless asked for ``cpu``).  On the card the stream runs the edge
cache's batched lookup (K1), and the engine's slotted cache (the
reference's: no page flag) flash attention (K8) and flash-decode (K7);
the cache's own lookup API on the returned engine
(``engine.semantic.lookup``) runs K2 and K3.

    python -m repro_torch.launch.serve --arch llama3.2-1b
    python -m repro_torch.launch.serve --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.coic import CoICConfig
from repro_torch.core.policies import EvictionPolicy
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServingConfig, ServingEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="coic-paper")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--pool", type=int, default=16,
                    help="distinct request contents")
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--threshold", type=float, default=0.98)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--policy", default="lru", choices=["lru", "lfu", "fifo"])
    ap.add_argument("--scheduling", default="batched",
                    choices=["batched", "sequential"],
                    help="batched: one lookup ladder per engine step; "
                         "sequential: one per request (baseline)")
    ap.add_argument("--no-coic", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def build(args, params=None):
    """The model of ``args``: random weights from seed 0, or the
    reference's flat ``params`` (numpy arrays, ``params_from_jax``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    if params is not None:
        model = build_model(cfg, device=dev)
        params_from_jax(params, model)
        return model
    return build_model(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))


def zipf_stream(args, vocab_size: int):
    """(pool (pool, prompt_len) int32, the pool index of each request):
    the reference's stream, the same draws from ``default_rng(0)`` in the
    same order."""
    rng = np.random.default_rng(0)
    pool = rng.integers(0, vocab_size,
                        size=(args.pool, args.prompt_len)).astype(np.int32)
    ranks = np.arange(1, args.pool + 1, dtype=np.float64)
    probs = ranks ** (-args.zipf)
    probs /= probs.sum()
    return pool, [rng.choice(args.pool, p=probs)
                  for _ in range(args.requests)]


def run(args, model=None, params=None) -> ServingEngine:
    """Serve the Zipf stream of ``args`` (``model`` built by ``build``
    when not given), print the reference's lines, return the engine."""
    model = build(args, params) if model is None else model
    cfg = model.cfg
    coic = None if args.no_coic else CoICConfig(
        capacity=args.capacity, threshold=args.threshold,
        descriptor="prefix", k_layers=2,
        policy=EvictionPolicy(args.policy))
    eng = ServingEngine(model, ServingConfig(
        max_batch=8, max_len=args.prompt_len + args.max_new + 8,
        max_new_tokens=args.max_new, coic=coic,
        scheduling=args.scheduling), device=args.device)

    pool, draws = zipf_stream(args, cfg.vocab_size)
    t0 = time.perf_counter()
    for idx in draws:
        eng.submit(pool[idx])
        eng.step()
    eng.run_until_drained()
    wall = time.perf_counter() - t0

    lat = [r.latency_s for r in eng.results if r.source == "cloud"]
    stats = eng.stats()
    print(f"served {stats['completed']} requests in {wall:.2f}s "
          f"({stats['completed']/wall:.1f} req/s)")
    print(f"edge hits: {stats['edge_hits']}  peer hits: {stats['peer_hits']}  "
          f"cloud: {stats['cloud']}")
    print(f"device dispatches: {stats['dispatches']}")
    if "semantic" in stats:
        print(f"semantic cache: {stats['semantic']}")
    if lat:
        print(f"cloud latency p50 {np.percentile(lat, 50)*1e3:.1f} ms  "
              f"p95 {np.percentile(lat, 95)*1e3:.1f} ms")
    return eng


def main(argv=None) -> ServingEngine:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
