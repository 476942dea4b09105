"""The comparison that decides ``correct``.

Four numbers, each against its limit (the configuration file's ``check``,
and its ``coic.threshold``):

  hit_token_mismatches  every request of the run that the edge cache
      answered must carry the tokens of a request for the same prompt
      that the model served (``cloud``) in an earlier step: its source
      miss.  A hit with other tokens, or with no such miss, is a mismatch.
      Limit 0.
  served_gap_max  a sample of the window's served requests, drawn from
      the seed (``check.requests`` of them, the longest prompt always
      among them), goes through the plain fp32 reference with its served
      tokens; at each position that produced a served token, the gap by
      which that token's reference logit lies below the reference's best.
      The widest gap over the sample against ``check.served_gap_max``.
  descriptor_dist_max  for the same sample, the distance between the unit
      descriptor the engine's lookup used (recorded where the engine
      extracted it, ``harness.Driver``) and the reference's (the prompt's
      hidden state after ``coic.k_layers`` layers, mean-pooled, unit
      length), widest over the sample, against
      ``check.descriptor_dist_max``.  A descriptor that was never
      extracted, or is not finite, reads infinite.
  miss_sim_max  each sampled request was a miss; its reference descriptor
      against the keys the edge cache held when its lookup ran: the
      engine's descriptors of the ``coic.capacity`` model-served requests
      that retired last before that step (the keys a cache that only
      inserts holds: exact while nothing hits, as in every cell's traffic
      now).  The best cosine over the sample lies under
      ``coic.threshold``, the configuration's own limit, or the miss was
      wrong.

All run once the window has closed and the program is freed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench import reference as REF

SAMPLE_TAG = 0xC4EC


def hit_mismatches(finished) -> int:
    served: Dict[int, List] = {}
    for r in finished:
        if r.source == "cloud":
            served.setdefault(r.content, []).append(r)
    bad = 0
    for r in finished:
        if r.source == "cloud":
            continue
        ok = any(m.finish_step < r.finish_step
                 and np.array_equal(m.tokens, r.tokens)
                 for m in served.get(r.content, []))
        bad += not ok
    return bad


def sample(seed: int, window, n: int):
    """Up to ``n`` of the window's model-served requests, drawn from the
    seed, the one with the longest prompt first."""
    pool = sorted((r for r in window if r.source == "cloud"
                   and r.tokens is not None), key=lambda r: r.rid)
    if not pool:
        return []
    longest = max(pool, key=lambda r: (r.prompt_len, -r.rid))
    rest = [r for r in pool if r is not longest]
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), SAMPLE_TAG])
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def descriptor_dist(picked, ref_desc) -> float:
    """Widest distance between the engine's and the reference's unit
    descriptors of ``picked`` (infinite where one is missing or not
    finite)."""
    worst = 0.0
    for r, d in zip(picked, ref_desc):
        if r.desc is None:
            return float("inf")
        dist = float(np.linalg.norm(np.asarray(r.desc, np.float64)
                                    - d.double().numpy()))
        if not np.isfinite(dist):
            return float("inf")
        worst = max(worst, dist)
    return worst


def miss_sim(picked, ref_desc, finished, capacity: int) -> float:
    """Best cosine of a sampled miss's reference descriptor against the
    keys cached when its lookup ran (-1 where the cache was empty)."""
    served = sorted((m for m in finished if m.source == "cloud"
                     and m.desc is not None),
                    key=lambda m: (m.finish_step, m.rid))
    ends = np.array([m.finish_step for m in served], np.int64)
    keys = (np.stack([np.asarray(m.desc, np.float64) for m in served])
            if served else np.zeros((0, 0)))
    best = -1.0
    for r, d in zip(picked, ref_desc):
        if r.sched_step is None:
            return float("inf")
        hi = int(np.searchsorted(ends, r.sched_step, side="left"))
        cached = keys[max(0, hi - capacity):hi]
        if len(cached):
            sim = float((cached @ d.double().numpy()).max())
            best = max(best, sim if np.isfinite(sim) else float("inf"))
    return best


def judge(torch, spec, config, seed, traffic, finished, window, device,
          control: bool = False):
    """({name: {"value", "limit"}} of the numbers compared, {the served
    tokens checked, and with ``control`` the fp8 control's widest gap and
    descriptor distance on the same sample})."""
    lim = config["check"]
    coic = config["coic"]
    out = {"hit_token_mismatches": {
        "value": float(hit_mismatches(finished)),
        "limit": 0.0}}
    picked = sample(seed, window, int(lim["requests"]))
    gap = dist = sim = float("inf")
    cgap = cdist = None
    if picked:
        prompts = [torch.as_tensor(traffic.prompt(r.content)) for r in picked]
        served = [torch.as_tensor(r.tokens.astype(np.int64)) for r in picked]
        ref = REF.served_gaps(spec, seed, prompts, served, device,
                              control=control,
                              k_layers=int(coic["k_layers"]))
        gap = float(max(g.max() for g in ref.gaps))
        dist = descriptor_dist(picked, ref.desc)
        sim = miss_sim(picked, ref.desc, finished, int(coic["capacity"]))
        if control:
            cgap = float(max(g.max() for g in ref.control_gaps))
            cdist = float(max((c - d).norm() for c, d
                              in zip(ref.control_desc, ref.desc)))
    out["served_gap_max"] = {"value": gap,
                             "limit": float(lim["served_gap_max"])}
    out["descriptor_dist_max"] = {"value": dist,
                                  "limit": float(lim["descriptor_dist_max"])}
    out["miss_sim_max"] = {"value": sim, "limit": float(coic["threshold"])}
    info = {"served_tokens_checked": sum(len(r.tokens) for r in picked),
            "requests_checked": len(picked)}
    if control:
        info["control_gap_max"] = cgap
        info["control_descriptor_dist_max"] = cdist
    return out, info
