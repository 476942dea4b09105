"""A run driven on the CPU at a tiny size (the look for a card skipped),
sound and then with the timed path broken underneath: ``correct`` holds
for the sound run and falls for every fault a serving cell can have."""
import numpy as np
import pytest
import torch

from perfbench import harness as H

TINY = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 1,
        "head_dim": 16, "d_ff": 128, "vocab_size": 512, "dtype": "float32"}
SERVE = {"max_batch": 4, "max_len": 128, "max_new_tokens": 4,
         "prefill_chunk": 32, "kv_pages": 0}
BACKLOG = {"len_lo": 8, "len_hi": 48, "waiting": 8,
           "warm": {"ramp_steps": 4, "settle_steps": 4}}
OVERRIDES = {
    "granite20b-unique": {"serving": SERVE, "traffic": BACKLOG},
    # the same backlog over 6 prompts: repeats, so the edge cache hits
    "granite20b-unique.repeats": {
        "serving": SERVE,
        "traffic": {**BACKLOG, "pool": 6, "zipf_s": 1.1}},
}


def _run(case, seed=2 ** 31 + 11):
    ov = dict(OVERRIDES[case])
    ov["model"] = {**TINY, **ov.get("model", {})}
    # fp32 at this size: a sound run reads 0 to rounding (~1e-6)
    ov["check"] = {"requests": 3, "served_gap_max": 1e-3,
                   "descriptor_dist_max": 1e-3}
    res, _ = H.run(case.split(".")[0], seed, 1.5, False, device="cpu",
                   overrides=ov)
    return res


def _roll_logits(fn):
    def wrapped(*a, **k):
        logits, *rest = fn(*a, **k)
        return (logits.roll(1, dims=-1), *rest)
    return wrapped


def _descriptor(fn):
    """Replace the descriptor's output by ``fn(output)``."""
    from repro_torch.core.descriptor import PrefixDescriptor
    orig = PrefixDescriptor.__call__

    def call(self, tokens):
        return fn(orig(self, tokens))
    return PrefixDescriptor, "__call__", call


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_sound_run_is_correct(case):
    res = _run(case)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert res["check"]["miss_sim_max"]["value"] < 0.98


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_decoded_token_altered(case, monkeypatch):
    from repro_torch.models.transformer import DecoderLM
    monkeypatch.setattr(DecoderLM, "decode_step",
                        _roll_logits(DecoderLM.decode_step))
    res = _run(case)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_prefill_token_altered(case, monkeypatch):
    from repro_torch.models.transformer import DecoderLM
    for name in ("prefill", "prefill_chunk"):
        monkeypatch.setattr(DecoderLM, name,
                            _roll_logits(getattr(DecoderLM, name)))
    res = _run(case)
    assert not res["correct"], res["check"]


def test_hit_answer_altered(monkeypatch):
    import repro_torch.serving.engine as E
    orig = E.route_flat

    def route_flat(*a, **k):
        res = orig(*a, **k)
        v = np.array(res.value, copy=True)
        hit = np.asarray(res.tier) != E.TIER_MISS
        v[hit] = (v[hit] + 1) % TINY["vocab_size"]
        return res._replace(value=v)

    monkeypatch.setattr(E, "route_flat", route_flat)
    res = _run("granite20b-unique.repeats")
    assert not res["correct"], res["check"]
    assert res["check"]["hit_token_mismatches"]["value"] > 0


def test_hit_missed(monkeypatch):
    """Every lookup forced to miss: a repeat of a prompt the cache holds
    is a wrong miss."""
    import repro_torch.serving.engine as E
    orig = E.route_flat

    def route_flat(*a, **k):
        res = orig(*a, **k)
        return res._replace(tier=np.full_like(np.asarray(res.tier),
                                              E.TIER_MISS))

    monkeypatch.setattr(E, "route_flat", route_flat)
    res = _run("granite20b-unique.repeats")
    assert not res["correct"], res["check"]
    assert res["check"]["miss_sim_max"]["value"] > 0.98


DESCRIPTOR_FAULTS = {
    "nan": lambda d: torch.full_like(d, float("nan")),
    "bf16": lambda d: torch.nn.functional.normalize(
        d.bfloat16().float() + 0.01 * d.roll(1, dims=-1), dim=-1),
    "constant": lambda d: torch.nn.functional.normalize(
        torch.ones_like(d), dim=-1),
}


@pytest.mark.parametrize("fault", sorted(DESCRIPTOR_FAULTS))
def test_descriptor_broken(fault, monkeypatch):
    """A descriptor not finite, computed coarser, or one for every prompt
    (so every lookup after the first hits) is caught on unique prompts."""
    monkeypatch.setattr(*_descriptor(DESCRIPTOR_FAULTS[fault]))
    res = _run("granite20b-unique")
    assert not res["correct"], res["check"]
