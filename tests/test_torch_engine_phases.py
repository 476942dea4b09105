"""The serving engine's launch phases and pad-fill histograms (port only,
CPU): under a tracer every model launch's span holds ``pack``, ``forward``
and ``sample`` (the slotted decode has nothing to pack; a slotted chunk
that is not a prompt's last reads no token), and every launch feeds
``engine/fill/{descriptor,prefill,decode}/{tokens,slots}`` with the real
tokens and the slots of the padded shape it ran, traced or not; an MLA
model's prefill, chunk and decode launches feed
``engine/mla/{expanded,written}`` (latent rows expanded to per-head K and
V, latent rows written).

A tiny fp32 ``coic-paper`` behind a prefix descriptor serves three
prompts of 5, 20 and 37 tokens at once (4 rows, chunks of 16, 3 new
tokens), worked by hand below, then a prompt of 60 tokens that shares 24
with the longest one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.coic import CoICConfig
from repro_torch.models import build_model
from repro_torch.obs.trace import PID_ENGINE, NullTracer, Tracer
from repro_torch.serving.engine import ServingConfig, ServingEngine

LENS = (5, 20, 37)
LAYOUTS = {
    "paged": dict(kv_page=8, attn_impl="paged"),
    "slotted": dict(),
}

# By hand.  One descriptor launch: 3 prompts padded to (4, pow2(37) = 64).
# Paged: packed chunk launches of [5, 16, 16], [4, 16], [5] real tokens,
# no pad (padded, they were (4, 16), (2, 16), (1, 16): 112 slots).  Slotted: the 5-token prompt in one (1, 8) prefill, the others one
# (1, 16) chunk each a step: [16, 16], [4, 16], [5].  Decode, both: the
# 5-token row decodes at steps 1-2, the 20-token one at 2-3, the 37-token
# one at 3-4 (3 new tokens: the prefill's and two decoded), 4 launches of
# 4 rows.
EXPECT = {
    "paged": {"descriptor": (1, 62, 256), "prefill": (3, 62, 62),
              "decode": (4, 6, 16)},
    "slotted": {"descriptor": (1, 62, 256), "prefill": (6, 62, 88),
                "decode": (4, 6, 16)},
}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("coic-paper"), dtype="float32")
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _engine(model, layout, tracer=None):
    cfg = ServingConfig(max_batch=4, max_len=64, max_new_tokens=3,
                        prefill_chunk=16,
                        coic=CoICConfig(capacity=16, threshold=0.98,
                                        descriptor="prefix", k_layers=2),
                        **LAYOUTS[layout])
    return ServingEngine(model, cfg, tracer=tracer, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def _serve(eng, second_wave=True):
    """The three prompts at once, drained; then one of 60 tokens that
    shares the longest one's first 24 (3 pages), drained: its descriptor
    lies under the threshold, so the model serves it."""
    prompts = _prompts(eng.model.cfg.vocab_size)
    for p in prompts:
        eng.submit(p)
    eng.run_until_drained()
    if second_wave:
        rng = np.random.default_rng(2)
        tail = rng.integers(0, eng.model.cfg.vocab_size, 36).astype(np.int32)
        eng.submit(np.concatenate([prompts[2][:24], tail]))
        eng.run_until_drained()
    return {r.req_id: (r.source, r.tokens.tolist()) for r in eng.results}


def _fill(eng, kind):
    """(launches, tokens, slots) of ``engine/fill/<kind>/*``."""
    tok = eng.metrics.get(f"engine/fill/{kind}/tokens")
    slot = eng.metrics.get(f"engine/fill/{kind}/slots")
    assert tok.count == slot.count
    return tok.count, tok.sum, slot.sum


def _tree(events):
    """Engine-track spans as [name, children] nodes, in order."""
    root, stack = [None, []], []
    stack.append(root)
    for ev in events:
        if ev.get("pid") != PID_ENGINE or ev.get("ph") not in ("B", "E"):
            continue
        if ev["ph"] == "B":
            node = [ev["name"], []]
            stack[-1][1].append(node)
            stack.append(node)
        else:
            stack.pop()
    assert len(stack) == 1, "unclosed spans"
    return root[1]


def _walk(nodes, path=()):
    for name, kids in nodes:
        yield path + (name,), [k[0] for k in kids]
        yield from _walk(kids, path + (name,))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fill_histograms_match_hand_pads(model, layout):
    eng = _engine(model, layout)
    _serve(eng, second_wave=False)
    assert {k: _fill(eng, k) for k in EXPECT[layout]} == EXPECT[layout]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prefill_fill_counts_computed_tokens(model, layout):
    eng = _engine(model, layout)
    res = _serve(eng)
    assert [s for s, _ in res.values()] == ["cloud"] * 4
    if layout == "paged":
        assert eng.prefill_tokens_shared == 24
    _, tokens, slots = _fill(eng, "prefill")
    assert tokens == eng.prefill_tokens_computed == sum(LENS) + 60 - (
        24 if layout == "paged" else 0)
    # the paged chunks are packed: their slots are their tokens
    assert tokens == slots if layout == "paged" else tokens < slots


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_launch_spans_hold_their_phases(model, layout):
    tr = Tracer()
    eng = _engine(model, layout, tracer=tr)
    _serve(eng)
    shapes = {}
    for path, kids in _walk(_tree(tr.events)):
        if path[-1] in ("pack", "forward", "sample"):
            # the phases sit directly under a launch span, childless
            assert path[-2] in ("decode", "prefill", "prefill_chunk"), path
            assert kids == [], path
        if path[-1] in ("decode", "prefill", "prefill_chunk"):
            shapes.setdefault(path[-1], set()).add(tuple(kids))
    full = ("pack", "forward", "sample")
    if layout == "paged":
        assert shapes == {"decode": {full}, "prefill_chunk": {full}}
    else:
        assert shapes == {"decode": {("forward", "sample")},
                          "prefill": {full},
                          "prefill_chunk": {full, ("pack", "forward")}}
    # the launch spans keep their parents
    parents = {path[:-1] for path, _ in _walk(_tree(tr.events))
               if path[-1] in ("decode", "prefill", "prefill_chunk")}
    assert parents <= {("step",), ("step", "admit")}


class _Spy(NullTracer):
    """A disabled tracer that records any call the engine makes on it."""

    def __init__(self):
        self.calls = []

    def begin(self, name, **kw):
        self.calls.append(("begin", name))

    def end(self, **kw):
        self.calls.append(("end",))

    def complete(self, name, *a, **kw):
        self.calls.append(("complete", name))

    def instant(self, name, **kw):
        self.calls.append(("instant", name))

    def request_timeline(self, rid, *a, **kw):
        self.calls.append(("request_timeline", rid))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_traced_and_untraced_serve_the_same(model, layout):
    traced = _engine(model, layout, tracer=Tracer())
    spy = _Spy()
    untraced = _engine(model, layout, tracer=spy)
    assert _serve(traced) == _serve(untraced)
    assert spy.calls == []
    for kind in EXPECT[layout]:
        assert _fill(traced, kind) == _fill(untraced, kind)


# An MLA model (reduced deepseek-v2-lite, 2 MLA layers) on the same
# prompts: each launch observes the latent rows it expands (rows x the keys
# each row's view holds x 2 layers) and those it writes (real tokens x 2).
# Paged: MLA keeps the padded chunk, (4, 16), (2, 16), (1, 16), each row
# viewing its whole table of max_len 64 keys; 4 decodes of 4 rows x 64.
# Slotted: the (1, 8) prefill views its 8 padded keys, the five (1, 16)
# chunks their B=1 cache of 64; 4 decodes of 4 rows x 64.
MLA_EXPECT = {
    "paged": {"expanded": (7, (4 + 2 + 1) * 64 * 2 + 4 * 4 * 64 * 2),
              "written": (7, (62 + 6) * 2)},
    "slotted": {"expanded": (10, 8 * 2 + 5 * 64 * 2 + 4 * 4 * 64 * 2),
                "written": (10, (62 + 6) * 2)},
}


@pytest.fixture(scope="module")
def mla_model():
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(get_config(
        "deepseek-v2-lite-16b")), dtype="float32")
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mla_counters_match_hand_views(model, mla_model, layout):
    eng = _engine(mla_model, layout)
    res = _serve(eng, second_wave=False)
    assert [s for s, _ in res.values()] == ["cloud"] * 3
    got = {k: (h.count, h.sum) for k in ("expanded", "written")
           for h in (eng.metrics.get(f"engine/mla/{k}"),)}
    assert got == MLA_EXPECT[layout]
    # a model without MLA registers neither
    plain = _engine(model, layout)
    _serve(plain, second_wave=False)
    assert not {"engine/mla/expanded", "engine/mla/written"} & set(
        plain.metrics.snapshot())


def test_mla_tally_counts_the_gathered_width(mla_model):
    """The model counts what MLA expands, not what the engine's table
    holds: a paged decode step of 3 rows through a block table of 5 pages
    of 4 (20 keys, not a ``max_len``) expands 3 x 20 latent rows in each
    of the 2 MLA layers, and a full prefill of (2, 7) tokens 2 x 7 each."""
    m = mla_model
    m.mla_expanded = 0
    pool = {k: torch.zeros(s, dtype=d)
            for k, (s, d) in m.paged_cache_specs(16, 4).items()}
    table = torch.arange(15, dtype=torch.int32).reshape(3, 5)
    m.decode_step(pool, torch.tensor([1, 2, 3]),
                  torch.tensor([0, 6, 19], dtype=torch.int32),
                  block_table=table)
    assert m.mla_expanded == 3 * 20 * 2
    m.mla_expanded = 0
    m.prefill(torch.ones((2, 7), dtype=torch.long), max_len=16)
    assert m.mla_expanded == 2 * 7 * 2
    m.mla_expanded = 0
