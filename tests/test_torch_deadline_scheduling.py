"""EDF / deadline scheduling of the PyTorch ``ServingEngine`` against the
JAX one (CPU, fp32 ``coic-paper``, same weights).

Mirrors tests/test_deadline_scheduling.py through both engines:
``queue_policy="edf"`` (and ``"fifo"`` where the reference compares the
two), ``submit(..., priority, deadline_ms)`` and ``step_ms > 0``, where a
request's completion is deterministic (queueing steps times ``step_ms``
plus the modeled tier terms).  Per request the decoded tokens, source,
finish step, ``deadline_ms``, ``completion_ms`` and ``deadline_miss`` must
be equal, and so must the stats' ``"deadline"`` block.  The reference's
scheduling properties (a frame jumps the bulk backlog, priority breaks
ties, an expired budget is served and counted) are checked on the port's
results as well.
"""
import numpy as np
import pytest

from repro.core.coic import CoICConfig as JCoIC
from repro.serving.engine import ServingConfig as JServing
from repro.serving.engine import ServingEngine as JServe
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.serving.engine import ServingConfig as TServing
from repro_torch.serving.engine import ServingEngine as TServe
from torch_twins import twin


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(L,)).astype(np.int32) for L in lens]


def _serve_both(lens, deadlines=None, priorities=None, policy="edf",
                max_batch=2, max_new=4, chunk=0, pacing=1, step_ms=2.0,
                coic=False, repeat=()):
    """Both engines over the same prompts (``repeat`` re-submits prompts
    by index after the first ones, for edge hits behind ``coic``)."""
    cfg, jm, jp, tm = twin("coic-paper")
    prompts = _prompts(cfg.vocab_size, lens)
    prompts += [prompts[i] for i in repeat]
    kw = dict(max_batch=max_batch, max_len=96, max_new_tokens=max_new,
              queue_policy=policy, prefill_chunk=chunk, chunk_pacing=pacing,
              step_ms=step_ms)
    je = JServe(jm, jp, JServing(
        coic=JCoIC(capacity=16, threshold=0.98) if coic else None, **kw))
    te = TServe(tm, TServing(
        coic=TCoIC(capacity=16, threshold=0.98) if coic else None, **kw),
        device="cpu")
    for i, p in enumerate(prompts):
        sub = dict(priority=priorities[i] if priorities else 0,
                   deadline_ms=deadlines[i] if deadlines else None)
        assert je.submit(p, **sub) == te.submit(p, **sub)
        if coic and i == len(lens) - 1:
            je.run_until_drained()    # cache the first prompts' results
            te.run_until_drained()
    je.run_until_drained()
    te.run_until_drained()
    return je, te


def _compare(je, te):
    """Per-request and ``"deadline"`` equality; returns the port's
    {req_id: (source, tokens, finish_step)}."""
    jr = {r.req_id: r for r in je.results}
    tr = {r.req_id: r for r in te.results}
    assert sorted(jr) == sorted(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].source == jr[rid].source, rid
        assert tr[rid].finish_step == jr[rid].finish_step, rid
        assert tr[rid].deadline_ms == jr[rid].deadline_ms, rid
        assert tr[rid].completion_ms == pytest.approx(
            jr[rid].completion_ms, rel=1e-12, abs=1e-9), rid
        assert tr[rid].deadline_miss == jr[rid].deadline_miss, rid
    assert te.stats()["deadline"] == je.stats()["deadline"]
    return {rid: (r.source, tuple(int(t) for t in r.tokens), r.finish_step)
            for rid, r in tr.items()}


@pytest.mark.parametrize("policy", ["edf", "fifo"])
@pytest.mark.parametrize("case", ["none", "equal"])
def test_no_or_equal_deadlines_match_jax(case, policy):
    """No deadlines, or one deadline for all: EDF drains in FIFO order,
    in both engines."""
    lens = [16, 24, 12, 20, 16]
    dls = None if case == "none" else [500.0] * len(lens)
    _compare(*_serve_both(lens, deadlines=dls, policy=policy))


@pytest.mark.parametrize("policy", ["edf", "fifo"])
def test_deadline_request_jumps_bulk_backlog_matches_jax(policy):
    """One slot: a frame submitted after three bulk requests finishes
    first under EDF and last under FIFO, in both engines."""
    res = _compare(*_serve_both([24, 24, 24, 12],
                                deadlines=[None, None, None, 40.0],
                                policy=policy, max_batch=1))
    bulk = [res[r][2] for r in (0, 1, 2)]
    if policy == "edf":
        assert res[3][2] < min(bulk)
    else:
        assert res[3][2] > max(bulk)


def test_priority_breaks_ties_matches_jax():
    res = _compare(*_serve_both([16, 16, 16],
                                deadlines=[100.0, 100.0, None],
                                priorities=[0, 5, 0], max_batch=1))
    assert res[1][2] <= res[0][2] <= res[2][2]


def test_expired_deadline_served_and_counted_matches_jax():
    je, te = _serve_both([16], deadlines=[0.0])
    _compare(je, te)
    r = te.results[0]
    assert r.deadline_miss and r.deadline_ms == 0.0 and len(r.tokens) == 4
    assert te.deadline.missed == {"cloud": 1}
    assert te.stats()["deadline"]["observed"] == 1


@pytest.mark.parametrize("pacing", [1, 4])
def test_chunked_admission_with_deadlines_matches_jax(pacing):
    """A long prompt trickling through ``prefill_chunk`` beside short
    frames with budgets, some of which are missed."""
    je, te = _serve_both([50, 12, 12, 12], deadlines=[None, 30.0, 1.0, 12.0],
                         priorities=[0, 1, 0, 2], chunk=8, pacing=pacing,
                         max_new=6, step_ms=1.0)
    _compare(je, te)
    assert te.dispatches["prefill_chunk"] >= 7
    st = te.stats()["deadline"]
    assert st["observed"] == 3 and sum(st["missed"].values()) > 0


def test_edge_hits_with_deadlines_match_jax():
    """Behind the CoIC front: repeated prompts are edge hits, whose
    completion is their modeled tier terms plus the queueing steps."""
    je, te = _serve_both([16, 24, 12], deadlines=[20.0, None, 5.0, 20.0,
                                                  1.0, None],
                         coic=True, repeat=(0, 1, 2))
    res = _compare(je, te)
    assert sum(src == "edge" for src, _, _ in res.values()) >= 3
    assert te.stats()["deadline"]["observed"] == 4
