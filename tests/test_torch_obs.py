"""The port's observability exports against the reference's (CPU).

* ``repro_torch.obs.metrics.export_prometheus`` renders the registry of
  the reference's golden test to ``tests/golden/metrics.prom``, byte for
  byte, and to the same text as ``repro.obs.metrics.export_prometheus``;
* the port's ``Tracer`` (with its ``max_steps`` ring) exports Chrome
  trace-event JSON that ``scripts/check_trace.py``'s ``validate`` accepts;
* a seeded federated + paged + EDF run (the stream of tests/test_obs.py)
  through the JAX and the PyTorch ``ServingEngine`` (fp32 ``coic-paper``
  at vocab 32, same weights) exports traces with the same span counts and
  request timelines, whose modeled request spans reconstruct each
  request's ``completion_ms``, and registry snapshots that
  ``check_metrics`` accepts, with equal counters.
"""
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.coic import CoICConfig as JCoIC
from repro.data.workload import SharedPrefixWorkload
from repro.models import build_model as jax_build
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.metrics import export_prometheus as jax_export_prometheus
from repro.obs.trace import Tracer as JTracer
from repro.serving.engine import ServingConfig as JServing
from repro.serving.engine import ServingEngine as JServe
from repro_torch.configs import get_config as torch_get_config
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import params_from_jax
from repro_torch.obs.metrics import MetricsRegistry, export_prometheus
from repro_torch.obs.trace import PID_REQUESTS, Tracer
from repro_torch.serving.engine import ServingConfig as TServing
from repro_torch.serving.engine import ServingEngine as TServe

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from check_trace import check_metrics, validate  # noqa: E402

N_REQUESTS = 14
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "metrics.prom")


def _golden_registry(registry_cls):
    """The registry of tests/test_obs.py's golden test."""
    m = registry_cls()
    m.counter("digest/refreshes").inc(5)
    m.counter("kernel/ivf_pq_probe/ref/calls").inc(2)
    m.counter("kernel/ivf_pq_probe/ref/modeled_bytes").inc(4096)
    m.gauge("engine/max_step_ladder").set(2)
    h = m.histogram("kernel/ivf_pq_probe/ref/wall_ms")
    for v in (0.0, 0.25, 1.0, 4.0, 4.0):
        h.observe(v)
    return m


def test_prometheus_export_matches_golden(tmp_path):
    out = tmp_path / "metrics.prom"
    text = export_prometheus(_golden_registry(MetricsRegistry),
                             path=str(out))
    with open(GOLDEN) as f:
        assert text == f.read()
    assert out.read_text() == text
    assert text == jax_export_prometheus(_golden_registry(JRegistry))


def _ring_trace(tracer_cls):
    tr = tracer_cls(max_steps=3)
    for s in range(10):
        tr.begin("step", args={"step": s})
        with tr.span("lookup"):
            pass
        tr.request_timeline(s, ts_ms=float(s), tier="edge",
                            terms=[("uplink", 1.0)], completion_ms=1.0)
        tr.end()
    return tr


def test_tracer_ring_keeps_last_n_steps(tmp_path):
    """The port's ``Tracer(max_steps=3)`` keeps the last three steps and
    their request timelines, as the reference's does; unbounded by
    default."""
    tr = _ring_trace(Tracer)
    steps = [e for e in tr.events
             if e.get("ph") == "B" and e["name"] == "step"]
    assert [e["args"]["step"] for e in steps] == [7, 8, 9]
    path = tmp_path / "ring.json"
    tr.export(str(path))
    stats = validate(json.loads(path.read_text()))
    assert stats["spans"]["step"] == 3 and stats["requests"] == 3
    jpath = tmp_path / "ring_jax.json"
    _ring_trace(JTracer).export(str(jpath))
    assert stats == validate(json.loads(jpath.read_text()))
    tr_all = Tracer()
    for _ in range(10):
        with tr_all.span("step"):
            pass
    assert sum(1 for e in tr_all.events
               if e.get("ph") == "B" and e["name"] == "step") == 10


@pytest.fixture(scope="module")
def obs_twin():
    jcfg = dataclasses.replace(get_config("coic-paper"), dtype="float32",
                               vocab_size=32)
    tcfg = dataclasses.replace(torch_get_config("coic-paper"),
                               dtype="float32", vocab_size=32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = torch_build(tcfg, device="cpu")
    params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tm)
    return jm, jp, tm


def _drive(make, tracer, metrics):
    """tests/test_obs.py's seeded run: federated CoIC front (2 clusters x 2
    nodes, sketch descriptors), paged KV with prefix sharing and chunked
    prefill, EDF with frame budgets, ``step_ms`` 2.0."""
    kw = dict(max_batch=4, max_len=96, max_new_tokens=4, kv_page=16,
              prefill_chunk=32, prefix_share=True, step_ms=2.0,
              queue_policy="edf")
    coic = dict(capacity=32, threshold=0.98, descriptor="sketch",
                descriptor_dim=64, num_nodes=2, num_clusters=2,
                digest_size=16, digest_interval=4)
    eng = make(kw, coic, tracer, metrics)
    wl = SharedPrefixWorkload(num_sessions=4, prefix_len=64, suffix_min=4,
                              suffix_max=16, vocab_size=32, seed=0)
    for i, (sess, prompt) in enumerate(wl.stream(N_REQUESTS, seed=1)):
        eng.submit(prompt, node_id=i % 2, cluster_id=sess % 2,
                   deadline_ms=40.0 if i % 3 else None)
        eng.step()
    while eng.pending or eng.queue or eng.chunking or eng.active:
        eng.step()
    return eng


@pytest.fixture(scope="module")
def obs_runs(obs_twin):
    """The traced run through both engines: (engine, tracer, registry)
    for the reference, then for the port."""
    jm, jp, tm = obs_twin

    def jax_engine(kw, coic, tracer, metrics):
        return JServe(jm, jp, JServing(coic=JCoIC(**coic), **kw),
                      tracer=tracer, metrics=metrics)

    def torch_engine(kw, coic, tracer, metrics):
        return TServe(tm, TServing(coic=TCoIC(**coic), **kw), device="cpu",
                      tracer=tracer, metrics=metrics)

    out = []
    for make, tracer_cls, registry_cls in (
            (jax_engine, JTracer, JRegistry),
            (torch_engine, Tracer, MetricsRegistry)):
        tracer, metrics = tracer_cls(), registry_cls()
        out.append((_drive(make, tracer, metrics), tracer, metrics))
    return out


def _export(tracer, path):
    tracer.export(str(path))
    return json.loads(path.read_text())


# the port's launch phases: spans the reference does not emit
PHASES = ("pack", "forward", "sample")


def test_engine_trace_validates_and_matches_jax(obs_runs, tmp_path):
    """Both traces pass ``validate`` with the same span counts and request
    count on every span name of the reference's, and the port's only other
    spans are the launch phases, one of each per paged ``decode`` and
    ``prefill_chunk`` launch; each request's modeled span (and the sum of
    its term spans) is its ``completion_ms``, and the port's tiers and
    terms equal the reference's."""
    (je, jtr, _), (te, ttr, _) = obs_runs
    jtrace = _export(jtr, tmp_path / "jax.json")
    ttrace = _export(ttr, tmp_path / "torch.json")
    stats, jstats = validate(ttrace), validate(jtrace)
    spans, jspans = stats["spans"], jstats["spans"]
    assert {k: spans.get(k) for k in jspans} == jspans
    launches = jspans["decode"] + jspans["prefill_chunk"]
    assert "prefill" not in jspans and not set(PHASES) & set(jspans)
    assert {k: v for k, v in spans.items() if k not in jspans} == \
        {k: launches for k in PHASES}
    assert stats["events"] == jstats["events"] + 2 * len(PHASES) * launches
    assert stats["requests"] == jstats["requests"] == N_REQUESTS
    for name in ("step", "schedule", "admit", "descriptor", "lookup"):
        assert stats["spans"].get(name, 0) > 0, name

    def timelines(trace):
        outer, terms = {}, {}
        for e in trace["traceEvents"]:
            if e.get("cat") == "request_model":
                outer[e["tid"]] = e
            elif e.get("cat") == "request_term":
                terms.setdefault(e["tid"], []).append(e)
        return outer, terms

    t_outer, t_terms = timelines(ttrace)
    j_outer, j_terms = timelines(jtrace)
    res = {r.req_id: r for r in te.results}
    assert set(t_outer) == set(res) == set(j_outer)
    for rid, r in res.items():
        e = t_outer[rid]
        assert e["pid"] == PID_REQUESTS
        assert e["args"]["tier"] == r.source == j_outer[rid]["args"]["tier"]
        assert abs(e["dur"] - r.completion_ms * 1e3) <= 1.0, rid
        assert abs(sum(t["dur"] for t in t_terms[rid])
                   - r.completion_ms * 1e3) <= 1.0, rid
        assert [t["name"] for t in t_terms[rid]] == \
            [t["name"] for t in j_terms[rid]], rid
        assert [t["dur"] for t in t_terms[rid]] == pytest.approx(
            [t["dur"] for t in j_terms[rid]], abs=1e-3), rid


# the port's pad-fill histograms: metrics the reference does not keep
FILLS = {f"engine/fill/{k}/{q}" for k in ("descriptor", "prefill", "decode")
         for q in ("tokens", "slots")}
# and its count of packed chunk launches
PACKED = "engine/prefill_chunk_packed"


def test_engine_registry_matches_jax(obs_runs):
    """The registry snapshots hold the same metric names but for the
    port's six pad-fill histograms and its packed-launch count (every
    chunk launch here); every counter and gauge (the dispatch bounds,
    hits, deadlines, KV and ladder counts) is equal, and
    ``check_metrics`` accepts the port's."""
    (_, _, jm), (_, _, tm) = obs_runs
    jsnap, tsnap = jm.snapshot(), tm.snapshot()
    check_metrics(tsnap)
    assert set(tsnap) - set(jsnap) == FILLS | {PACKED}
    assert tsnap[PACKED] == jsnap["engine/dispatches/prefill_chunk"] > 0
    assert set(jsnap) <= set(tsnap)
    for name, v in jsnap.items():
        if not isinstance(v, dict):           # histograms hold wall times
            assert tsnap[name] == v, name
    # one observation per launch, counted as the reference counts them
    n = {k: jsnap[f"engine/dispatches/{k}"]
         for k in ("descriptor", "prefill", "prefill_chunk", "decode")}
    launches = {"descriptor": n["descriptor"],
                "prefill": n["prefill"] + n["prefill_chunk"],
                "decode": n["decode"]}
    assert {name: tsnap[name]["count"] for name in FILLS} == \
        {name: launches[name.split("/")[2]] for name in FILLS}
    assert tsnap["engine/fill/prefill/tokens"]["sum"] == \
        jsnap["engine/prefill_tokens_computed"]


def test_ring_truncated_engine_trace_validates(obs_twin, tmp_path):
    """A port engine run traced through ``Tracer(max_steps=6)`` exports a
    trace that passes every structural check: eviction drops whole steps,
    never half a span or an orphaned term."""
    _, _, tm = obs_twin
    tracer = Tracer(max_steps=6)
    _drive(lambda kw, coic, tr, m: TServe(
        tm, TServing(coic=TCoIC(**coic), **kw), device="cpu", tracer=tr,
        metrics=m), tracer, MetricsRegistry())
    stats = validate(_export(tracer, tmp_path / "ring_engine.json"))
    assert 0 < stats["spans"]["step"] <= 6
    assert 0 < stats["requests"] <= N_REQUESTS
