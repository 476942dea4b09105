"""The readers of the engine's launch phases and pad fill against windows
worked by hand, built as ``test_perfbench_metrics.py`` builds them."""
import io
import math

import pytest

from perfbench import devtrace as DT
from perfbench.harness import (ROOT, Window, load_bench, metrics_of,
                               read_metric, run)
from perfbench.tests.test_perfbench_faults import OVERRIDES, TINY

PHASE_METRICS = ("decode_issue_ms", "decode_wait_ms", "prefill_chunk_ms",
                 "prefill_fill", "descriptor_fill", "decode_fill")


def _span(name, a, b, kids=()):
    """B/E events (seconds) of a span and its children."""
    ev = [{"pid": 1, "ph": "B", "name": name, "ts": a * 1e6}]
    for k in kids:
        ev += k
    return ev + [{"pid": 1, "ph": "E", "ts": b * 1e6}]


def _launch(name, a, pack, fwd, b):
    return _span(name, a, b, [_span("pack", a, pack),
                              _span("forward", pack, fwd),
                              _span("sample", fwd, b)])


def _spans():
    # step 1 [0, 10]: admit > prefill_chunk [0.5, 3] (forward 0.4 s),
    # decode [5, 9] (forward 2.9 s, sample 1 s); step 2 [10.5, 20]
    # past the window's end, with a longer decode and chunk
    ev = _span("step", 0.0, 10.0, [
        _span("admit", 0.5, 4.0, [_launch("prefill_chunk", 0.5, 0.6, 1.0,
                                          3.0)]),
        _launch("decode", 5.0, 5.1, 8.0, 9.0)])
    ev += _span("step", 10.5, 20.0, [
        _span("admit", 10.5, 14.0, [_launch("prefill_chunk", 10.5, 10.6,
                                            11.0, 14.0)]),
        _launch("decode", 15.0, 15.1, 19.0, 20.0)])
    return DT.SpanIndex(ev, 0.0)


def _hist(table):
    return lambda name: table.get(name, (0, 0.0))


FILLS = {"engine/fill/prefill/tokens": (3, 62.0),
         "engine/fill/prefill/slots": (3, 112.0),
         "engine/fill/descriptor/tokens": (1, 62.0),
         "engine/fill/descriptor/slots": (1, 256.0),
         "engine/fill/decode/tokens": (4, 6.0),
         "engine/fill/decode/slots": (4, 16.0)}


def test_phase_spans_in_the_window():
    w = Window(T0=0.0, T1=10.0, spans=_spans(), hist=_hist({}))
    # the forward under prefill_chunk (0.4 s) is not decode's
    assert read_metric("decode_issue_ms", w) == pytest.approx(2900.0)
    assert read_metric("decode_wait_ms", w) == pytest.approx(1000.0)
    assert read_metric("prefill_chunk_ms", w) == pytest.approx(2500.0)
    # the whole trace: step 2's spans count too
    w.T1 = 20.0
    assert read_metric("decode_issue_ms", w) == pytest.approx(3400.0)
    assert read_metric("decode_wait_ms", w) == pytest.approx(1000.0)
    assert read_metric("prefill_chunk_ms", w) == pytest.approx(3000.0)
    # a window that cuts every span reads nothing
    w.T0, w.T1 = 8.5, 10.0
    for name in PHASE_METRICS[:3]:
        assert read_metric(name, w) is None, name


def test_spans_without_phases_read_none():
    """A program whose launch spans hold no phases (the parent's) reads
    nothing for the decode phases, and an untraced run nothing at all."""
    ev = _span("step", 0.0, 10.0, [_span("decode", 5.0, 9.0)])
    w = Window(T0=0.0, T1=10.0, spans=DT.SpanIndex(ev, 0.0), hist=_hist({}))
    assert read_metric("decode_issue_ms", w) is None
    assert read_metric("decode_wait_ms", w) is None
    assert read_metric("prefill_chunk_ms", w) is None
    w.spans = None
    for name in PHASE_METRICS[:3]:
        assert read_metric(name, w) is None, name


def test_fill_shares():
    w = Window(T0=0.0, T1=10.0, spans=None, hist=_hist(FILLS))
    assert read_metric("prefill_fill", w) == pytest.approx(6200 / 112)
    assert read_metric("descriptor_fill", w) == pytest.approx(6200 / 256)
    assert read_metric("decode_fill", w) == pytest.approx(37.5)


@pytest.mark.parametrize("kind", ["prefill", "descriptor", "decode"])
def test_missing_fill_histogram_reads_none(kind):
    table = {k: v for k, v in FILLS.items() if f"/{kind}/" not in k}
    w = Window(T0=0.0, T1=10.0, spans=None, hist=_hist(table))
    assert read_metric(f"{kind}_fill", w) is None
    # a window with no launch of the kind reads nothing either
    table[f"engine/fill/{kind}/tokens"] = (0, 0.0)
    table[f"engine/fill/{kind}/slots"] = (0, 0.0)
    assert read_metric(f"{kind}_fill", w) is None


def test_phase_metrics_declared_for_the_cell():
    bench = load_bench()
    traced = {m["name"]: m for m in metrics_of(bench, "granite20b-unique",
                                               trace=True)}
    for name in PHASE_METRICS:
        assert traced[name]["moves"] == "tok_s", name
        assert (ROOT / "perfbench" / "metrics" / f"{name}.py").exists()
    assert not set(PHASE_METRICS) & {m["name"] for m in metrics_of(
        bench, "granite20b-unique", trace=False)}


def test_traced_cpu_run_reads_every_phase_metric():
    """The faults test's tiny backlog, traced on the CPU: the program's
    spans and histograms reach all six readers (times here are the CPU's,
    not the card's)."""
    ov = {**OVERRIDES["granite20b-unique"], "model": TINY,
          "check": {"requests": 3, "served_gap_max": 1e-3,
                    "descriptor_dist_max": 1e-3}}
    res, _ = run("granite20b-unique", 2 ** 31 + 17, 1.0, True,
                 device="cpu", overrides=ov, log=io.StringIO())
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(PHASE_METRICS) <= set(got)
    assert all(math.isfinite(got[k]) and got[k] > 0 for k in PHASE_METRICS)
    for k in ("prefill_fill", "descriptor_fill", "decode_fill"):
        assert got[k] <= 100.0, k
