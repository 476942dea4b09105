"""DeepSeek-V2-Lite's configuration in the harness: its reference module
(``refs/deepseek_v2.py``: leaves, logits, work), the cell's declared
metrics, a tiny traced CPU run of the cell, and the two readers it adds
(``mla_expand_per_token``, ``moe_roofline``) against windows worked by
hand, built as ``test_perfbench_phase_metrics.py`` builds them."""
import importlib.util
import io

import numpy as np
import pytest
import torch

from perfbench import family as F
from perfbench import harness as H
from perfbench import reference as REF
from perfbench import work as WK
from perfbench.harness import ROOT, Req, Window, load_bench, metrics_of
from perfbench.harness import read_metric, run
from perfbench.tests.test_perfbench_family import MODEL
from perfbench.tests.test_perfbench_phase_metrics import PHASE_METRICS

CELL = "dsv2lite-unique-long"
# the family test's tiny MLA + MoE decoder (3 layers, the first dense; 8
# experts, top-2, 1 shared) as DeepSeek-V2-Lite's configuration states it:
# YaRN x40, no renormalisation, no capacity, its real reference module
DSV2 = {**MODEL, "reference": "deepseek_v2", "norm_eps": 1e-6,
        "yarn_factor": 40.0, "moe_norm_topk_prob": False,
        "moe_drop_free": True}


def _hist(table):
    return lambda name: table.get(name, (0, 0.0))


def _reader(name):
    """A metric's reader module (its helpers, besides ``read``)."""
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", ROOT / "perfbench" / "metrics"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# the reference module
# ----------------------------------------------------------------------
def test_deepseek_v2_module_builds_the_drop_free_yarn_decoder():
    """At a tiny size the program takes the drop-free grouped route, and
    the module's leaves fill every one of its parameters (the loader
    checks names and shapes)."""
    model = H.build_model(DSV2, 5, "cpu")
    assert model.moe_impl == "grouped"
    assert (model.cfg.yarn_factor, model.cfg.moe_norm_topk_prob,
            model.cfg.moe_drop_free, model.cfg.norm_eps) == (
        40.0, False, True, 1e-6)
    mod = F.of(DSV2)
    assert mod is F.module("deepseek_v2")
    n = sum(len(mod.leaf_shapes(DSV2, i)) for i in [-1, 0, 1, 2])
    assert n == len(list(model.parameters()))


def test_deepseek_v2_module_logits_are_the_programs(monkeypatch):
    """The module's fp32 pass (YaRN MLA expanded, the dense layer, the
    unrenormalised drop-free MoE) against the program's full forward on
    the same weights: equal to fp32 rounding (1e-5 on logits of about
    0.3; the program sums its products in other orders).  Each published
    switch shows, a hundred times the tolerance away: the program without
    YaRN, without its softmax factor (``mscale_all_dim`` 0), or with the
    renormalised router (3e-3, 3e-3 and 3e-2 at this size)."""
    from repro_torch.models import layers as L

    model = H.build_model(DSV2, 5, "cpu")
    tokens = torch.arange(3, 40) * 7 % 128
    want = REF.logits(DSV2, 5, tokens, "cpu")
    got = model(tokens[None])[0].float()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    for change in ({"yarn_factor": 1.0}, {"YARN_MSCALE_ALL_DIM": 0.0},
                   {"moe_norm_topk_prob": True}):
        with monkeypatch.context() as mp:
            spec = dict(DSV2)
            for key, val in change.items():
                if hasattr(L, key):
                    mp.setattr(L, key, val)
                else:
                    spec[key] = val
            other = H.build_model(spec, 5, "cpu")
            assert (other(tokens[None])[0] - want).abs().max() > 1e-3, \
                change


def test_deepseek_v2_module_work():
    """The module's counts are PERF.md section 4's rule (the stand-in's,
    worked by hand in ``test_work_sums_the_dense_and_the_moe_layers``),
    and its expert work: 6 D Fe k FLOPs a token; min(E, n k) experts'
    three matrices and each token in and out, bf16."""
    mod = F.module("deepseek_v2")
    dense, moe = 2 * (17056 + 18432), 2 * (17056 + 18944)
    assert [mod.layer_flops(DSV2, i) for i in range(3)] == [dense, moe, moe]
    assert mod.pair_flops(DSV2, 1) == 320
    assert (mod.query_bytes(DSV2, 1), mod.key_bytes(DSV2, 1)) == (320, 80)
    wk = WK.Work(DSV2, 1)
    wk.decode(10)
    assert wk.decode_attn_bytes == 3 * (11 * 80 + 320)
    assert mod.moe_flops(DSV2, 0, 5) == 0 and mod.moe_bytes(DSV2, 0, 5) == 0
    assert mod.moe_flops(DSV2, 1, 5) == 6 * 64 * 32 * 2 * 5
    # 5 tokens x 2 reach at most 8 experts; 3 tokens at most 6
    assert mod.moe_bytes(DSV2, 2, 5) == (8 * 3 * 64 * 32 + 5 * 2 * 64) * 2
    assert mod.moe_bytes(DSV2, 2, 3) == (6 * 3 * 64 * 32 + 3 * 2 * 64) * 2


# ----------------------------------------------------------------------
# the cell
# ----------------------------------------------------------------------
def test_dsv2_cell_declares_its_metrics():
    """The cell reports ``tok_s`` untraced, and traced the twelve readers
    it shares with granite's cell and its own two; the attention
    rooflines, which read K5/K7/K8, are granite's alone."""
    bench = load_bench()
    assert [m["name"] for m in metrics_of(bench, CELL, trace=False)] == [
        "setup_s", "tok_s"]
    traced = {m["name"] for m in metrics_of(bench, CELL, trace=True)}
    assert traced == {"step_ms.backlog", "ladder_ms", "decode_ms", "mfu",
                      "idle_share.backlog", *PHASE_METRICS, "moe_roofline",
                      "mla_expand_per_token"}
    assert "moe_roofline" not in {m["name"] for m in metrics_of(
        bench, "granite20b-unique", trace=True)}


def test_traced_cpu_run_of_the_dsv2_cell():
    """The cell's configuration at a tiny size, traced on the CPU: served
    as the reference computes it (fp32: gaps of 0 to rounding), and MLA's
    counter reaches its reader (the MoE roofline needs the card's
    trace)."""
    model = {k: v for k, v in DSV2.items() if k not in ("arch", "reference")}
    model["vocab_size"] = 512
    ov = {"model": model,
          "serving": {"max_batch": 4, "max_len": 128, "max_new_tokens": 4,
                      "prefill_chunk": 32, "kv_pages": 0},
          "traffic": {"len_lo": 8, "len_hi": 96, "waiting": 8,
                      "warm": {"ramp_steps": 4, "settle_steps": 4}},
          "check": {"requests": 3, "served_gap_max": 1e-3,
                    "descriptor_dist_max": 1e-3}}
    res, _ = run(CELL, 2 ** 31 + 17, 1.0, True, device="cpu", overrides=ov,
                 log=io.StringIO())
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert "moe_roofline" not in got
    # the padded chunk and the decode expand every row's whole view of
    # 128 keys for each latent row written
    assert 1.0 < got["mla_expand_per_token"] < 128 * 4


# ----------------------------------------------------------------------
# the readers
# ----------------------------------------------------------------------
def test_mla_expand_per_token():
    w = Window(hist=_hist({"engine/mla/expanded": (7, 5888.0),
                           "engine/mla/written": (7, 136.0)}))
    assert read_metric("mla_expand_per_token", w) == pytest.approx(
        5888 / 136)
    # a program without the counters, or a window without a launch
    assert read_metric("mla_expand_per_token", Window(hist=_hist({}))) \
        is None


def _moe_window(events):
    """Steps 11..20; a 2-layer model whose layer 1 is MoE (E 4, top-2, D 8,
    Fe 6), chunks of 4, a 1-layer descriptor.  Request a (prompt 6, 5
    tokens, finishing at step 13) chunked at 9 and 10 (its first token)
    and decodes at 10..13; b (prompt 9, 4 tokens, sent before step 12) is
    looked up at 12, chunks 4, 4, 1 at 14..16 and decodes at 16..18; c
    (prompt 3, 2 tokens) prefills and decodes at 20."""
    spec = {"reference": "deepseek_v2", "num_layers": 2, "d_model": 8,
            "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 6,
                    "expert_layer_period": 1, "expert_layer_offset": 1,
                    "first_dense_layers": 1}}

    def req(rid, S, n, finish, submit=0):
        return Req(rid, rid, S, submit, finish_step=finish,
                   tokens=np.zeros(n, np.int32), source="cloud")
    reqs = [req(0, 6, 5, 13), req(1, 9, 4, 18, submit=11),
            req(2, 3, 2, 20)]
    return Window(s0=10, s1=20, reqs=reqs, spec=spec, k_layers=1,
                  config={"serving": {"prefill_chunk": 4}},
                  device_events=events)


def test_moe_roofline_launches_and_least_time():
    reader = _reader("moe_roofline")
    w = _moe_window([])
    # in steps 11..20: b's descriptor (1 layer: no MoE layer in it); the
    # chunks of 4, 4, 1 (b) and 3 (c); decodes of one row at 11, 12, 13
    # (a), 16, 17, 18 (b) and 20 (c)
    assert sorted(reader.launches(w)) == sorted(
        [(1, 9), (2, 4), (2, 4), (2, 1), (2, 3)] + [(2, 1)] * 7)
    # layer 1 only, bytes-bound: min(4, 2n) experts of 3 x 8 x 6 and n
    # tokens in and out, bf16
    by_n = {n: (min(4, 2 * n) * 144 + 16 * n) * 2 for n in (1, 3, 4)}
    least = (2 * by_n[4] + by_n[3] + 8 * by_n[1]) / 3.35e12
    assert reader.least_s(w, F.module("deepseek_v2")) == pytest.approx(
        least)
    # the grouped GEMM's two kernels count, another kernel does not
    gemm, prep = reader.GROUPED
    w = _moe_window([(f"_ZN7cutlass13device_kernel{gemm}ILi1EE", 0.0, 2e-9),
                     ("void other_kernel(P)", 1.0, 2.0),
                     (f"void at::cuda::detail::{prep}<int>(P)", 3.0,
                      3.0 + 2e-9)])
    assert read_metric("moe_roofline", w) == pytest.approx(
        least / 4e-9 * 100)
    # no grouped kernel in the trace, an untraced run, or a module with
    # no expert counts: nothing to read
    assert read_metric("moe_roofline", _moe_window(
        [("void other_kernel(P)", 1.0, 2.0)])) is None
    assert read_metric("moe_roofline", _moe_window(None)) is None
    w.spec = {**w.spec, "reference": "dense"}
    assert read_metric("moe_roofline", w) is None
