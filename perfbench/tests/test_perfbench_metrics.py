"""The metric arithmetic against small cases worked by hand."""
import pytest

from perfbench import devtrace as DT
from perfbench import family as F
from perfbench import readers as R
from perfbench import work as WK
from perfbench.harness import Req, Window

DENSE = F.module("dense")
SPEC = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 10, "mlp_kind": "gelu",
        "sliding_window": 0}


def _req(rid, S, n, finish, submit=0, source="cloud"):
    import numpy as np
    return Req(rid, rid, S, submit, finish_step=finish,
               tokens=np.zeros(n, np.int32), source=source)


def test_layer_params_and_pairs():
    # attn 8*4*2 + 2*8*2*2 + 4*2*8 = 64+64+64; mlp 2*8*16+16+8; norms 16
    assert DENSE.layer_params(SPEC) == 192 + 280 + 16
    assert WK.keys_prefill(4, 0) == 10
    assert WK.keys_prefill(5, 2) == 3 + 3 * 2        # 1, 2, 2, 2, 2
    assert WK.keys_decode(9, 4) == 4 and WK.keys_decode(2, 0) == 3


def test_window_work_tokens_and_flops():
    # steps 11..20 are the window; a request of prompt 4 and 5 tokens
    # finishing at step 12 prefilled at step 9 (tokens at 9, 9, 10, 11,
    # 12): in the window its decodes at steps 11, 12 (positions 6, 7)
    r = _req(0, 4, 5, 12)
    assert r.first_step == 9
    # another prefilled at 15, finishing at 18 with 5 tokens: prefill and
    # decodes at 15, 16, 17, 18 (positions 4..7); submitted before step 14
    q = _req(1, 4, 5, 18, submit=13)
    w = Window(s0=10, s1=20, reqs=[r, q], spec=SPEC, k_layers=1, seconds=2.0)
    wk = R.window_work(w)
    assert wk.tokens_generated == 2 + 5
    P, L, pair, head = DENSE.layer_params(SPEC), 2, 4 * 4 * 2, 2 * 8 * 10
    flops = (2 * P * L * 4 + pair * 10 * L + head          # q's prefill
             + 6 * (2 * P * L + head)                      # 6 decodes
             + pair * L * (7 + 8 + 5 + 6 + 7 + 8)          # their keys
             + 2 * P * 1 * 4 + pair * 10 * 1)              # q's descriptor
    assert wk.model_flops == flops
    assert R.window_work(w).tokens_generated / w.seconds == 3.5
    assert R.mfu(w) == pytest.approx(flops / (2.0 * WK.PEAK_FLOPS) * 100)
    kv = 2 * 2 * 2 * 2
    assert wk.decode_attn_bytes == L * ((7 + 8 + 5 + 6 + 7 + 8) * kv
                                        + 6 * 2 * 4 * 2 * 2)
    assert wk.least_decode_attn_s() == max(wk.decode_attn_flops
                                           / WK.PEAK_FLOPS,
                                           wk.decode_attn_bytes
                                           / WK.PEAK_BYTES)
    assert wk.prefill_attn_flops == pair * 10 * (L + 1)


def test_hits_cost_a_descriptor_only():
    h = _req(0, 6, 5, 12, submit=11, source="edge")
    w = Window(s0=10, s1=20, reqs=[h], spec=SPEC, k_layers=2, seconds=1.0)
    wk = R.window_work(w)
    assert wk.tokens_generated == 0
    assert wk.model_flops == 2 * DENSE.layer_params(SPEC) * 2 * 6 \
        + 4 * 4 * 2 * 21 * 2


def test_step_ms():
    w = Window(s0=2, s1=5, step_end=[0.0, 0.1, 0.2, 0.35, 0.5, 0.6])
    # steps 3, 4, 5 returned at 0.2, 0.35, 0.5; step 2 at 0.1
    assert R.step_ms(w) == pytest.approx((0.5 - 0.1) / 3 * 1e3)


def test_union_clip_idle_and_kernel_time_by_span():
    ev = [("void ns::paged_mma_kernel<1>(P)", 1.0, 2.0),
          ("flash_mma_kernel(x)", 1.5, 3.0),
          ("void ns::paged_mma_kernel<1>(P)", 6.0, 7.0),
          ("gemm", 8.0, 12.0)]
    cl = DT.clip(ev, 0.0, 10.0)
    assert DT.union(cl) == [(1.0, 3.0), (6.0, 7.0), (8.0, 10.0)]
    # engine spans: step [0, 10] > admit [0.5, 4] > prefill_chunk [0.5, 1.2];
    # decode [5, 9]
    tr = [{"pid": 1, "ph": "B", "name": "step", "ts": 0.0},
          {"pid": 1, "ph": "B", "name": "admit", "ts": 0.5e6},
          {"pid": 1, "ph": "B", "name": "prefill_chunk", "ts": 0.5e6},
          {"pid": 1, "ph": "E", "ts": 1.2e6},
          {"pid": 1, "ph": "E", "ts": 4e6},
          {"pid": 1, "ph": "B", "name": "decode", "ts": 5e6},
          {"pid": 1, "ph": "E", "ts": 9e6},
          {"pid": 1, "ph": "E", "ts": 10e6}]
    sp = DT.SpanIndex(tr, 0.0)
    assert sp.at(1.1) == "step/admit/prefill_chunk"
    assert sp.at(2.0) == "step/admit" and sp.at(4.5) == "step"
    assert sp.at(11.0) is None
    assert ("step/admit/prefill_chunk", 0.5, 1.2) in sp.closed
    w = Window(device_events=cl, spans=sp, seconds=10.0)
    k5 = ("paged_mma_kernel",)
    assert R.kernel_seconds(w, ("flash_mma_kernel",), ("admit",), k5) == 2.5
    assert R.kernel_seconds(w, (), ("decode",), k5) == 1.0
    assert R.idle_share(w) == pytest.approx(100 * (1 - 5.0 / 10.0))
    bd = DT.breakdown(cl, sp, 0.0, 10.0)
    assert bd["device_ops"][0] == ["paged_mma_kernel", 2.0]
    assert dict(map(tuple, bd["idle_gaps"])) == pytest.approx(
        {"step/admit/prefill_chunk": 1.0, "step": 3.0, "step/decode": 1.0})


def test_base_name():
    assert DT.base_name("void (anonymous namespace)::paged_mma_kernel"
                        "<128, 48>(Params)") == "paged_mma_kernel"
    assert DT.base_name("flash_mma_kernel(bf16 const*)") == "flash_mma_kernel"
    assert DT.base_name("sm90_xmma_gemm_bf16") == "sm90_xmma_gemm_bf16"
