"""The reader ``mla_decode_roofline`` on synthetic records and events: the
window's decode attention counted as the latent's bytes (``work.py``,
``refs/deepseek_v2.py``) over the device time of the absorbed decode
kernel's split and merge functions; None for an untraced run, for a trace
in which that kernel never ran (a program without it, a model without
MLA)."""
import numpy as np
import pytest

from perfbench.harness import Req, Window, read_metric

# 2 layers, the first dense; MLA r 32, dn 16, dr 8, dv 16 on 4 heads
SPEC = {"reference": "deepseek_v2", "num_layers": 2, "d_model": 8,
        "num_heads": 4, "d_ff": 12, "vocab_size": 16,
        "mla": {"kv_lora_rank": 32, "q_lora_rank": 0,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                "v_head_dim": 16},
        "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 6,
                "d_ff_shared": 6, "expert_layer_period": 1,
                "expert_layer_offset": 1, "first_dense_layers": 1}}
SPLIT = ("void (anonymous namespace)::latent_split_kernel<__nv_bfloat16>"
         "((anonymous namespace)::Params)")
MERGE = ("void (anonymous namespace)::latent_merge_kernel<__nv_bfloat16>"
         "((anonymous namespace)::Params)")


def _window(events, spec=SPEC):
    """Steps 1..10; one request of a 6-token prompt and 4 tokens, done at
    step 5: prefilled at step 3, it decodes positions 6, 7 and 8 (7, 8
    and 9 visible keys) at steps 3, 4 and 5."""
    req = Req(0, 0, 6, 0, finish_step=5, tokens=np.zeros(4, np.int32),
              source="cloud")
    return Window(s0=0, s1=10, reqs=[req], spec=spec, k_layers=1,
                  device_events=events)


def test_mla_decode_roofline_reads_the_latent_over_the_kernel():
    w = _window([(SPLIT, 0.0, 2e-9), ("void other_kernel(P)", 1.0, 2.0),
                 (MERGE, 3.0, 3.0 + 1e-9)])
    # 24 visible keys x 2 layers x (32 + 8) x 2 bytes of latent, and 3
    # queries x 2 layers of (4 x 24 + 4 x 16) x 2 bytes; bytes-bound
    least = (24 * 2 * 80 + 3 * 2 * 320) / 3.35e12
    assert read_metric("mla_decode_roofline", w) == pytest.approx(
        least / 3e-9 * 100)


def test_mla_decode_roofline_reads_none_without_its_kernel():
    # an untraced run
    assert read_metric("mla_decode_roofline", _window(None)) is None
    # the expanded decode: K5 and the elementwise kernels, no latent kernel
    k5 = [("void (anonymous namespace)::paged_split_kernel<float, 4>(P)",
           0.0, 1e-6), ("void at::elementwise_kernel<128>(P)", 1.0, 2.0)]
    assert read_metric("mla_decode_roofline", _window(k5)) is None
    # a model without MLA (granite's GQA decoder) runs none either
    dense = {"reference": "dense", "num_layers": 2, "d_model": 8,
             "num_heads": 4, "num_kv_heads": 1, "head_dim": 2, "d_ff": 12,
             "vocab_size": 16, "mlp_kind": "gelu", "qkv_bias": False}
    assert read_metric("mla_decode_roofline", _window(k5, dense)) is None
