"""The plain reference against ``repro_torch``'s model at a tiny size on
the CPU, in fp32, with the benchmark's weights loaded into both."""
import pytest
import torch

from perfbench import harness as H
from perfbench import reference as REF

TINY = {"arch": "granite-20b", "num_layers": 2, "d_model": 64,
        "num_heads": 4, "num_kv_heads": 1, "head_dim": 16, "d_ff": 96,
        "vocab_size": 200, "mlp_kind": "gelu", "sliding_window": 0,
        "tie_embeddings": False, "qkv_bias": False, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "dtype": "float32"}
CASES = {
    "gelu_mqa": {},
    "gated_gqa_window": {"arch": "h2o-danube-3-4b", "mlp_kind": "gated_silu",
                         "num_kv_heads": 2, "sliding_window": 8},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_logits_match_the_port(case):
    spec = {**TINY, **CASES[case]}
    model = H.build_model(spec, 2 ** 33 + 1, "cpu")
    toks = torch.randint(0, spec["vocab_size"], (1, 24),
                         generator=torch.Generator().manual_seed(0))
    want = model.forward(toks)[0]
    got = REF.logits(spec, 2 ** 33 + 1, toks[0], "cpu")
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), \
        (got - want).abs().max()


def test_served_gaps_zero_on_greedy_and_positive_on_other_tokens():
    spec = {**TINY, **CASES["gated_gqa_window"]}
    seed = 3
    prompt = torch.arange(5, 17)
    model = H.build_model(spec, seed, "cpu")
    seq = prompt.clone()
    for _ in range(6):                   # greedy continuation by the port
        nxt = model.forward(seq[None])[0, -1].argmax()
        seq = torch.cat([seq, nxt[None]])
    served = seq[len(prompt):]
    ref = REF.served_gaps(spec, seed, [prompt], [served], "cpu",
                          control=True)
    assert ref.gaps[0].shape == (6,) and float(ref.gaps[0].max()) < 1e-4
    assert ref.control_gaps[0].shape == (6,)
    assert float(ref.control_gaps[0].min()) >= 0.0
    wrong = (served + 1) % spec["vocab_size"]
    g2 = REF.served_gaps(spec, seed, [prompt], [wrong], "cpu").gaps
    assert float(g2[0].min()) > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_descriptor_matches_the_port(case):
    """The reference's descriptor (read in the served pass, served tokens
    after the prompt) equals the port's ``PrefixDescriptor`` on the
    prompt alone; the fp8 control's lies off it."""
    from repro_torch.core.descriptor import PrefixDescriptor

    spec = {**TINY, **CASES[case]}
    seed = 2 ** 33 + 7
    model = H.build_model(spec, seed, "cpu")
    prompt = torch.randint(0, spec["vocab_size"], (20,),
                           generator=torch.Generator().manual_seed(1))
    served = torch.randint(0, spec["vocab_size"], (5,),
                           generator=torch.Generator().manual_seed(2))
    want = PrefixDescriptor(model, k_layers=1)(prompt[None])[0]
    ref = REF.served_gaps(spec, seed, [prompt], [served], "cpu",
                          control=True, k_layers=1)
    assert torch.allclose(ref.desc[0], want, atol=1e-6), \
        (ref.desc[0] - want).abs().max()
    assert float((ref.control_desc[0] - ref.desc[0]).norm()) > 1e-3
