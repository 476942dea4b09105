"""A DeepSeek-V2-shaped decoder served end to end against the benchmark's
plain reference (port only, CPU, fp32).

The model is DeepSeek-V2-Lite's configuration at a tiny size (3 layers,
the first dense; MLA with r 32, dn 16, dr 8, dv 16 and YaRN x40 from 4096
positions; 8 experts, top-2 unrenormalised, drop-free, 1 shared), with the
benchmark's weights (``perfbench/weights.py``), served by ``ServingEngine``
on the paged pool (MLA keeps the padded chunk: chunks of 8, decode) behind
a 2-layer prefix descriptor.  Every logit the engine's launches produce (a
prompt's last chunk, each decode step) is held to the logits of
``perfbench/refs/deepseek_v2.py`` over the whole served sequence at the
same position, within 1e-5: both fp32, the engine's chunks and cache sum
their products in other orders than one full pass (logits up to about
0.7; the gap reads about 2e-7, and the program without YaRN or with the
renormalised router reads 3e-3 or more, ``perfbench/tests``).

Drop-free routing makes a served request's tokens and its descriptor its
own: the same prompt served alone and among others gets the same tokens,
and its descriptor extracted alone and in a padded batch agrees within
1e-6 (padding only adds masked keys).
"""
import numpy as np
import pytest
import torch

from perfbench import harness as H
from perfbench import reference as REF
from repro_torch.core.coic import CoICConfig
from repro_torch.serving.engine import ServingConfig, ServingEngine

SPEC = {
    "arch": "deepseek-v2-lite-16b", "reference": "deepseek_v2",
    "num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "head_dim": 16, "d_ff": 96, "vocab_size": 128,
    "mlp_kind": "gated_silu", "sliding_window": 0, "tie_embeddings": False,
    "qkv_bias": False, "norm_eps": 1e-6, "rope_theta": 10000.0,
    "dtype": "float32", "yarn_factor": 40.0, "moe_norm_topk_prob": False,
    "moe_drop_free": True,
    "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16},
    "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
            "num_shared_experts": 1, "d_ff_shared": 32,
            "expert_layer_period": 1, "expert_layer_offset": 1,
            "first_dense_layers": 1, "router_aux_loss_coef": 0.001},
}
SEED = 2 ** 31 + 5
LENS = (5, 13, 22, 30)


@pytest.fixture(scope="module")
def model():
    m = H.build_model(SPEC, SEED, "cpu")
    assert m.moe_impl == "grouped"
    return m


def _engine(model, max_batch=4):
    cfg = ServingConfig(max_batch=max_batch, max_len=40, max_new_tokens=5,
                        prefill_chunk=8, kv_page=8, attn_impl="paged",
                        coic=CoICConfig(capacity=16, threshold=0.999,
                                        descriptor="prefix", k_layers=2))
    return ServingEngine(model, cfg, device="cpu")


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SPEC["vocab_size"], n).astype(np.int32)
            for n in lens]


def _recording(eng):
    """Wrap the engine's model calls: {rid: {position: logits}} of every
    logit row that belongs to a request."""
    got = {}
    model = eng.model
    chunk, decode = model.prefill_chunk, model.decode_step

    def prefill_chunk(tokens, cache, lengths, widths, **kw):
        sts = sorted(eng.chunking.values(),
                     key=lambda st: eng._queue_key((st.req_id,)))
        out = chunk(tokens, cache, lengths, widths, **kw)
        for i, st in enumerate(sts):
            if st.filled + int(widths[i]) == len(st.prompt):
                got.setdefault(st.req_id, {})[len(st.prompt) - 1] = \
                    out[0][i].clone()
        return out

    def decode_step(cache, tokens, lengths, **kw):
        rows = {slot: (a.req_id, int(lengths[slot]))
                for slot, a in eng.active.items()}
        out = decode(cache, tokens, lengths, **kw)
        for slot, (rid, pos) in rows.items():
            got.setdefault(rid, {})[pos] = out[0][slot].clone()
        return out

    model.prefill_chunk, model.decode_step = prefill_chunk, decode_step
    return got


def test_served_logits_match_the_reference(model):
    eng = _engine(model)
    got = _recording(eng)
    try:
        prompts = _prompts()
        rids = [eng.submit(p) for p in prompts]
        eng.run_until_drained()
    finally:
        del model.prefill_chunk, model.decode_step
    res = {r.req_id: r for r in eng.results}
    assert [res[r].source for r in rids] == ["cloud"] * len(LENS)
    for rid, p in zip(rids, prompts):
        seq = np.concatenate([p, res[rid].tokens[:-1]])
        want = REF.logits(SPEC, SEED, torch.as_tensor(seq), "cpu")
        positions = sorted(got[rid])
        # the last prompt token and each decoded one
        assert positions == list(range(len(p) - 1, len(seq)))
        for pos in positions:
            torch.testing.assert_close(got[rid][pos].float(), want[pos],
                                       atol=1e-5, rtol=1e-5)


def test_served_tokens_and_descriptor_do_not_depend_on_the_batch(model):
    """The 22-token prompt served alone and beside three others; its
    descriptor alone and in the padded batch of four."""
    prompts = _prompts()
    alone = _engine(model)
    alone.submit(prompts[2])
    alone.run_until_drained()
    together = _engine(model)
    rids = [together.submit(p) for p in prompts]
    together.run_until_drained()
    toks = {r.req_id: r.tokens.tolist() for r in together.results}
    assert toks[rids[2]] == alone.results[0].tokens.tolist()
    d_alone, _ = alone._extract_descriptors([prompts[2]])
    d_batch, _ = alone._extract_descriptors(prompts)
    np.testing.assert_allclose(d_batch[2], d_alone[0], atol=1e-6)
