"""The seam by which a configuration of another family comes in as files
alone: a configuration file that names its reference module
(``model.reference``) and the module, ``refs/<name>.py``, both on a
temporary root.  The model is a tiny MLA + MoE decoder of the port (3
layers, the first dense; 8 experts, top-2, 1 shared; r 32, dn 16, dr 8,
dv 16), and the module a stand-in that gives its leaves and its counts
and records the layers it is handed."""
import json
import textwrap

import pytest
import torch

from perfbench import family as F
from perfbench import harness as H
from perfbench import reference as REF
from perfbench import weights as W
from perfbench import work as WK

MODEL = {
    "arch": "deepseek-v2-lite-16b", "reference": "tiny_mla_moe",
    "num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "head_dim": 16, "d_ff": 96, "vocab_size": 128,
    "mlp_kind": "gated_silu", "sliding_window": 0, "tie_embeddings": False,
    "qkv_bias": False, "norm_eps": 1e-6, "rope_theta": 10000.0,
    "dtype": "float32",
    "mla": {"kv_lora_rank": 32, "q_lora_rank": 0, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16},
    "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
            "num_shared_experts": 1, "d_ff_shared": 32,
            "expert_layer_period": 1, "expert_layer_offset": 1,
            "first_dense_layers": 1, "router_aux_loss_coef": 0.001},
}
TRAFFIC = {"arrivals": "backlog", "waiting": 4, "pool": 0, "len_lo": 8,
           "len_hi": 16, "shared_prefix": 0,
           "warm": {"ramp_steps": 2, "settle_steps": 2}, "max_per_step": 4}

# the stand-in module: the program's leaf names, the counting rule of an
# MLA layer (PERF.md), and a block that records what it was handed
MODULE = textwrap.dedent('''
    import torch

    IN_DIMS = {"wq": (0,), "w_dkv": (0,), "w_krope": (0,), "w_uk": (0,),
               "w_uv": (0,), "wo": (0, 1), "w_gate": (0,), "w_up": (0,),
               "w_down": (0,), "router": (0,), "we_gate": (1,),
               "we_up": (1,), "we_down": (1,), "shared_w_gate": (0,),
               "shared_w_up": (0,), "shared_w_down": (0,), "head": (0,)}
    CALLS = []


    def _moe(spec, i):
        m = spec["moe"]
        return i >= m["first_dense_layers"] and \\
            (i - m["expert_layer_offset"]) % m["expert_layer_period"] == 0


    def leaf_shapes(spec, i):
        D, H, V = spec["d_model"], spec["num_heads"], spec["vocab_size"]
        a, m = spec["mla"], spec["moe"]
        r, dn, dr, dv = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                         a["qk_rope_head_dim"], a["v_head_dim"])
        if i < 0:
            return [("embed", (V, D), "matrix", 1),
                    ("final_norm", (D,), "norm", 0),
                    ("head", (D, V), "matrix", D)]
        out = [("attn_norm", (D,), "norm", 0),
               ("wq", (D, H, dn + dr), "matrix", D),
               ("w_dkv", (D, r), "matrix", D),
               ("w_krope", (D, dr), "matrix", D),
               ("kv_norm", (r,), "norm", 0),
               ("w_uk", (r, H, dn), "matrix", r),
               ("w_uv", (r, H, dv), "matrix", r),
               ("wo", (H, dv, D), "matrix", H * dv),
               ("mlp_norm", (D,), "norm", 0)]
        if not _moe(spec, i):
            F = spec["d_ff"]
            return out + [("w_gate", (D, F), "matrix", D),
                          ("w_up", (D, F), "matrix", D),
                          ("w_down", (F, D), "matrix", F)]
        E, Fe, Fs = m["num_experts"], m["d_ff_expert"], m["d_ff_shared"]
        return out + [("router", (D, E), "matrix", D),
                      ("we_gate", (E, D, Fe), "matrix", D),
                      ("we_up", (E, D, Fe), "matrix", D),
                      ("we_down", (E, Fe, D), "matrix", Fe),
                      ("shared_w_gate", (D, Fs), "matrix", D),
                      ("shared_w_up", (D, Fs), "matrix", D),
                      ("shared_w_down", (Fs, D), "matrix", Fs)]


    def block(spec, w, x, low):
        CALLS.append((dict(w), low))
        return x


    def layer_flops(spec, i):
        """2 x the parameters a token uses: MLA's projections (the K/V
        up-projections once per token written), the norms, and the dense
        MLP or the router, top_k routed experts and the shared ones."""
        D, H = spec["d_model"], spec["num_heads"]
        a, m = spec["mla"], spec["moe"]
        r, dn, dr, dv = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                         a["qk_rope_head_dim"], a["v_head_dim"])
        p = (D * H * (dn + dr) + D * r + D * dr + r + r * H * dn
             + r * H * dv + H * dv * D + 2 * D)
        if _moe(spec, i):
            p += (D * m["num_experts"] + m["top_k"] * 3 * D * m["d_ff_expert"]
                  + 3 * D * m["d_ff_shared"])
        else:
            p += 3 * D * spec["d_ff"]
        return 2 * p


    def pair_flops(spec, i):
        a = spec["mla"]
        H = spec["num_heads"]
        return 2 * H * (a["qk_nope_head_dim"] + a["qk_rope_head_dim"]) \\
            + 2 * H * a["v_head_dim"]


    def query_bytes(spec, i):
        a = spec["mla"]
        H = spec["num_heads"]
        return (H * (a["qk_nope_head_dim"] + a["qk_rope_head_dim"])
                + H * a["v_head_dim"]) * 2


    def key_bytes(spec, i):
        a = spec["mla"]
        return (a["kv_lora_rank"] + a["qk_rope_head_dim"]) * 2
''')


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout's perfbench/ with the configuration, its traffic and its
    reference module; ``family.REFS`` pointed at it."""
    pb = tmp_path / "perfbench"
    for d in ("configs", "traffic", "refs"):
        (pb / d).mkdir(parents=True)
    (pb / "configs" / "tiny-mla-moe.json").write_text(json.dumps(
        {"name": "tiny-mla-moe", "model": MODEL}))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(TRAFFIC))
    (pb / "refs" / "tiny_mla_moe.py").write_text(MODULE)
    monkeypatch.setattr(F, "REFS", pb / "refs")
    return tmp_path


def _spec(root, **change):
    config, _ = H.load_cell("tiny-mla-moe", "tiny", root)
    return {**config["model"], **change}


def test_build_model_builds_the_ports_mla_moe_decoder(root):
    from repro_torch.configs import MLAConfig, MoEConfig
    from repro_torch.models.transformer import DecoderLM

    spec = _spec(root)
    model = H.build_model(spec, 2 ** 31 + 9, "cpu")
    assert isinstance(model, DecoderLM)
    assert model.cfg.mla == MLAConfig(**MODEL["mla"])
    assert model.cfg.moe == MoEConfig(**MODEL["moe"])
    assert [b.kind for b in model.layers] == ["mla"] * 3
    assert [b.mlp for b in model.layers] == ["dense", "moe", "moe"]
    # every leaf holds the benchmark's weights of its layer
    n = 0
    for i in [-1, 0, 1, 2]:
        owner = model if i < 0 else model.layers[i]
        for name, t in W.layer(spec, 2 ** 31 + 9, i, "cpu",
                               torch.float32).items():
            p = getattr(owner, {"embed": "embed_tokens"}.get(name, name))
            assert torch.equal(p, t), (i, name)
            n += 1
    assert n == len(list(model.parameters()))


def test_served_gaps_runs_the_modules_block_layer_by_layer(root):
    spec = _spec(root)
    mod = F.module("tiny_mla_moe")
    mod.CALLS.clear()
    seed = 2 ** 32 + 3
    REF.served_gaps(spec, seed, [torch.arange(3, 12)], [torch.arange(4)],
                    "cpu", control=True, k_layers=1)
    assert [low for _, low in mod.CALLS] == [False, True] * 3
    for i in range(3):
        want = W.layer(spec, seed, i, "cpu", torch.float32)
        (w, _), (w8, _) = mod.CALLS[2 * i:2 * i + 2]
        assert sorted(w) == sorted(want)
        assert all(torch.equal(w[n], want[n]) for n in want), i
        for n in want:         # the control's matrices in fp8, by IN_DIMS
            t = (REF.fp8(want[n], mod.IN_DIMS[n]) if n in mod.IN_DIMS
                 else want[n])
            assert torch.equal(w8[n], t), (i, n)
    assert "router" not in mod.CALLS[0][0] and "router" in mod.CALLS[2][0]


def test_work_sums_the_dense_and_the_moe_layers(root):
    spec = _spec(root)
    # a token: MLA 2 x (6144 + 2048 + 512 + 32 + 2048 + 2048 + 4096 + 128)
    # = 2 x 17056; layer 0's dense MLP 2 x 18432; an MoE layer's router,
    # 2 experts and the shared one 2 x (512 + 12288 + 6144)
    dense, moe = 2 * (17056 + 18432), 2 * (17056 + 18944)
    pair, qb, kb, head = 320, 320, 80, 2 * 64 * 128
    wk = WK.Work(spec, 1)
    wk.descriptor(10)                  # layer 0 alone, 55 pairs
    assert wk.model_flops == dense * 10 + pair * 55
    wk.prefill(10)
    assert wk.model_flops == (dense * 10 + pair * 55
                              + (dense + 2 * moe) * 10 + 3 * pair * 55 + head)
    assert wk.prefill_attn_bytes == 10 * (qb + kb) * (1 + 3)
    wk.decode(10)                      # 11 visible keys in each layer
    assert wk.decode_attn_flops == 3 * pair * 11
    assert wk.decode_attn_bytes == 3 * (11 * kb + qb)
    assert wk.tokens_generated == 2


@pytest.mark.parametrize("change, named", [
    ({"bogus_width": 3}, "bogus_width"),
    ({"mla": {k: v for k, v in MODEL["mla"].items()
              if k != "v_head_dim"}}, "v_head_dim"),
    ({"moe": {**MODEL["moe"], "capacity": 2}}, "capacity"),
    ({"reference": "no_such_family"}, "no_such_family"),
])
def test_what_the_harness_cannot_build_exits_naming_it(root, change, named):
    with pytest.raises(SystemExit, match=named):
        H.build_model(_spec(root, **change), 1, "cpu")
