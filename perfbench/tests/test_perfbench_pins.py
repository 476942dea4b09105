"""granite's numbers pinned: the benchmark's weights, the reference's
logits, served gaps and descriptors, and the yardstick's work totals, as
the harness gave them before each configuration named its reference
module by file (``family.py``).  The weights and the reference's outputs
are held by three float64 sums (of |x|, of x^2, and of |x| weighted by
position), which a reordered, rescaled or dropped leaf or step moves;
the work totals are exact."""
import numpy as np
import pytest
import torch

from perfbench import harness as H
from perfbench import readers as R
from perfbench import reference as REF
from perfbench import weights as W
from perfbench import work as WK

TINY = {"arch": "granite-20b", "num_layers": 2, "d_model": 64,
        "num_heads": 4, "num_kv_heads": 1, "head_dim": 16, "d_ff": 96,
        "vocab_size": 200, "mlp_kind": "gelu", "sliding_window": 0,
        "tie_embeddings": False, "qkv_bias": False, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "dtype": "bfloat16"}
MLP_KINDS = {"gelu": {}, "gated_silu": {"mlp_kind": "gated_silu",
                                        "num_kv_heads": 2}}
REF_CASES = {"gelu_mqa": {},
             "gated_gqa_window": {"mlp_kind": "gated_silu",
                                  "num_kv_heads": 2, "sliding_window": 8}}


def _sums(t: torch.Tensor) -> list:
    x = t.detach().double().flatten()
    pos = torch.arange(1, x.numel() + 1, dtype=torch.float64) % 977 + 1
    return [float(x.abs().sum()), float(x.square().sum()),
            float((x.abs() * pos).sum())]


def _granite(vocab=None) -> dict:
    _, config, _ = H.cell_files(H.load_bench(), "granite20b-unique")
    spec = dict(config["model"])
    if vocab is not None:
        spec["vocab_size"] = vocab
    return spec


def weight_sums() -> dict:
    out = {}
    for kind, extra in MLP_KINDS.items():
        spec = {**TINY, **extra}
        for i in (-1, 0, 1):
            for n, t in W.layer(spec, 2 ** 33 + 5, i, "cpu",
                                torch.float32).items():
                out[f"{kind}.{i}.{n}"] = _sums(t)
    for n, t in W.layer(_granite(512), 2 ** 31 + 3, -1, "cpu",
                        torch.float32).items():
        out[f"granite.top.{n}"] = _sums(t)
    return out


def reference_sums() -> dict:
    out = {}
    for case, extra in REF_CASES.items():
        spec = {**TINY, "dtype": "float32", **extra}
        toks = torch.randint(0, 200, (24,),
                             generator=torch.Generator().manual_seed(0))
        out[f"{case}.logits"] = _sums(REF.logits(spec, 2 ** 33 + 1, toks,
                                                 "cpu"))
        prompt = torch.arange(5, 17)
        served = torch.randint(0, 200, (6,),
                               generator=torch.Generator().manual_seed(2))
        p = REF.served_gaps(spec, 3, [prompt, prompt[:7]],
                            [served, served[:3]], "cpu", control=True,
                            k_layers=1)
        for name in p._fields:
            out[f"{case}.{name}"] = _sums(torch.cat(
                [x.flatten() for x in getattr(p, name)]))
    return out


def _req(rid, S, n, finish, submit):
    return H.Req(rid, rid, S, submit, finish_step=finish,
                 tokens=np.zeros(n, np.int32), source="cloud")


def work_totals() -> dict:
    spec = _granite()
    wk = WK.Work(spec, 2)
    for S in (128, 517, 1024):
        wk.descriptor(S)
        wk.prefill(S)
    for pos in (128, 300, 1055):
        wk.decode(pos)
    # a window of steps 11..40: prefills, decodes and descriptors of
    # requests begun before, inside and across it
    reqs = [_req(0, 1024, 33, 14, 0), _req(1, 128, 33, 45, 12),
            _req(2, 517, 20, 30, 11), _req(3, 900, 33, 60, 35)]
    ww = R.window_work(H.Window(s0=10, s1=40, reqs=reqs, spec=spec,
                                k_layers=2, seconds=1.0))
    return {name: [w.model_flops, w.prefill_attn_flops,
                   w.prefill_attn_bytes, w.decode_attn_flops,
                   w.decode_attn_bytes, w.tokens_generated,
                   w.least_prefill_attn_s(), w.least_decode_attn_s()]
            for name, w in (("work", wk), ("window_work", ww))}


# the sums and totals above, taken on the tree before ``family.py``
PINNED_WEIGHTS = {
    "gelu.-1.embed": [206.128942174837, 5.21635960864613, 100266.1241021771],
    "gelu.-1.final_norm": [63.98046875, 63.98774719238281, 2146.0703125],
    "gelu.-1.head": [203.8986968100071, 5.1271831339832135, 98430.10974520445],
    "gelu.0.attn_norm": [63.8046875, 63.63433837890625, 2137.6171875],
    "gelu.0.wq": [65.60170841217041, 1.6278609121040972, 30982.266983032227],
    "gelu.0.wk": [16.265862703323364, 0.4010715453578655, 7637.486341953278],
    "gelu.0.wv": [16.4918349981308, 0.4143362581465482, 7717.489597439766],
    "gelu.0.wo": [65.78135940432549, 1.6555979339573925, 31343.067693918943],
    "gelu.0.mlp_norm": [64.27734375, 64.57801818847656, 2152.27734375],
    "gelu.0.w_in": [97.10637003183365, 2.432697282756859, 45892.76106643677],
    "gelu.0.b_in": [
        1.7042790651321411, 0.049639663014673374, 82.5394195318222
    ],
    "gelu.0.w_out": [96.58189916610718, 2.390291855217477, 45895.045487225056],
    "gelu.0.b_out": [
        1.0455865859985352, 0.027325857762662054, 35.78638172149658
    ],
    "gelu.1.attn_norm": [63.84375, 63.714508056640625, 2143.00390625],
    "gelu.1.wq": [64.97098609805107, 1.6173507369199926, 30918.632555395365],
    "gelu.1.wk": [16.748605728149414, 0.43673671683791326, 7709.416278839111],
    "gelu.1.wv": [16.23869037628174, 0.4025824986547377, 7646.298135280609],
    "gelu.1.wo": [65.62289878726006, 1.6746274124114686, 30863.51435315609],
    "gelu.1.mlp_norm": [63.80859375, 63.64036560058594, 2136.7578125],
    "gelu.1.w_in": [98.44731517136097, 2.467907563241406, 46718.8696231544],
    "gelu.1.b_in": [1.3720703125, 0.03058145649265498, 70.78133392333984],
    "gelu.1.w_out": [96.96130202710629, 2.4023670243545006, 45718.1956294924],
    "gelu.1.b_out": [
        1.0662376880645752, 0.02726364457140562, 34.911882162094116
    ],
    "gated_silu.-1.embed": [
        206.128942174837, 5.21635960864613, 100266.1241021771
    ],
    "gated_silu.-1.final_norm": [63.98046875, 63.98774719238281, 2146.0703125],
    "gated_silu.-1.head": [
        203.8986968100071, 5.1271831339832135, 98430.10974520445
    ],
    "gated_silu.0.attn_norm": [63.8046875, 63.63433837890625, 2137.6171875],
    "gated_silu.0.wq": [
        65.60170841217041, 1.6278609121040972, 30982.266983032227
    ],
    "gated_silu.0.wk": [
        32.75769770145416, 0.8154078035044137, 15253.134950876236
    ],
    "gated_silu.0.wv": [
        32.84537374973297, 0.8170585612962356, 15684.274071455002
    ],
    "gated_silu.0.wo": [
        65.12233027815819, 1.6503266266470833, 30714.84948912263
    ],
    "gated_silu.0.mlp_norm": [64.265625, 64.56063842773438, 2152.15234375],
    "gated_silu.0.w_gate": [
        97.52503281831741, 2.4284095984426948, 45980.05387687683
    ],
    "gated_silu.0.w_up": [
        96.16433574259281, 2.3886607028482665, 45506.60993818939
    ],
    "gated_silu.0.w_down": [
        98.9513372182846, 2.489482545893779, 46982.27555769682
    ],
    "gated_silu.1.attn_norm": [63.84375, 63.714508056640625, 2143.00390625],
    "gated_silu.1.wq": [
        64.97098609805107, 1.6173507369199926, 30918.632555395365
    ],
    "gated_silu.1.wk": [
        32.98729610443115, 0.839319215492651, 15395.418266773224
    ],
    "gated_silu.1.wv": [
        32.53636333346367, 0.8242813180894197, 15174.91673219204
    ],
    "gated_silu.1.wo": [
        65.10770101845264, 1.6362671699333637, 30801.128380715847
    ],
    "gated_silu.1.mlp_norm": [63.9375, 63.895233154296875, 2138.0234375],
    "gated_silu.1.w_gate": [
        98.42970597743988, 2.4626854793195676, 46777.18417596817
    ],
    "gated_silu.1.w_up": [
        97.86672052741051, 2.4554418468509422, 46186.76826955378
    ],
    "gated_silu.1.w_down": [
        98.77667419612408, 2.493265670096653, 47071.62035034597
    ],
    "granite.top.embed": [
        50188.85550456698, 1258.0397697396884, 24553418.21279982
    ],
    "granite.top.final_norm": [
        6143.9140625, 6146.318115234375, 2906959.19921875
    ],
    "granite.top.head": [
        32001.525151564507, 511.16162388504944, 15653299.697693191
    ],
}
PINNED_REFERENCE = {
    "gelu_mqa.logits": [
        646.0676780435697, 134.9938637217274, 311844.14944987494
    ],
    "gelu_mqa.gaps": [
        4.586540102958679, 2.5405327081031768, 27.49826815724373
    ],
    "gelu_mqa.control_gaps": [0.0, 0.0, 0.0],
    "gelu_mqa.desc": [
        12.660701060631254, 1.9999999662498849, 783.619435423796
    ],
    "gelu_mqa.control_desc": [
        12.661069001886062, 2.0000000175792048, 783.8948852033354
    ],
    "gated_gqa_window.logits": [
        619.6358420157817, 125.14886930770926, 298502.60413085134
    ],
    "gated_gqa_window.gaps": [
        4.0343771278858185, 2.3166811844971553, 22.565041035413742
    ],
    "gated_gqa_window.control_gaps": [
        0.017065107822418213, 0.00023196176597117812, 0.06296539306640625
    ],
    "gated_gqa_window.desc": [
        12.948633522493765, 1.9999999674117528, 817.6369954575785
    ],
    "gated_gqa_window.control_desc": [
        12.995653009973466, 1.999999942864561, 820.5100032845512
    ],
}
PINNED_WORK = {
    "work": [
        69343042854912.0, 885123956736.0, 2261081088.0, 1899036672.0,
        43397120.0, 6, 0.0008949686114620829, 1.2954364179104477e-05
    ],
    "window_work": [
        66504603475968.0, 726734094336.0, 2093091840.0, 36987764736.0,
        849811456.0, 65, 0.0007348170822406471, 0.0002536750614925373
    ],
}


def _close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], **tol), k


def test_weights_pinned():
    _close(weight_sums(), PINNED_WEIGHTS, rel=1e-6)


def test_reference_pinned():
    _close(reference_sums(), PINNED_REFERENCE, rel=1e-5, abs=1e-6)


def test_work_totals_pinned():
    assert work_totals() == PINNED_WORK
