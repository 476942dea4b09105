"""The packed paged chunk (port only): ``DecoderLM.prefill_chunk`` given a
``PackedChunk`` runs the chunk tokens of every mid-prefill row as one (1,
T) sequence of their summed widths, where the padded launch pads them to
(pow2 rows, chunk width).  Held against the padded launch of the same
rows: each row's last-token logits, and the page pool (what was written,
and what was left).  The engine takes the packed launch for a model of per-token
layers and serves the same tokens; an MLA model and a dropless MoE keep
the padded launch.

CPU cases in fp32 with K5's plain version (``ref``) and the gathered
read; one ``gpu`` case at granite-20b's head shapes in bf16 through K5 on
the card (``python -m pytest -q --noconftest -m gpu
tests/test_torch_packed_chunk.py``).  No JAX here: the card's machine has
none.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.transformer import pack_chunks
from repro_torch.serving.engine import ServingConfig, ServingEngine

INVALID = 2 ** 30
PAGE, N_PAGES, CHUNK = 4, 4, 8        # max_len 16, chunks of 8
# row r maps pages 4r..4r+3; row 3's first two pages hold a shared prefix
TABLE = np.arange(4 * N_PAGES, dtype=np.int32).reshape(4, N_PAGES)

# launches of (row, filled, width): ragged rows, a row starting past a
# shared prefix, a 1-token row, equal widths (the view is the sequence),
# a row's second chunk
CASES = {
    "ragged": [[(0, 0, 7), (1, 0, 3), (2, 0, 5)]],
    "past_prefix": [[(0, 0, 6), (3, 8, 5)]],
    "one_token": [[(1, 0, 1), (2, 0, 8), (3, 8, 2)]],
    "equal": [[(0, 0, 8), (1, 0, 8)]],
    "second_chunk": [[(0, 0, 8), (2, 0, 4)], [(0, 8, 5), (2, 4, 8)]],
}

MODELS = {
    "coic-paper": lambda: get_config("coic-paper"),
    "granite-20b": lambda: reduced_config(get_config("granite-20b")),
    "granite-moe-dense": lambda: reduced_config(
        get_config("granite-moe-3b-a800m")),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    cfg = dataclasses.replace(MODELS[request.param](), dtype="float32")
    return build_model(cfg, device="cpu", attention_impl="ref",
                       moe_impl="dense",
                       generator=torch.Generator().manual_seed(0))


def _pool(model, seed=1):
    """A pool of random values: a write and a page left alone both show."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g).to(d)
            for k, (s, d) in model.paged_cache_specs(
                4 * N_PAGES, PAGE).items()}


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return rng.integers(0, vocab, (4, PAGE * N_PAGES)).astype(np.int32)


def _padded(model, pool, prompts, launch, attn_impl):
    """The launch as the engine padded it: (pow2 rows, CHUNK), pad rows of
    width 0 and an all-INVALID table."""
    Bb = 1 << (len(launch) - 1).bit_length()
    toks = np.zeros((Bb, CHUNK), np.int32)
    lens = np.zeros(Bb, np.int32)
    widths = np.zeros(Bb, np.int32)
    bt = np.full((Bb, N_PAGES), INVALID, np.int32)
    for i, (r, f, w) in enumerate(launch):
        toks[i, :w] = prompts[r, f:f + w]
        lens[i], widths[i], bt[i] = f, w, TABLE[r]
    logits, _, _ = model.prefill_chunk(
        torch.from_numpy(toks), pool, torch.from_numpy(lens),
        torch.from_numpy(widths), block_table=torch.from_numpy(bt),
        attn_impl=attn_impl)
    return logits[:len(launch)]


def _packed(model, pool, prompts, launch, attn_impl):
    pack = pack_chunks([prompts[r, f:f + w] for r, f, w in launch],
                       [f for _, f, _ in launch],
                       TABLE[[r for r, _, _ in launch]], PAGE, "cpu")
    logits, _, lengths = model.prefill_chunk(pack, pool, attn_impl=attn_impl)
    assert lengths.tolist() == [f + w for _, f, w in launch]
    return logits


def _written(launches):
    """(page, offset) of every token the launches write."""
    return {(int(TABLE[r, p // PAGE]), p % PAGE)
            for launch in launches for r, f, w in launch
            for p in range(f, f + w)}


@pytest.mark.parametrize("attn_impl", ["ref", "gather"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_chunk_matches_padded(model, case, attn_impl):
    prompts = _prompts(model.cfg.vocab_size)
    start = _pool(model)
    pools = {k: {n: t.clone() for n, t in start.items()}
             for k in ("padded", "packed")}
    for launch in CASES[case]:
        want = _padded(model, pools["padded"], prompts, launch, attn_impl)
        got = _packed(model, pools["packed"], prompts, launch, attn_impl)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    written = _written(CASES[case])
    for name, leaf in start.items():
        # (R, P, page, ...): the written slots agree, the rest are untouched
        mask = torch.zeros(leaf.shape[1:3], dtype=torch.bool)
        for p, o in written:
            mask[p, o] = True
        for pool in pools.values():
            assert torch.equal(pool[name][:, ~mask], leaf[:, ~mask]), name
            assert not torch.equal(pool[name][:, mask], leaf[:, mask]), name
        torch.testing.assert_close(pools["packed"][name][:, mask],
                                   pools["padded"][name][:, mask],
                                   rtol=0, atol=1e-5)


def test_pack_chunks_layout():
    """Positions, page targets, row ends and the query view's slots of a
    ragged launch, by hand."""
    pack = pack_chunks([np.array([5, 6, 7]), np.array([8])], [0, 9],
                       TABLE[[1, 3]], PAGE, "cpu")
    assert pack.tokens.tolist() == [[5, 6, 7, 8]]
    assert pack.positions.tolist() == [[0, 1, 2, 9]]
    assert pack.pages.tolist() == [4, 4, 4, 14]
    assert pack.offsets.tolist() == [0, 1, 2, 1]
    assert pack.last.tolist() == [2, 3]
    assert pack.slot.tolist() == [0, 1, 2, 3]           # rows of width 3
    assert pack.width == 3
    assert pack.lengths.dtype == pack.block_table.dtype == torch.int32
    q = torch.arange(4.0)[None, :, None]
    assert pack.to_rows(q)[:, :, 0].tolist() == [[0, 1, 2], [3, 0, 0]]
    assert torch.equal(pack.to_tokens(pack.to_rows(q)), q)
    with pytest.raises(ValueError, match="not mapped"):
        pack_chunks([np.array([1])], [0], np.full((1, N_PAGES), INVALID,
                                                  np.int32), PAGE, "cpu")


def _serve(model, attn_impl, packs=None):
    """Ragged prompts (2 to 41 tokens, chunks of 16, several a launch),
    then one that shares the longest one's first 24 tokens: (results,
    stats, the packed launches, prefill (tokens, slots))."""
    if packs is not None:
        model.packs_chunks = lambda: packs
    try:
        eng = ServingEngine(model, ServingConfig(
            max_batch=4, max_len=64, max_new_tokens=4, prefill_chunk=16,
            kv_page=8, attn_impl=attn_impl), device="cpu")
        rng = np.random.default_rng(3)
        V = model.cfg.vocab_size
        prompts = [rng.integers(0, V, n).astype(np.int32)
                   for n in (41, 2, 17, 9, 33, 1)]
        for p in prompts:
            eng.submit(p)
        eng.run_until_drained()
        eng.submit(np.concatenate([prompts[0][:24],
                                   rng.integers(0, V, 7).astype(np.int32)]))
        eng.run_until_drained()
    finally:
        if packs is not None:
            del model.packs_chunks
    res = {r.req_id: r.tokens.tolist() for r in eng.results}
    fill = tuple(eng.metrics.get(f"engine/fill/prefill/{q}").sum
                 for q in ("tokens", "slots"))
    return (res, eng.stats(), eng.metrics.value("engine/prefill_chunk_packed"),
            fill)


@pytest.mark.parametrize("attn_impl", ["paged", "gather"])
def test_engine_serves_the_same_packed(model, attn_impl):
    res, stats, n_packed, (tokens, slots) = _serve(model, attn_impl)
    want, wstats, n_padded, (wtokens, wslots) = _serve(model, attn_impl,
                                                       packs=False)
    assert res == want and len(res) == 7
    for key in ("dispatches", "prefill_tokens", "kv"):
        assert stats[key] == wstats[key], key
    assert stats["prefill_tokens"]["shared"] == 24
    assert n_packed == stats["dispatches"]["prefill_chunk"] > 1
    assert n_padded == 0
    assert tokens == slots == wtokens < wslots


@pytest.mark.parametrize("name,moe_impl", [
    ("deepseek-v2-lite-16b", None), ("granite-moe-3b-a800m", "dropless")],
    ids=["mla", "moe-dropless"])
def test_padded_launch_kept(name, moe_impl):
    """MLA gathers and masks by (rows, width) positions, and a dropless
    MoE's capacity depends on the launch's tokens: both keep the padded
    launch, and a ``PackedChunk`` is refused."""
    cfg = dataclasses.replace(reduced_config(get_config(name)),
                              dtype="float32")
    m = build_model(cfg, device="cpu", attention_impl="ref",
                    moe_impl=moe_impl,
                    generator=torch.Generator().manual_seed(0))
    assert not m.packs_chunks()
    res, stats, n_packed, (tokens, slots) = _serve(m, "paged")
    assert len(res) == 7 and stats["dispatches"]["prefill_chunk"] > 1
    assert n_packed == 0 and tokens < slots
    pack = pack_chunks([np.array([1, 2])], [0], TABLE[:1], PAGE, "cpu")
    with pytest.raises(ValueError, match="per-token"):
        m.prefill_chunk(pack, _pool(m), attn_impl="ref")


@pytest.mark.gpu
def test_packed_chunk_on_card_granite_heads():
    """granite-20b's widths and heads (48 query heads on one KV head of
    128, GELU d_ff 24576), 3 layers, bf16, through K5 on the card: ragged
    rows (one past a shared prefix, a 1-token row, a row's second chunk)
    packed and padded to (4, 512) give the same greedy tokens, and the
    written pages agree within bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K5 has no CPU mode)")
    cfg = dataclasses.replace(get_config("granite-20b"), num_layers=3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=gen)
    page, n_pages, C = 16, 66, 512                   # max_len 1056
    table = np.arange(4 * n_pages, dtype=np.int32).reshape(4, n_pages)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 1024)).astype(np.int32)
    launches = [[(0, 0, 512), (1, 0, 300), (2, 0, 1), (3, 256, 200)],
                [(0, 512, 181), (1, 300, 512)]]
    specs = model.paged_cache_specs(4 * n_pages, page)
    g = torch.Generator(device="cuda").manual_seed(1)
    start = {k: torch.randn(s, generator=g, device="cuda").to(d)
             for k, (s, d) in specs.items()}
    pools = {k: {n: t.clone() for n, t in start.items()}
             for k in ("padded", "packed")}
    for launch in launches:
        rows = len(launch)
        toks = np.zeros((4, C), np.int32)
        lens = np.zeros(4, np.int32)
        widths = np.zeros(4, np.int32)
        bt = np.full((4, n_pages), INVALID, np.int32)
        for i, (r, f, w) in enumerate(launch):
            toks[i, :w] = prompts[r, f:f + w]
            lens[i], widths[i], bt[i] = f, w, table[r]
        want, _, _ = model.prefill_chunk(
            torch.from_numpy(toks).cuda(), pools["padded"],
            torch.from_numpy(lens).cuda(), torch.from_numpy(widths).cuda(),
            block_table=torch.from_numpy(bt).cuda(), attn_impl="cuda")
        pack = pack_chunks([prompts[r, f:f + w] for r, f, w in launch],
                           [f for _, f, _ in launch],
                           table[[r for r, _, _ in launch]], page, "cuda")
        got, _, _ = model.prefill_chunk(pack, pools["packed"],
                                        attn_impl="cuda")
        want = want[:rows].float()
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert _rel_err(got.float(), want) < 0.02
    for name in start:
        assert _rel_err(pools["packed"][name].float(),
                        pools["padded"][name].float()) < 0.02, name


def _rel_err(a, b):
    """Largest difference over the largest magnitude."""
    return float((a - b).abs().max() / b.abs().max())
