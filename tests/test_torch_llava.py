"""llava-next-34b's ``image_embeds`` in the port against the reference
(reduced: 4 image patches, 2 layers, GQA 4/2 heads; CPU, fp32, the same
weights through ``params_from_jax``; the patch embeddings a seeded
normal draw, as ``SyntheticLMData`` makes them).

- ``forward`` with the patches placed before the tokens: logits (B, P +
  S, V) within atol 1e-4 + rtol 1e-4;
- ``prefill`` with them (logits, every cache leaf, lengths P + S) and
  its last logits against ``forward``'s; then decode steps;
- ``loss`` over the text positions only (the first P hidden rows
  dropped), and its gradients against ``jax.grad`` (atol 1e-6 + rtol
  1e-4), from a ``SyntheticLMData`` batch with ``image_patches``;
- a text-only serving run (the reference's engine passes no image
  embeddings): decoded tokens, sources and stats equal to the reference
  engine's on the paged pool.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.coic import CoICConfig as JCoIC
from repro.serving.engine import ServingConfig as JServing
from repro.serving.engine import ServingEngine as JServe
from repro_torch.core.coic import CoICConfig as TCoIC
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.convert import master_params
from repro_torch.serving.engine import ServingConfig as TServing
from repro_torch.serving.engine import ServingEngine as TServe
from repro_torch.train import trainer as TT
from torch_twins import shared_prefix_prompts, twin

TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "llava-next-34b"


def _inputs(cfg, B=2, S=12, seed=0):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    img = g.standard_normal((B, cfg.num_image_patches, cfg.d_model)
                            ).astype(np.float32)
    return toks, img


def test_reduced_config_has_patches():
    cfg, _, _, tm = twin(NAME, True)
    assert cfg.family == "vlm" and cfg.num_image_patches == 4
    assert tm.cfg.num_image_patches == 4


def test_forward_with_image_embeds_matches_reference():
    cfg, jm, jp, tm = twin(NAME, True)
    toks, img = _inputs(cfg)
    ref = jm.forward(jp, toks, image_embeds=img)
    out = tm.forward(torch.from_numpy(toks),
                     image_embeds=torch.from_numpy(img))
    assert out.shape == (2, cfg.num_image_patches + 12, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_prefill_with_image_embeds_matches_reference_and_forward():
    cfg, jm, jp, tm = twin(NAME, True)
    toks, img = _inputs(cfg)
    P, S = cfg.num_image_patches, toks.shape[1]
    lg, cache, ln = tm.prefill(torch.from_numpy(toks),
                               image_embeds=torch.from_numpy(img),
                               max_len=P + S + 4)
    jlg, jcache, jln = jm.prefill(jp, toks, image_embeds=img,
                                  max_len=P + S + 4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    assert set(cache) == set(jcache)
    for k in jcache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **TOL)
    assert ln.tolist() == np.asarray(jln).tolist() == [P + S] * 2
    full = tm.forward(torch.from_numpy(toks),
                      image_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), **TOL)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jlg, -1), np.int32)
        assert (lg.argmax(-1).numpy() == nxt).all()
        lg, cache, ln = tm.decode_step(cache, torch.tensor(nxt), ln)
        jlg, jcache, jln = jm.decode_step(jp, jcache, jnp.asarray(nxt), jln)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)


def test_loss_over_text_positions_matches_reference():
    cfg, jm, jp, tm = twin(NAME, True)
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=17,
                            global_batch=2, image_patches=cfg.num_image_patches,
                            d_model=cfg.d_model, seed=4).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    total, met, grads = TT.loss_and_grads(
        tm, master_params(tm), TT.to_device(batch, "cpu"), torch.float32)
    np.testing.assert_allclose(float(total), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # the patch rows are inputs only: no target, and the text loss
    # differs from the loss without the patches
    text_only, _ = tm.loss(TT.to_device({"tokens": batch["tokens"]}, "cpu"))
    assert abs(float(text_only) - float(total)) > 1e-6


@pytest.mark.parametrize("attn_impl", ["gather", "paged"])
def test_text_only_engine_matches_reference(attn_impl):
    cfg, jm, jp, tm = twin(NAME, True)
    kw = dict(max_batch=4, max_len=96, max_new_tokens=6, kv_page=16,
              prefill_chunk=32, attn_impl=attn_impl)
    je = JServe(jm, jp, JServing(coic=JCoIC(capacity=64, threshold=0.98),
                                 **kw))
    te = TServe(tm, TServing(coic=TCoIC(capacity=64, threshold=0.98), **kw),
                device="cpu")
    prompts = shared_prefix_prompts(np.random.default_rng(0), cfg.vocab_size,
                                    10)
    for wave in (prompts[:7], prompts[:3] + prompts[7:]):
        for p in wave:
            assert je.submit(p) == te.submit(p)
        je.run_until_drained()
        te.run_until_drained()
    jr = {r.req_id: r for r in je.results}
    tr = {r.req_id: r for r in te.results}
    assert sorted(jr) == sorted(tr)
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].source == jr[rid].source
    js, ts = je.stats(), te.stats()
    for key in ("completed", "edge_hits", "cloud", "dispatches",
                "prefill_tokens", "kv", "max_step_ladder"):
        assert ts[key] == js[key], key
    assert ts["edge_hits"] >= 3
