"""The sharded serve steps (``serving/sharded.py``) on four CPU ``gloo``
ranks, against the port's one-rank ``prefill`` / ``decode_step`` and the
JAX package's unsharded ones, on the same weights (fp32, the reduced
configs, the reference's random weights moved across by
``params_from_jax``).

One world of 4 ranks (``tests/torch_serve_cases.py``) runs every case:
(data 2, model 2) under ``RULES_SERVE`` for llama3.2-1b (a right-padded
batch with per-row lengths), granite-20b (one kv head: projected whole on
every rank), qwen2-72b (QKV biases), granite-moe-3b-a800m (``dropless``:
the rows gathered for the dispatch), llava-next-34b (a prefill with
``image_embeds``), deepseek-v2-lite-16b (MLA's latent over the slots),
mamba2-2.7b (the SSM states gathered whole over 'model' and sliced back),
jamba-v0.1-52b (one pattern: SSM, attention and MoE) and whisper-small
(self and cross caches over the slots); and under ``RULES_SERVE_LONG``,
whose slots spread over (data, model), for llama3.2-1b and h2o-danube3-4b
(a prompt past its window of 16: the prefill rolls the ring, 4 slots a
rank).  Each decode of 8 greedy steps crosses a rank's slot boundary.

- Every rank gathers the same tokens and logits; the tokens equal the
  one-rank run's, the logits within 1e-5, and ``unshard_cache`` of the
  sharded cache equals the one-rank cache within 1e-5 (fp32 sums in
  another order: the heads' partial outputs summed over 'model', the
  ranks' partial softmaxes merged).
- The JAX package's ``prefill`` + ``decode_step`` (jitted, greedy) gives
  the same tokens, and logits within ``atol=1e-4, rtol=1e-4``, the
  tolerance of ``tests/test_torch_model.py``.
- Each rank holds its range of the slots: the local cache's slot dim is
  the whole one over the slot ranks, and the steps cross a range's end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_serve_cases as C
from torch_multicard_cases import run_world
from torch_twins import twin

TOL = dict(atol=1e-4, rtol=1e-4)
NAMES = list(C.CASES)


def _twin(name):
    arch, _, moe_impl, _, _ = C.CASES[name]
    return twin(arch, True, "", moe_impl)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    params = {n: {k: np.asarray(v) for k, v in _twin(n)[2].items()}
              for n in NAMES}
    return run_world(C.serve_cases, 4, str(tmp_path_factory.mktemp("serve")),
                     NAMES, params)


def _jax_run(name):
    """The reference's unsharded prefill and greedy decode steps: (logits
    per step, tokens per step)."""
    jcfg, jm, jp, _ = _twin(name)
    g = C.CASES[name][4]
    batch, lengths = C.inputs(name, C.config(name))
    if "enc_embeds" in batch:
        lg, cache, ln = jax.jit(jm.prefill, static_argnames=("max_len",))(
            jp, jnp.asarray(batch["enc_embeds"]),
            jnp.asarray(batch["dec_tokens"]), max_len=g["max_len"])
    else:
        img = batch.get("image_embeds")
        lg, cache, ln = jax.jit(jm.prefill, static_argnames=("max_len",))(
            jp, jnp.asarray(batch["tokens"]),
            image_embeds=None if img is None else jnp.asarray(img),
            max_len=g["max_len"],
            lengths=None if lengths is None else jnp.asarray(lengths))
    decode = jax.jit(jm.decode_step)
    logits, toks = [np.asarray(lg)], []
    for _ in range(g["steps"]):
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        lg, cache, ln = decode(jp, cache, tok, ln)
        logits.append(np.asarray(lg))
    return logits, toks


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_one_rank(world, name):
    row = world[0][name]
    for r in world:
        for a, b in zip(r[name]["tokens"], row["tokens"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r[name]["logits"], row["logits"]):
            np.testing.assert_array_equal(a, b)
    one_logits, one_tokens, one_cache = row["one"]
    for a, b in zip(row["tokens"], one_tokens):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(row["logits"], one_logits):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert set(row["cache"]) == set(one_cache)
    for k, v in one_cache.items():
        np.testing.assert_allclose(row["cache"][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_reference(world, name):
    row = world[0][name]
    j_logits, j_tokens = _jax_run(name)
    for a, b in zip(row["tokens"], j_tokens):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(row["logits"], j_logits):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_slots(world, name):
    row = world[0][name]
    cfg = C.config(name)
    g = C.CASES[name][4]
    n_ranks = {"serve": 2, "long": 4}[C.CASES[name][3]]
    crossed = False
    for k, spec in row["specs"].items():
        whole = row["cache"][k].shape
        local = row["local"][k]
        if k.endswith(("/conv", "/state")):             # SSM: by channels
            assert spec[1] == "data" and spec[-1] == "model", (k, spec)
            assert np.prod(local) * 4 == np.prod(whole), (k, local, whole)
            crossed = True                      # no slots to cross
            continue
        assert local[2] * n_ranks == whole[2], (k, local, whole)
        if "cross" in k:                        # the encoder's positions
            continue
        start = C.prompt_len(name, cfg)
        slots = [p % whole[2] for p in range(start, start + g["steps"])]
        crossed |= len({s // local[2] for s in slots}) > 1
    assert crossed, name
