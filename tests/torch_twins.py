"""Shared set-up of the ``test_torch_*`` parity tests: one reference
``DecoderLM`` (JAX) and its PyTorch twin on the CPU, with the same weights,
in float32."""
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config, reduced_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs import reduced_config as torch_reduced_config
from repro_torch.models import build_model as torch_build
from repro_torch.models.convert import params_from_jax


# named variants of a config: fields replaced on both sides after
# ``reduced_config`` (which keeps neither mlp_kind nor the head counts)
VARIANTS = {
    # granite-20b's GELU MLP and its multi-query grouping, 48 query heads
    # on 1 KV head, at the reduced widths
    "gelu48": dict(mlp_kind="gelu", num_heads=48, num_kv_heads=1),
    # the reduced jamba at two repeats of its 4-layer pattern: stacked
    # leaves of a multi-position pattern
    "l8": dict(num_layers=8),
    # training: chunked CE (S - 1 = 32 in chunks of 8), and each repeat
    # rematerialised in backward (keeping nothing, or the matmuls)
    "chunk8": dict(loss_chunk=8),
    "remat": dict(remat="full"),
    "dots": dict(remat="dots", loss_chunk=8),
}
# leaves that start at a constant (zero biases; the SSM block's decay,
# step bias, skip, conv bias and norm; MLA's latent norm), moved by a
# random draw in a twin so that the parity tests exercise them
BIASES = ("/attn/bq", "/attn/bk", "/attn/bv", "/mlp/b_in", "/mlp/b_out",
          "/ssm/a_log", "/ssm/dt_bias", "/ssm/d_skip", "/ssm/norm_w",
          "/ssm/conv_b", "/attn/kv_norm")


@functools.lru_cache(maxsize=None)
def twin(name: str, reduced: bool = False, variant: str = "",
         moe_impl: str = None):
    """(jax cfg, jax model, jax params, torch model) for config ``name``
    (``reduced_config`` of it when ``reduced``, then ``VARIANTS[variant]``),
    float32, both models on the same ``moe_impl`` (None: the reference's
    rule).  ``BIASES`` leaves are their constant plus 0.1 x a standard
    normal (seed 0)."""
    jcfg, tcfg = get_config(name), torch_get_config(name)
    if reduced:
        jcfg, tcfg = reduced_config(jcfg), torch_reduced_config(tcfg)
    kw = dict(VARIANTS[variant]) if variant else {}
    jcfg = dataclasses.replace(jcfg, dtype="float32", **kw)
    tcfg = dataclasses.replace(tcfg, dtype="float32", **kw)
    jmodel = jax_build(jcfg, moe_impl=moe_impl)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    for k in sorted(jparams):
        if k.endswith(BIASES):
            jparams[k] = jax.numpy.asarray(
                np.asarray(jparams[k]) + 0.1 * rng.standard_normal(
                    jparams[k].shape), jparams[k].dtype)
    tmodel = torch_build(tcfg, device="cpu", moe_impl=moe_impl)
    params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, tmodel)
    return jcfg, jmodel, jparams, tmodel


def shared_prefix_prompts(rng, vocab, n, prefix_lens=(33, 17),
                          suffix=(3, 20)):
    """Prompts over a few shared heads + random private tails (the stream
    of tests/test_kv_paged.py)."""
    heads = [rng.integers(0, vocab, size=(L,)).astype(np.int32)
             for L in prefix_lens]
    out = []
    for i in range(n):
        sfx = rng.integers(0, vocab,
                           size=(int(rng.integers(*suffix)),)).astype(np.int32)
        out.append(np.concatenate([heads[i % len(heads)], sfx]))
    return out
