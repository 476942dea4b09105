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


@functools.lru_cache(maxsize=None)
def twin(name: str, reduced: bool = False):
    """(jax cfg, jax model, jax params, torch model) for config ``name``
    (``reduced_config`` of it when ``reduced``), float32."""
    jcfg, tcfg = get_config(name), torch_get_config(name)
    if reduced:
        jcfg, tcfg = reduced_config(jcfg), torch_reduced_config(tcfg)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = torch_build(tcfg, device="cpu")
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
