"""The dry run's serve cells (``launch/dryrun.py`` over
``serving/sharded.py``) against the JAX package (CPU).

- The sharded prefill and one decode step of the reduced ``llama3.2-1b``,
  ``mamba2-2.7b`` and ``deepseek-v2-lite-16b`` on (data 2, model 2)
  record the same collectives (kind, bytes, group, in order) and the same
  ``FlopCounterMode`` total on ``meta`` (rank 0 of a fake group of 4) as on
  real CPU tensors (rank 0 of a world of 4 ``gloo`` ranks), and every
  ``torch.distributed`` call of the CPU step went through the record
  (``tests/torch_dryrun_serve_cases.py``).
- The one-device prefill (B 4 x S 12, the cache of S) and decode step
  (a cache of 32) of the reduced ``llama3.2-1b`` count exactly the FLOPs
  of the ``dot_general`` equations of the reference's ``jax.make_jaxpr``
  of its ``prefill`` / ``decode_step``.  Tolerance 0, no gap: the plain
  flash attention and flash-decode count the reference's two products.
- ``plan_cell`` finishes one cell per family kind with FLOPs, collectives
  and output bytes and no ``pending``: llama3.2-1b x decode_32k x single
  (GQA over 'model'-split slots), h2o-danube3-4b x long_500k x multi (a
  sliding-window ring over 512 ranks' slots), jamba-v0.1-52b x long_500k
  x single (SSM states gathered, MoE) and whisper-small x prefill_32k x
  single (the encoder-decoder).
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced_config
from repro.models import build_model as jax_build
import torch_dryrun_serve_cases as C
from torch_multicard_cases import run_world
from test_torch_dryrun import _dot_flops


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    cpu = run_world(C.cpu_steps, 4, str(tmp_path_factory.mktemp("cpu")))
    meta = C.run_meta(str(tmp_path_factory.mktemp("meta")))
    return {"cpu": cpu[0], **meta}


@pytest.mark.parametrize("arch", C.STEP_ARCHS)
def test_meta_serve_steps_record_what_the_cpu_steps_do(cases, arch):
    for kind, (f_meta, rec_meta, _), (f_cpu, rec_cpu, calls) in zip(
            ("prefill", "decode"), cases["meta"][arch], cases["cpu"][arch]):
        assert rec_meta == rec_cpu and len(rec_cpu) > 0, kind
        assert {k for k, _, _ in rec_cpu} <= {"all-gather", "all-reduce"}
        assert f_meta == f_cpu > 0, kind
        assert sum(calls.values()) == len(rec_cpu), (kind, calls)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_one_device_serve_flops_match_reference_dot_generals(kind):
    import jax

    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.launch.dryrun import StepFlops
    from repro_torch.models import build_model as torch_build
    from repro_torch.serving.sharded import (sharded_decode_step,
                                             sharded_prefill_step)

    B, S, max_len = 4, 12, 32
    jm = jax_build(reduced_config(get_config("llama3.2-1b")))
    params = jm.init_shapes()
    tm = torch_build(treduced(tget("llama3.2-1b")), device="meta")
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tm.init_shapes().items()}

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if kind == "prefill":
        jx = jax.make_jaxpr(jm.prefill)(
            params, jax.ShapeDtypeStruct((B, S), np.int32))
        with StepFlops() as fc:
            sharded_prefill_step(tm)(meta, {"tokens": ints(B, S)})
    else:
        i32 = jax.ShapeDtypeStruct((B,), np.int32)
        jx = jax.make_jaxpr(jm.decode_step)(
            params, jm.cache_specs(B, max_len), i32, i32)
        cache = {k: torch.empty(s, dtype=d, device="meta")
                 for k, (s, d) in tm.cache_specs(B, max_len).items()}
        with StepFlops() as fc:
            sharded_decode_step(tm)(meta, cache, ints(B), ints(B))
    assert fc.get_total_flops() == _dot_flops(jx.jaxpr) > 0


@pytest.mark.parametrize("cell", C.PLAN_CELLS, ids=lambda c: "-".join(
    map(str, c)))
def test_plan_cell_serve_kinds(cases, cell):
    rec = cases["plan"][cell]
    assert rec["ok"] and rec["skipped"] is None and "pending" not in rec
    assert rec["num_devices"] == (512 if cell[2] else 256)
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["per_kind"]["all-gather"]["count"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["memory_analysis"]["output_size_in_bytes"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
