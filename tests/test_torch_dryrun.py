"""The port's dry run (``launch/dryrun.py``, ``launch/collective_bytes.py``)
against the JAX package's (CPU).

- ``_wire_factor`` and the dtype bytes equal ``repro.launch.hloparse``'s
  for every kind and group sizes 1, 2, 16, 256 and 512; ``summarize`` of a
  record equals ``parse_collectives`` of the same collectives written as
  compiled HLO (keys and numbers; ``comp`` names the issuer);
- in ONE spawned process with fake process groups
  (``tests/torch_dryrun_cases.py``): a (2, 2) train step of the reduced
  ``llama3.2-1b``, ``granite-moe-3b-a800m`` (``dropless``) and
  ``mamba2-2.7b`` records the same collectives (kind, bytes, group, in
  order) and the same ``FlopCounterMode`` total on ``meta`` as on real CPU
  tensors, and every ``torch.distributed`` call the step makes passed
  through the record; ``plan_cell(llama3.2-1b, train_4k, single)`` and
  its decode cell (``decode_32k``, the sharded decode step) complete with
  FLOPs, collectives and output bytes, both with the reference rules'
  argument bytes; and for every
  arch x shape x both meshes the per-rank argument bytes that
  ``cell_arguments`` places equal the sum of this rank's shard bytes that
  the reference's rules give (``spec_for`` on a shape-only mesh);
- one single-device train step of the reduced ``llama3.2-1b`` (remat
  ``nothing``) counts the FLOPs of the ``dot_general`` equations of the
  reference's ``jax.make_jaxpr`` of its step (scan bodies times their
  length; ``pjit``, ``custom_vjp`` and other sub-jaxprs recursed) plus one
  gap, named: the plain flash-attention backward recomputes the forward's
  two S x S products (Q K^T and P V; flash attention keeps no
  probabilities), 2 x 2 B H S^2 D per layer.  Tolerance 0: the counts
  are integers.
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro.configs import supports_cell
from repro.launch import hloparse as JH
from repro.launch import specs as JSpecs
from repro.models import build_model as jax_build
from repro.parallel import sharding as JS
from repro_torch.launch import collective_bytes as TC
import torch_dryrun_cases as C

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("group", [1, 2, 16, 256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_wire_factor_matches_reference(kind, group):
    assert TC._wire_factor(kind, group) == JH._wire_factor(kind, group)


def test_dtype_bytes_match_reference():
    names = {"pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
             "s16": torch.int16, "u16": torch.uint16, "bf16": torch.bfloat16,
             "f16": torch.float16, "s32": torch.int32, "u32": torch.uint32,
             "f32": torch.float32, "s64": torch.int64, "u64": torch.uint64,
             "f64": torch.float64, "c64": torch.complex64,
             "c128": torch.complex128}
    assert set(names) == set(JH._DTYPE_BYTES)
    assert {names[k]: v for k, v in JH._DTYPE_BYTES.items()} == \
        TC._DTYPE_BYTES
    assert TC.shape_bytes((2, 16, 4096), torch.bfloat16) == \
        JH._shape_bytes("bf16[2,16,4096]")


HLO = """
HloModule test

ENTRY %main (a: f32[128], b: bf16[4,256]) -> f32[512] {
  %ag = f32[512]{0} all-gather(f32[128]{0} %a), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = bf16[4,256]{1,0} all-reduce(bf16[4,256]{1,0} %b), replica_groups=[1,16]<=[16], to_apply=%add
  %ar2 = f32[512]{0} all-reduce(f32[512]{0} %ag), replica_groups={{0,1}}, to_apply=%add
  ROOT %out = f32[512]{0} copy(f32[512]{0} %ar2)
}
"""


def test_summarize_matches_parse_collectives():
    from repro_torch.parallel.collectives import Collective

    rec = [Collective("all-gather", 512 * 4, 4),
           Collective("all-reduce", 4 * 256 * 2, 16),
           Collective("all-reduce", 512 * 4, 2)]
    got, want = TC.summarize(rec), JH.parse_collectives(HLO)
    assert set(got) == set(want)
    assert got["per_kind"] == want["per_kind"]
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"])
    assert [set(r) for r in got["schedule"]] == \
        [set(r) for r in want["schedule"]]
    for g, w in zip(got["schedule"], want["schedule"]):
        assert {k: g[k] for k in ("kind", "bytes", "group", "mult")} == \
            {k: w[k] for k in ("kind", "bytes", "group", "mult")}
    assert [r["comp"] for r in got["schedule"]] == [
        "gather_stack", "all_reduce", "all_reduce"]
    empty = TC.summarize([])
    assert empty["total_wire_bytes"] == 0.0
    assert set(empty["per_kind"]) == set(KINDS)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return C.run_cases(str(tmp_path_factory.mktemp("dryrun")))


@pytest.mark.parametrize("arch", [a for a, _ in C.STEP_CASES])
def test_meta_step_records_what_the_cpu_step_does(cases, arch):
    meta, cpu = (cases["steps"][arch][d] for d in ("meta", "cpu"))
    (f_meta, rec_meta, _), (f_cpu, rec_cpu, calls) = meta, cpu
    assert rec_meta == rec_cpu and len(rec_cpu) > 0
    assert {k for k, _, _ in rec_cpu} <= {"all-gather", "all-reduce"}
    assert f_meta == f_cpu > 0
    # every collective the step called went through the record
    assert sum(calls.values()) == len(rec_cpu), calls
    assert calls.get("all_gather_into_tensor", 0) == sum(
        k == "all-gather" for k, _, _ in rec_cpu)


def test_plan_cell_train_and_serve(cases):
    rec, dec = cases["plan"], cases["plan_decode"]
    assert rec["ok"] and rec["num_devices"] == 256
    assert rec["cost_analysis"]["flops"] > 0
    pk = rec["collectives"]["per_kind"]
    assert pk["all-gather"]["count"] > 0 and pk["all-reduce"]["count"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0
    assert rec["memory_analysis"]["output_size_in_bytes"] > 0
    for absent in ("temp_size_in_bytes", "generated_code_size_in_bytes"):
        assert absent not in rec["memory_analysis"]
    assert "bytes_accessed" not in rec["cost_analysis"]
    assert dec["ok"] and "pending" not in dec
    assert dec["cost_analysis"]["flops"] > 0
    assert dec["collectives"]["per_kind"]["all-gather"]["count"] > 0
    assert dec["memory_analysis"]["output_size_in_bytes"] > 0
    for r, shape in ((rec, "train_4k"), (dec, "decode_32k")):
        assert r["memory_analysis"]["argument_size_in_bytes"] == _ref_bytes(
            "llama3.2-1b", shape, "single"), shape


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


MESHES = {"single": FakeMesh(data=16, model=16),
          "multi": FakeMesh(pod=2, data=16, model=16)}


def _local_bytes(spec, shape, dtype, mesh) -> int:
    n = np.dtype(dtype).itemsize
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= dim // int(np.prod([mesh.shape[a] for a in axes]))
    return n


def _ref_bytes(arch, shape, mesh_kind) -> int:
    """This rank's argument bytes of the reference's cell by its rules."""
    cfg, cell, mesh = get_config(arch), SHAPES[shape], MESHES[mesh_kind]
    jm = jax_build(cfg)
    axes, shapes = jm.logical_axes(), jm.init_shapes()

    def tree(specs, axes_of, rules):
        return sum(_local_bytes(rules.spec_for(axes_of(k), v.shape, mesh),
                                v.shape, v.dtype, mesh)
                   for k, v in specs.items())

    def batch_axes(specs):
        return lambda k: ("batch",) + (None,) * (len(specs[k].shape) - 1)

    if cell.kind == "train":
        r = JS.RULES_TRAIN
        p = sum(_local_bytes(r.spec_for(axes[k], v.shape, mesh), v.shape,
                             np.float32, mesh) for k, v in shapes.items())
        b = JSpecs.batch_specs(cfg, cell)
        return 3 * p + 2 * 4 + tree(b, batch_axes(b), r)
    r = JS.RULES_SERVE_LONG if shape == "long_500k" else JS.RULES_SERVE
    total = tree(shapes, axes.__getitem__, r)
    if cell.kind == "prefill":
        b = JSpecs.batch_specs(cfg, cell)
        return total + tree(b, batch_axes(b), r)
    cache, inputs = JSpecs.decode_specs(jm, cfg, cell)
    return (total + tree(cache, jm.cache_axes().__getitem__, r)
            + tree(inputs, batch_axes(inputs), r))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference_rules(cases, arch, mesh_kind):
    for shape in SHAPES:
        got = cases["bytes"][arch, shape, mesh_kind]
        if not supports_cell(get_config(arch), SHAPES[shape])[0]:
            assert got is None
            continue
        assert got == _ref_bytes(arch, shape, mesh_kind), shape


def _dot_flops(jaxpr, mult=1) -> int:
    """2 x output size x contracted size of every ``dot_general``, sub-
    jaxprs recursed (a scan's body times its length)."""
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            a = e.invars[0].aval.shape
            total += 2 * int(np.prod(e.outvars[0].aval.shape)) * int(
                np.prod([a[i] for i in lc])) * mult
        inner_mult = mult * (e.params["length"]
                             if e.primitive.name == "scan" else 1)
        for v in e.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                j = sub if hasattr(sub, "eqns") else getattr(sub, "jaxpr",
                                                             None)
                if j is not None and not hasattr(j, "eqns"):
                    j = getattr(j, "jaxpr", None)
                if j is not None and hasattr(j, "eqns"):
                    total += _dot_flops(j, inner_mult)
    return total


def test_step_flops_match_reference_dot_generals():
    import jax

    from repro.train import trainer as JT
    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduced_config as treduced
    from repro_torch.launch.dryrun import StepFlops, train_arguments
    from repro_torch.models import build_model as torch_build
    from repro_torch.train import trainer as TT

    B, S = 4, 32
    jcfg = reduced_config(get_config("llama3.2-1b"))
    assert jcfg.remat == "nothing"
    jm = jax_build(jcfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), np.int32)}
    jx = jax.make_jaxpr(JT.make_train_step(jm, JT.TrainerConfig()))(
        JT.train_state_shapes(jm, JT.TrainerConfig()), batch)
    ref = _dot_flops(jx.jaxpr)

    tcfg = treduced(tget("llama3.2-1b"))
    tm = torch_build(tcfg, device="meta")
    state = train_arguments(tm, None, TT.TrainerConfig())
    with StepFlops() as fc:
        TT.make_train_step(tm, TT.TrainerConfig())(
            state, {"tokens": torch.empty((B, S), dtype=torch.int32,
                                          device="meta")})
    # the named gap: the backward's recomputed Q K^T and P V per layer
    gap = 2 * (2 * B * tcfg.num_heads * S * S * tcfg.head_dim) \
        * tcfg.num_layers
    assert fc.get_total_flops() == ref + gap, (fc.get_total_flops(), ref,
                                               gap)
