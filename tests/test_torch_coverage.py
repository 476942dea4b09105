"""The PyTorch port does all that the JAX package does, checked on the AST.

Every public definition of ``src/repro/`` — a top-level function or class,
a public method of a class, an UPPER_CASE constant of a module or a class
— must exist in the module of ``src/repro_torch/`` with the same relative
path (defined there, or bound there by an import).  A name that cannot
have a counterpart there stands in ``EXEMPT`` with the reason and, where
there is one, the port's definition that does its work instead; the test
checks that each exemption is still needed and that its counterpart
exists.  Neither package is imported: the files are parsed.

``benchmarks/`` (the reference's benchmark rows) lies outside ``src/``
and outside this check.
"""
import ast
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
UPPER = re.compile(r"^[A-Z][A-Z0-9_]*$")

_PALLAS = ("the Pallas kernel body; the port's is CUDA C++ in {src}, "
           "launched by kernel.py's {wrapper}")
_NEG_INF = ("the -1e30 mask value the Pallas body writes; the port's is "
            "kNegInf in {src}")
NEG_INF_CUDA = "constexpr float kNegInf = -1e30f;"
_KERNELS = {
    "decode_attention": ("decode_attention_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "ivf_pq": ("ivf_pq_probe_kernel",),
    "paged_attention": ("paged_attention_kernel",),
    "similarity": ("similarity_lookup_kernel",
                   "similarity_topk_batched_kernel",
                   "similarity_topk_kernel",
                   "similarity_topk_touch_kernel"),
}
_SPECS = ("a per-layer ParamSpec helper the reference composes into its "
          "param_specs; the port's DecoderBlock registers each layer's "
          "weights as module parameters, and DecoderLM.param_specs returns "
          "the same specs for the whole model")

# "module::name" -> (the port's counterpart: "module::name", or a CUDA
# source under src/repro_torch/ that defines ``NEG_INF_CUDA``, or None;
# the reason)
EXEMPT = {
    "launch/hloparse.py::parse_collectives": (
        "launch/collective_bytes.py::summarize",
        "reads compiled HLO text; the port's dry run records each "
        "collective as it runs on the meta device and sums its wire "
        "bytes"),
    "launch/dryrun.py::lower_cell": (
        None, "lowers a cell to HLO with jax.jit; a meta-device step has "
              "no HLO"),
    "launch/dryrun.py::extrapolate_costs": (
        None, "extrapolates the HLO cost analysis of lowered cells; there "
              "is no HLO on the meta device"),
    "launch/specs.py::SDS": (
        "models/layers.py::ShapeDtype",
        "an alias of jax.ShapeDtypeStruct; the port's abstract leaf is "
        "ShapeDtype"),
    "parallel/sharding.py::ActivationSharder.constrain": (
        "parallel/sharding.py::constrain",
        "wraps jax.lax.with_sharding_constraint, a layout hint to GSPMD; "
        "each rank of the port holds its own slices, so the module-level "
        "constrain is the identity and the sharder has nothing to "
        "constrain"),
    **{f"models/layers.py::{n}": ("models/transformer.py::"
                                  "DecoderLM.param_specs", _SPECS)
       for n in ("attention_specs", "mlp_specs", "gelu_mlp_specs",
                 "dense_mlp_specs", "moe_specs")},
    **{f"kernels/{k}/kernel.py::{n}": (
        f"kernels/{k}/kernel.py::{n[:-len('_kernel')]}_cuda",
        _PALLAS.format(src=f"csrc/{k}.cu",
                       wrapper=f"{n[:-len('_kernel')]}_cuda"))
       for k, names in _KERNELS.items() for n in names},
    **{f"kernels/{k}/kernel.py::NEG_INF": (
        f"csrc/{k}.cu", _NEG_INF.format(src=f"csrc/{k}.cu"))
       for k in _KERNELS},
}


def public_names(path: pathlib.Path, with_imports: bool = False) -> set:
    """The public definitions of one module: ``f``, ``C``, ``C.method``,
    ``CONST``, ``C.CONST``; with ``with_imports``, also the names its
    top-level imports bind."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.add(f"{node.name}.{b.name}")
                out |= {f"{node.name}.{n}" for n in _upper_targets(b)}
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        out |= _upper_targets(node)
    return {n for n in out
            if not any(p.startswith("_") for p in n.split("."))}


def _upper_targets(node) -> set:
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AnnAssign):
        targets = [node.target]
    else:
        return set()
    return {n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name) and UPPER.match(n.id)}


def missing(rel: str, port_root: pathlib.Path = PORT) -> list:
    """The reference's public names in module ``rel`` that the port's
    module of the same path (under ``port_root``) lacks, exemptions left
    out."""
    port = port_root / rel
    have = public_names(port, with_imports=True) if port.exists() else set()
    return sorted(n for n in public_names(REF / rel) - have
                  if f"{rel}::{n}" not in EXEMPT)


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    gone = missing(rel)
    assert not gone, (f"src/repro/{rel}: no counterpart in "
                      f"src/repro_torch/{rel} for {gone}")


@pytest.mark.parametrize("key", sorted(EXEMPT))
def test_exemption_is_needed_and_its_counterpart_exists(key):
    rel, name = key.split("::")
    assert name in public_names(REF / rel), f"{key}: not in the reference"
    port = PORT / rel
    assert not (port.exists() and name in public_names(port, True)), (
        f"{key} now has a counterpart in the port: drop the exemption")
    counterpart, reason = EXEMPT[key]
    assert reason
    if counterpart is None:
        return
    if "::" in counterpart:
        crel, cname = counterpart.split("::")
        assert cname in public_names(PORT / crel), counterpart
    else:
        assert NEG_INF_CUDA in (PORT / counterpart).read_text(), counterpart


def test_the_check_sees_a_missing_name(tmp_path):
    """A port module without one of the reference's names fails: the check
    that would have found ``PagedKVCache.table_rows`` missing."""
    rel = "serving/kv_cache.py"
    assert missing(rel) == []
    src = (PORT / rel).read_text()
    cut = src.replace("def table_rows(", "def _table_rows(")
    assert cut != src
    (tmp_path / "serving").mkdir()
    (tmp_path / rel).write_text(cut)
    assert missing(rel, tmp_path) == ["PagedKVCache.table_rows"]
