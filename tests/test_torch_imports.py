"""Import hygiene of the PyTorch port: no module of ``src/repro_torch``,
nor ``chip_smoke.py``, the kernel benches (``scripts/*_bench.py``), the
port's scripts (``scripts/torch_*.py``, ``scripts/compress_probe.py``) or
the port's examples (``examples/torch_*.py``), imports JAX or anything of the JAX package
(``repro``, ``repro.*``) or ``benchmarks``, checked on the AST; and the
serving entry point, the attention kernels' modules, the model (its SSM
block too), the encoder-decoder, the block-reuse cache, the workload
generators, the training path (optimiser, schedule, trainer,
checkpointer, synthetic data, tree utilities) and the ported configs
and the multi-card modules (meshes, sharding rules and collectives,
gradient compression, elastic training; the spawned ranks' test cases
too), the launchers, the dry run, the sharded serve steps and the
examples import in a process where ``jax`` cannot load."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*_bench.py")) \
    + sorted((ROOT / "scripts").glob("torch_*.py")) \
    + [ROOT / "scripts" / "compress_probe.py"] + [ROOT / "tests" / "torch_multicard_cases.py",
       ROOT / "tests" / "torch_dryrun_cases.py",
       ROOT / "tests" / "torch_serve_cases.py",
       ROOT / "tests" / "torch_dryrun_serve_cases.py"] + EXAMPLES
BANNED = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_engine_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serving.engine, repro_torch.core.coic, "
            "repro_torch.kernels, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.configs.h2o_danube3_4b, "
            "repro_torch.core.layer_reuse, repro_torch.data.workload, "
            "repro_torch.configs.granite_20b, repro_torch.configs.qwen2_72b, "
            "repro_torch.configs.granite_moe_3b_a800m, "
            "repro_torch.models.ssm, repro_torch.models.transformer, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.mamba2_2p7b, "
            "repro_torch.configs.jamba_v01_52b, "
            "repro_torch.configs.llava_next_34b, "
            "repro_torch.configs.whisper_small, repro_torch.models.encdec, "
            "repro_torch.models.convert, repro_torch.models.registry, "
            "repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.optim.schedule, repro_torch.train.trainer, "
            "repro_torch.checkpoint.checkpointer, "
            "repro_torch.data.pipeline, repro_torch.utils.tree, "
            "repro_torch.launch.mesh, repro_torch.parallel.sharding, "
            "repro_torch.parallel.collectives, "
            "repro_torch.optim.grad_compress, repro_torch.train.elastic, "
            "repro_torch.launch.specs, repro_torch.launch.collective_bytes, "
            "repro_torch.launch.dryrun, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.serving.sharded, "
            + ", ".join(p.stem for p in EXAMPLES) + "; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH":
                              f"{ROOT / 'src'}:{ROOT / 'examples'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
