"""The port's two script entry points against the reference's (CPU):
``scripts/torch_dev_smoke.py``'s ``run_arch`` on every arch of
``ARCH_IDS`` at ``reduced_config`` (fp32, the reference's weights carried
across, the same numpy inputs) against the steps of
``scripts/dev_smoke.py`` on the reference model: loss within rel 1e-5,
decode logits within 1e-4; and ``scripts/torch_export_metrics.py``'s
output against ``scripts/export_metrics.py``'s on one snapshot written by
the port's ``MetricsRegistry.export``."""
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.obs.metrics import MetricsRegistry
from torch_twins import twin

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
sys.path.insert(0, str(SCRIPTS))
import torch_dev_smoke  # noqa: E402
import torch_export_metrics  # noqa: E402


def _reference_script(name):
    """A reference script loaded as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_run(cfg, jm, jp, inputs):
    """``scripts/dev_smoke.py``'s steps on the reference model, on
    ``inputs``, in one jitted function (quicker on the CPU than op by
    op): (loss, decode logits)."""
    def steps(params, batch):
        loss, _ = jm.loss(params, batch)
        if cfg.family == "encdec":
            logits, cache, lengths = jm.prefill(
                params, batch["enc_embeds"], batch["dec_tokens"],
                max_len=torch_dev_smoke.DEC_MAX_LEN)
        else:
            logits, cache, lengths = jm.prefill(
                params, batch["tokens"], max_len=torch_dev_smoke.S + 8,
                image_embeds=batch.get("image_embeds"))
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        return loss, jm.decode_step(params, cache, nxt, lengths)[0]

    loss, logits2 = jax.jit(steps)(
        jp, {k: jnp.asarray(v) for k, v in inputs.items()})
    return float(loss), np.asarray(logits2, np.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_run_arch_matches_jax(arch):
    cfg, jm, jp, tm = twin(get_config(arch).name, reduced=True)
    inputs = torch_dev_smoke.make_inputs(cfg)
    loss, logits = torch_dev_smoke.run_arch(arch, "cpu", inputs=inputs,
                                            model=tm)
    jloss, jlogits = _reference_run(cfg, jm, jp, inputs)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert logits.shape == jlogits.shape == (torch_dev_smoke.B,
                                             cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4, rtol=0)


def test_dev_smoke_main_prints_every_arch(capsys):
    assert torch_dev_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in out[:-1]] == list(ARCH_IDS)
    assert all(ln.startswith("OK ") and "loss=" in ln for ln in out[:-1])
    assert out[-1] == "all smoke OK"


def _snapshot(tmp_path):
    """A snapshot with counters, a gauge and a histogram, written by the
    port's registry."""
    reg = MetricsRegistry()
    reg.counter("engine/dispatches/decode").inc(7)
    reg.counter("ladder/hits-local").inc(3)
    reg.gauge("cache/occupancy").set(0.625)
    h = reg.histogram("timings/cloud_ms")
    for x in (0.5, 1.25, 3.0, 40.0, 41.5):
        h.observe(x)
    path = tmp_path / "metrics.json"
    reg.export(str(path))
    return path


@pytest.mark.parametrize("to_file", [False, True])
def test_export_metrics_matches_reference_script(tmp_path, capsys, to_file):
    snap = _snapshot(tmp_path)
    ref = _reference_script("export_metrics")
    outs = []
    for name, mod in (("port", torch_export_metrics), ("ref", ref)):
        argv = [str(snap)]
        if to_file:
            argv += ["-o", str(tmp_path / f"{name}.prom")]
        assert mod.main(argv) == 0
        printed = capsys.readouterr().out
        text = ((tmp_path / f"{name}.prom").read_text() if to_file
                else printed)
        outs.append((text, printed.replace(f"{name}.prom", "X")))
    assert outs[0] == outs[1]
    assert "# TYPE timings_cloud_ms summary" in outs[0][0]
