"""The port's launch layer against the JAX package's (CPU).

- ``train_state_shapes``, the models' ``cache_axes`` and
  ``launch/specs.py``'s ``batch_specs`` / ``decode_specs`` /
  ``input_specs`` equal the reference's (names, shapes, dtypes) for every
  ``ARCH_IDS`` x ``SHAPES`` cell that ``supports_cell`` admits (the port's
  models built on ``meta``, the reference's abstract);
- each decode cache leaf's ``spec_for`` under ``RULES_SERVE`` and
  ``RULES_SERVE_LONG`` on the production meshes (shape-only stand-ins)
  equals the reference's;
- ``launch.serve`` on the reduced ``coic-paper`` in float32 (16 requests
  over a pool of 4, batched and sequential scheduling, and without the
  edge cache)
  gives the reference launcher's results with its weights carried across:
  the stats (completed, tier hits, dispatches, semantic cache) and each
  request's tokens and source equal;
- ``launch.train --mesh 1x1`` on the reduced ``coic-paper`` (3 steps from
  the reference's initial state) gives the reference launcher's losses
  (unrounded) within 6e-5, and its checkpoint of step 2 restores with the reference's
  ``Checkpointer``, bit-equal to the port's state after 2 steps and within
  2 x (lr_1 + lr_2) of the reference's step-2 weights.
"""
import contextlib
import dataclasses
import functools
import io
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCkpt
from repro.configs import ARCH_IDS, SHAPES, get_config, reduced_config
from repro.configs import supports_cell
from repro.launch import specs as JSpecs
from repro.models import build_model as jax_build
from repro.parallel import sharding as JS
from repro.train import trainer as JT
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as TServe
from repro_torch.launch import specs as TSpecs
from repro_torch.launch import train as TTrain
from repro_torch.models import build_model as torch_build
from repro_torch.optim.adamw import OptState
from repro_torch.parallel import sharding as TS
from repro_torch.train import trainer as TT

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if supports_cell(get_config(a), SHAPES[s])[0]]
PROD = {"16x16": dict(data=16, model=16),
        "2x16x16": dict(pod=2, data=16, model=16)}


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


@functools.lru_cache(maxsize=None)
def models(name):
    return jax_build(get_config(name)), torch_build(tget(name),
                                                    device="meta")


def _same(tspecs, jspecs):
    assert set(tspecs) == set(jspecs)
    for k, v in jspecs.items():
        assert tspecs[k].shape == tuple(v.shape), k
        assert str(tspecs[k].dtype) == f"torch.{v.dtype}", k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shapes_and_cache_axes_match_reference(arch):
    jm, tm = models(arch)
    js = JT.train_state_shapes(jm, JT.TrainerConfig())
    ts = TT.train_state_shapes(tm, TT.TrainerConfig())
    for part in ("params", "mu", "nu"):
        j = js.params if part == "params" else getattr(js.opt, part)
        t = ts.params if part == "params" else getattr(ts.opt, part)
        _same(t, j)
    _same({"c": ts.opt.count, "s": ts.step},
          {"c": js.opt.count, "s": js.step})
    assert tm.cache_axes() == jm.cache_axes()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_reference(arch, shape):
    jm, tm = models(arch)
    cell = SHAPES[shape]
    jcfg, tcfg = get_config(arch), tget(arch)
    _same(TSpecs.batch_specs(tcfg, cell), JSpecs.batch_specs(jcfg, cell))
    _same(TSpecs.input_specs(tm, tcfg, cell),
          JSpecs.input_specs(jm, jcfg, cell))
    if cell.kind == "decode":
        (tc, ti), (jc, ji) = (TSpecs.decode_specs(tm, tcfg, cell),
                              JSpecs.decode_specs(jm, jcfg, cell))
        _same(tc, jc)
        _same(ti, ji)
        assert set(tm.cache_axes()) == set(tc)


@pytest.mark.parametrize("rules", ["RULES_SERVE", "RULES_SERVE_LONG"])
@pytest.mark.parametrize("arch,shape",
                         [c for c in CELLS if SHAPES[c[1]].kind == "decode"])
def test_cache_specs_for_match_reference(arch, shape, rules):
    jm, tm = models(arch)
    jc, _ = JSpecs.decode_specs(jm, get_config(arch), SHAPES[shape])
    axes = tm.cache_axes()
    for mesh in PROD.values():
        fake = FakeMesh(**mesh)
        for k, v in jc.items():
            got = getattr(TS, rules).spec_for(axes[k], tuple(v.shape), fake)
            want = getattr(JS, rules).spec_for(jm.cache_axes()[k],
                                               tuple(v.shape), fake)
            assert got == tuple(want), (k, mesh)


SERVE_ARGS = ["--reduced", "--requests", "16", "--pool", "4",
              "--prompt-len", "16", "--max-new", "4"]


@pytest.mark.parametrize("extra", [[], ["--scheduling", "sequential"],
                                   ["--no-coic"]],
                         ids=["batched", "sequential", "no-coic"])
def test_serve_launcher_matches_reference(extra, monkeypatch, capsys):
    """Both launchers' reduced config in float32, as the serving tests run
    their twins: a bf16 greedy decode of random weights meets near-ties
    in the logits that the two packages' sums break differently (for
    about one draw in ten of the reference's weights)."""
    import repro.launch.serve as JServe

    for mod in (JServe, TServe):
        monkeypatch.setattr(
            mod, "reduced_config", lambda c, r=mod.reduced_config:
            dataclasses.replace(r(c), dtype="float32"))
    kept = {}

    class Recording(JServe.ServingEngine):
        def __init__(self, model, params, cfg, *a, **kw):
            super().__init__(model, params, cfg, *a, **kw)
            kept.update(engine=self, params=params)

    monkeypatch.setattr(JServe, "ServingEngine", Recording)
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGS + extra)
    JServe.main()
    je = kept["engine"]
    args = TServe.parser().parse_args(SERVE_ARGS + extra
                                      + ["--device", "cpu"])
    te = TServe.run(args, params={k: np.asarray(v)
                                  for k, v in kept["params"].items()})
    jr = {r.req_id: r for r in je.results}
    tr = {r.req_id: r for r in te.results}
    assert sorted(jr) == sorted(tr) and len(tr) == 16
    for rid in jr:
        np.testing.assert_array_equal(tr[rid].tokens, jr[rid].tokens)
        assert tr[rid].source == jr[rid].source
    js, ts = je.stats(), te.stats()
    for key in ("completed", "edge_hits", "peer_hits", "cloud", "dispatches",
                "semantic"):
        assert ts.get(key) == js.get(key), key
    assert ("semantic" in ts) == ("--no-coic" not in extra)
    out = capsys.readouterr().out
    assert out.count("edge hits: ") == 2 and out.count("served 16 ") == 2


LOSS_RE = re.compile(r"step +(\d+) loss ([\d.]+)")


def test_train_launcher_matches_reference(tmp_path, monkeypatch):
    import repro.launch.train as JTrain

    argv = ["--reduced", "--steps", "3", "--log-every", "1",
            "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "jax")])
    # the reference launcher's losses unrounded: its one ``float`` call
    # per step reads the step's loss
    ref = []
    monkeypatch.setattr(JTrain, "float", lambda x: ref.append(float(x))
                        or ref[-1], raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        JTrain.main()
    assert [float(x) for _, x in LOSS_RE.findall(buf.getvalue())] == [
        round(x, 4) for x in ref] and len(ref) == 3

    # the reference launcher's initial state, made again in this process
    # (its initializer salts by hash(name), which is per process)
    jm = jax_build(reduced_config(get_config("coic-paper")))
    jtcfg = JT.TrainerConfig(peak_lr=3e-4, warmup_steps=10, total_steps=3)
    js = JT.init_train_state(jm, jax.random.PRNGKey(0), jtcfg)

    def T(d):
        return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}

    def initial():
        return TT.TrainState(
            params=T(js.params),
            opt=OptState(mu=T(js.opt.mu), nu=T(js.opt.nu),
                         count=torch.from_numpy(np.array(js.opt.count))),
            step=torch.from_numpy(np.array(js.step)))
    args = TTrain.parser().parse_args(argv + [
        "--ckpt-dir", str(tmp_path / "torch"), "--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final, losses = TTrain.run(args, initial())
    printed = [float(x) for _, x in LOSS_RE.findall(buf.getvalue())]
    assert printed == [round(x, 4) for x in losses]
    with contextlib.redirect_stdout(io.StringIO()):
        two, _ = TTrain.run(TTrain.parser().parse_args(
            ["--reduced", "--steps", "2", "--device", "cpu"]), initial())
    # both step in bf16 compute, whose sums differ between the packages
    assert max(abs(a - b) for a, b in zip(losses, ref)) <= 6e-5, (losses,
                                                                  ref)
    # the port's checkpoint of step 2 restores with the reference's
    # reader, bit-equal to the port's state after two steps (a run of 2
    # steps: in the warmup, its lrs are the 3-step run's)
    ck = JCkpt(str(tmp_path / "torch"))
    assert ck.steps() == [2]
    back = ck.restore(2, js)
    assert int(back.step) == int(back.opt.count) == int(two.step) == 2
    for got, want in ((back.params, two.params), (back.opt.mu, two.opt.mu),
                      (back.opt.nu, two.opt.nu)):
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.dtype == np.float32, k
            np.testing.assert_array_equal(np.asarray(v), want[k].numpy(), k)
    # ... and within the reference's step-2 weights by two updates' worth
    # of sign flips: an AdamW update moves an element by at most about
    # its step's lr, and a gradient at rounding level may take either
    # sign in either package
    lr = JT.make_optimizer(jtcfg).schedule
    bound = 2 * sum(float(lr(jax.numpy.int32(n))) for n in (1, 2))
    jref = JCkpt(str(tmp_path / "jax")).restore(2, js)
    assert set(back.params) == set(jref.params)
    for k, v in back.params.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(jref.params[k]),
                                   rtol=0, atol=bound, err_msg=k)
