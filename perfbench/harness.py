"""One run of one cell: build the program (``repro_torch``) from the
cell's configuration with the benchmark's weights, drive its serving
engine with the cell's traffic, measure the window, and judge what it
served against the plain reference.

Phases (every clock is ``time.perf_counter``):

  set-up   kernels loaded (built on a checkout's first run), the model
           built and its weights drawn from the seed on the device, the
           engine made, then the backlog's warm phase (the rows admitted
           one by one so they do not finish in step, then topped up).
           ``setup_s`` runs from the process start to the window.
  window   ``seconds`` long: the tokens generated in its steps, over its
           length.
  drain    enough steps to finish every row that started in the window.
  check    the program freed, then the sampled requests through the
           reference (``check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check as CK
from perfbench import devtrace as DT
from perfbench import family as F
from perfbench import weights as WG
from perfbench.traffic import Traffic

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# keys of a configuration's ``model`` that are the benchmark's, not the
# port's ModelConfig fields: the registered config it starts from, and its
# reference module (``family.py``)
OWN_KEYS = ("arch", "reference")


@dataclasses.dataclass
class Req:
    rid: int
    content: int
    prompt_len: int
    submit_step: int              # steps run before it was submitted
    finish_step: Optional[int] = None
    tokens: Optional[np.ndarray] = None
    source: Optional[str] = None
    sched_step: Optional[int] = None  # the step whose ladder looked it up
    desc: Optional[np.ndarray] = None  # the descriptor that ladder used

    @property
    def first_step(self) -> int:
        """The step of its prefill (its first two tokens; a row decodes in
        the step that admits it, then one token a step)."""
        return self.finish_step - len(self.tokens) + 2


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str, root: Path = ROOT):
    """(cell entry, configuration file, traffic mix) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    return (cell,) + load_cell(cell["config"], cell["traffic"], root)


def load_cell(config: str, traffic: str, root: Path = ROOT):
    """(configuration file, traffic mix) by their names."""
    return (json.loads((root / "perfbench" / "configs"
                        / f"{config}.json").read_text()),
            json.loads((root / "perfbench" / "traffic"
                        / f"{traffic}.json").read_text()))


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's metrics: end-to-end ones untraced, per-layer traced."""
    e2e = bench["end_to_end"]
    cell_e2e = {m["name"] for m in e2e
                if workload in m.get("workloads", [workload])}
    if not trace:
        return [m for m in e2e if m["name"] in cell_e2e]
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            or ("workloads" not in m and m["moves"] in cell_e2e)]


def read_metric(name: str, win) -> Optional[float]:
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(win)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# ----------------------------------------------------------------------
# the program
# ----------------------------------------------------------------------
def model_spec(config: dict, overrides: Optional[dict] = None) -> dict:
    spec = dict(config["model"])
    spec.update((overrides or {}).get("model", {}))
    return spec


def model_config(spec: dict):
    """The port's ``ModelConfig`` of ``spec``: the registered ``arch`` with
    every other key of the spec put in.  ``mla``, ``moe`` and ``ssm`` are
    groups that state every field of their config (absent: none), so the
    program and the reference read the same numbers."""
    from repro_torch.configs import (MLAConfig, ModelConfig, MoEConfig,
                                     SSMConfig, get_config)

    groups = {"mla": MLAConfig, "moe": MoEConfig, "ssm": SSMConfig}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(spec) - known - set(OWN_KEYS))
    if unknown:
        raise SystemExit(f"model keys {unknown} are not fields of the "
                         "port's ModelConfig")
    fields = {k: v for k, v in spec.items()
              if k not in OWN_KEYS and k not in groups}
    for key, cls in groups.items():
        group = spec.get(key)
        if group is None:
            fields[key] = None
            continue
        names = {f.name for f in dataclasses.fields(cls)}
        missing, extra = sorted(names - set(group)), sorted(set(group) - names)
        if missing or extra:
            raise SystemExit(f"model.{key}: {cls.__name__} fields "
                             f"{missing} missing, {extra} unknown")
        fields[key] = cls(**group)
    return dataclasses.replace(get_config(spec["arch"]), **fields)


def build_model(spec: dict, seed: int, device):
    """The program's model for ``spec``, with the benchmark's weights."""
    from repro_torch.models.transformer import DecoderLM

    F.of(spec)                        # the reference module, or exit
    model = DecoderLM(model_config(spec), device=device)
    load_weights(model, spec, seed)
    return model


@torch.no_grad()
def load_weights(model, spec: dict, seed: int) -> None:
    """Copy the benchmark's weights of ``seed`` into every leaf."""
    params = {id(p) for p in model.parameters()}
    filled = set()
    for i in [-1] + list(range(spec["num_layers"])):
        w = WG.layer(spec, seed, i, model.device, model.dtype)
        owner = model if i < 0 else model.layers[i]
        for name, t in w.items():
            p = getattr(owner, {"embed": "embed_tokens"}.get(name, name),
                        None)
            if p is None or p.shape != t.shape:
                raise SystemExit(f"leaf {name} of layer {i}: the program's "
                                 f"{None if p is None else tuple(p.shape)}, "
                                 f"the benchmark's {tuple(t.shape)}")
            p.copy_(t)
            filled.add(id(p))
        del w
    if filled != params:
        raise SystemExit("the benchmark's weights do not cover the model's "
                         f"{len(params - filled)} other leaves")


def make_engine(model, config: dict, device, tracer=None,
                overrides: Optional[dict] = None):
    """The program's serving engine with the configuration's CoIC front."""
    from repro_torch.core.coic import CoICConfig
    from repro_torch.core.policies import EvictionPolicy
    from repro_torch.serving.engine import ServingConfig, ServingEngine

    serving = dict(config["serving"])
    serving.update((overrides or {}).get("serving", {}))
    c = config["coic"]
    coic = CoICConfig(capacity=c["capacity"], threshold=c["threshold"],
                      descriptor=c["descriptor"], k_layers=c["k_layers"],
                      policy=EvictionPolicy(c["policy"]),
                      num_nodes=c["num_nodes"])
    return ServingEngine(model, ServingConfig(coic=coic, **serving),
                         tracer=tracer, device=device)


# ----------------------------------------------------------------------
# the drivers
# ----------------------------------------------------------------------
def _prompt_key(prompt) -> tuple:
    return len(prompt), np.asarray(prompt[:32], np.int32).tobytes()


class Driver:
    """Submits requests, steps the engine, and records what came back,
    and the descriptor each request's lookup used (read where the engine
    extracts them, so the check judges the timed path's own)."""

    def __init__(self, eng, traffic: Traffic):
        self.eng = eng
        self.traffic = traffic
        self.reqs: Dict[int, Req] = {}
        self.order: List[Req] = []
        self.steps = 0
        self.step_end: List[float] = []          # return time of each step
        self.outstanding = 0
        self._seen = 0
        self.max_batch = eng.cfg.max_batch
        self._unlooked: Dict[tuple, deque] = {}  # prompt -> rids, FIFO
        extract = getattr(eng, "_extract_descriptors", None)
        if extract is None:
            raise SystemExit("the engine has no _extract_descriptors: the "
                             "check cannot read the timed path's descriptors")

        def recorded(prompts):
            desc, ms = extract(prompts)
            for p, d in zip(prompts, desc):
                rids = self._unlooked.get(_prompt_key(p))
                if rids:
                    r = self.reqs[rids.popleft()]
                    r.desc, r.sched_step = d, self.steps + 1
            return desc, ms

        eng._extract_descriptors = recorded

    def submit(self, content: int) -> Req:
        prompt = self.traffic.prompt(content)
        rid = self.eng.submit(prompt)
        r = Req(rid, int(content), len(prompt), self.steps)
        self.reqs[rid] = r
        self.order.append(r)
        self._unlooked.setdefault(_prompt_key(prompt), deque()).append(rid)
        self.outstanding += 1
        return r

    def step(self) -> float:
        self.eng.step()
        t = time.perf_counter()
        self.steps += 1
        self.step_end.append(t)
        res = self.eng.results
        for x in res[self._seen:]:
            r = self.reqs[x.req_id]
            r.finish_step = self.steps
            r.tokens, r.source = np.asarray(x.tokens), x.source
            self.outstanding -= 1
        self._seen = len(res)
        return t


def run_backlog(d: Driver, mix: dict, seconds: float, on_window=None):
    """The backlog.  Returns (T0, T1, s0, s1): the window's bounds in time
    and in steps (steps s0 + 1 .. s1 are in it)."""
    warm = mix["warm"]
    ramp = int(warm["ramp_steps"])
    target = d.max_batch + int(mix["waiting"])
    cap = int(mix["max_per_step"])
    nxt = 0

    def send(n):
        nonlocal nxt
        for _ in range(min(n, cap)):
            d.submit(d.traffic.content(nxt))
            nxt += 1

    for k in range(ramp):
        send((k + 1) * d.max_batch // ramp - k * d.max_batch // ramp)
        d.step()
    for k in range(int(warm["settle_steps"])):
        if k == int(warm["settle_steps"]) - 2 and on_window is not None:
            on_window("trace")      # a profiler takes seconds to start
        send(max(0, target - d.outstanding))
        d.step()
    if on_window is not None:
        on_window("start")
    T0, s0 = d.step_end[-1], d.steps
    while True:
        send(max(0, target - d.outstanding))
        if d.step() >= T0 + seconds:
            break
    T1, s1 = d.step_end[-1], d.steps
    if on_window is not None:
        on_window("stop")
    n_new = d.eng.cfg.max_new_tokens
    for _ in range(n_new + 2):
        d.step()
    return T0, T1, s0, s1


def drive(d: Driver, mix: dict, seconds: float, on_window=None):
    """The mix's phases.  Returns (T0, T1, s0, s1, the window's requests:
    those that generated tokens in it)."""
    if mix["arrivals"] != "backlog":
        raise SystemExit(f"arrivals {mix['arrivals']!r}: the harness "
                         "drives a backlog only")
    T0, T1, s0, s1 = run_backlog(d, mix, seconds, on_window)
    window = [r for r in d.order if r.tokens is not None
              and r.source == "cloud" and r.first_step <= s1
              and r.finish_step > s0]
    return T0, T1, s0, s1, window


# ----------------------------------------------------------------------
class Window:
    """What a metric reader sees of the window (``metrics/*.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _hist(snap: dict, name: str):
    h = snap.get(name) or {}
    return h.get("count", 0), h.get("sum", 0.0)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", overrides: Optional[dict] = None,
        t_start: Optional[float] = None, log=sys.stderr,
        bench: Optional[dict] = None):
    """One run; returns (the result line's object, ``check`` last; what
    else the check read: the requests and tokens it checked).  ``bench``
    stands for ``BENCHMARK.json`` (tests drive cells it does not hold)."""
    t_start = time.perf_counter() if t_start is None else t_start

    def note(what):
        print(f"perfbench: {time.perf_counter() - t_start:8.2f} s {what}",
              file=log, flush=True)

    bench = load_bench() if bench is None else bench
    cell, config, mix = cell_files(bench, workload)
    ov = overrides or {}
    mix = {**mix, **ov.get("traffic", {})}
    config = {**config, "check": {**config["check"], **ov.get("check", {})}}
    spec = model_spec(config, overrides)
    if device == "cuda":
        from repro_torch.kernels import build_all
        build_all()
        note("kernels loaded")
    tracer = None
    if trace:
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    with torch.no_grad():
        model = build_model(spec, seed, device)
        note("model built, weights drawn")
        eng = make_engine(model, config, device, tracer, overrides)
        traffic = Traffic(mix, spec["vocab_size"], seed)
        d = Driver(eng, traffic)
        dtrace = DT.DeviceTrace(torch) if (trace and device == "cuda") \
            else None
        snaps = {}

        def on_window(what):
            note(f"window: {what} (step {d.steps})")
            if what == "start":
                snaps["m0"] = eng.metrics.snapshot()
            elif what == "stop":
                snaps["m1"] = eng.metrics.snapshot()
            if dtrace is not None and what == "trace":
                dtrace.start()
            elif dtrace is not None and what == "stop":
                dtrace.stop()

        gc.collect()
        gc.freeze()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        T0, T1, s0, s1, window = drive(d, mix, seconds, on_window)
        attempted = len(window)
        note(f"drained (step {d.steps})")
        setup_s = T0 - t_start
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        win = Window(T0=T0, T1=T1, s0=s0, s1=s1, seconds=T1 - T0,
                     reqs=d.order,
                     step_end=d.step_end, spec=spec, config=config,
                     mix=mix, k_layers=config["coic"]["k_layers"],
                     hist=lambda n: tuple(b - a for a, b in zip(
                         _hist(snaps["m0"], n), _hist(snaps["m1"], n))),
                     device_events=None, spans=None)
        if dtrace is not None:
            dtrace.read()
            note("device trace read")
        if trace:
            win.spans = DT.SpanIndex(tracer.events,
                                     time.perf_counter()
                                     - tracer.now_us() * 1e-6)
            if dtrace is not None:
                win.device_events = DT.clip(dtrace.events, T0, T1)
        names = metrics_of(bench, workload, trace)
        out_metrics = {}
        for m in names:
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = read_metric(m["name"], win)
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = None
        busy = None
        if win.device_events is not None:
            busy = sum(b - a for a, b in DT.union(win.device_events))
            breakdown = DT.breakdown(win.device_events, win.spans, T0, T1)
        # the program's state goes before the reference runs
        finished = [r for r in d.order if r.tokens is not None]
        del eng, model, d, win
        if dtrace is not None:
            dtrace.events = []
        gc.collect()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        note("metrics read, program freed")
        checks, info = CK.judge(torch, spec, config, seed, traffic,
                                finished, window, device)
    note("checked")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    # the window holds the requests that finished: one that the engine
    # drops never enters it (and shows as fewer tokens), so none fails
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": 0, "metrics": out_metrics,
              "device": device_info(torch, device, peak)}
    if trace and busy is not None:
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = T1 - T0
        result["breakdown"] = breakdown
    result["check"] = checks
    return result, info


def device_info(torch, device, peak) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
