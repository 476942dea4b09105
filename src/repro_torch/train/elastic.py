"""Elastic scaling and failure handling — the port of
``repro/train/elastic.py``.

The failure model: a host stops heartbeating, its ranks disappear, and
the job continues on the survivors.  Every rank runs the same
``ElasticTrainer.run`` (SPMD), and a failure is simulated by a schedule:

  1. ``HeartbeatMonitor`` declares hosts dead after ``timeout`` silence.
  2. The runner rebuilds the mesh on the surviving data shards: a
     ``DeviceMesh`` over the first data_shards x model_shards ranks (the
     data axis shrinks; the model axis stays whole — tensor-parallel
     groups must stay whole).  A rank outside the new mesh leaves the run,
     says so in its events, and waits for the run's end (or for the next
     reconfiguration, which may take it back).
  3. The latest checkpoint is restored WITH RESHARDING onto the new mesh
     (``checkpoint/checkpointer.py``'s ``restore(shardings=...)``).
  4. The deterministic data pipeline replays from the restored step, so
     no batch is skipped or repeated.

Growth (ranks coming back) is the same path with a larger mesh.  A save
gathers the sharded state whole, the mesh's first rank writes it, and the
mesh's ranks wait for the write before going on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
# HeartbeatMonitor/SimulatedFailure live in core/membership.py so the
# serving control plane imports them without trainer deps; re-exported
# here as the reference does
from repro_torch.core.membership import HeartbeatMonitor, SimulatedFailure
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch.mesh import make_mesh, require_world
from repro_torch.train.trainer import (TrainerConfig, TrainState,
                                       init_train_state, make_train_step,
                                       place_state, state_shardings,
                                       unshard_state)

__all__ = ["SimulatedFailure", "HeartbeatMonitor", "ElasticConfig",
           "ElasticTrainer"]


@dataclasses.dataclass
class ElasticConfig:
    data_shards: int                 # initial data-axis size
    model_shards: int = 1
    checkpoint_every: int = 5
    checkpoint_dir: str = "build/elastic_ckpt"


class ElasticTrainer:
    """Drives training across mesh reconfigurations, on every rank of the
    process group.

    ``failure_schedule``: {step: new_data_shards} — at those steps a
    failure (or recovery, if larger) is injected; the runner reshapes and
    resumes from the latest checkpoint.  ``seed`` seeds the initial
    weights (the same on every rank); ``device`` is the ranks' device."""

    def __init__(self, model, tcfg: TrainerConfig, ecfg: ElasticConfig,
                 data: SyntheticLMData,
                 failure_schedule: Optional[Dict[int, int]] = None,
                 seed: int = 0, device="cuda"):
        require_world()
        self.model = model
        self.tcfg = tcfg
        self.ecfg = ecfg
        self.data = data
        self.failure_schedule = failure_schedule or {}
        self.seed = seed
        self.device = device
        self.ckpt = Checkpointer(ecfg.checkpoint_dir, keep=2,
                                 async_save=False)
        self.events: List[str] = []

    # ------------------------------------------------------------------
    def _build(self, data_shards: int):
        """(mesh, state shardings, step, the mesh's group, member?).
        Collective: every rank of the world builds it."""
        n = data_shards * self.ecfg.model_shards
        ranks = list(range(n))
        mesh = make_mesh((data_shards, self.ecfg.model_shards),
                         ("data", "model"), self.device, ranks=ranks)
        group = dist.new_group(ranks)
        if dist.get_rank() not in ranks:
            return mesh, None, None, group, False
        sh = state_shardings(self.model, mesh)
        step_fn = make_train_step(self.model, self.tcfg, mesh, sh)
        return mesh, sh, step_fn, group, True

    def _save(self, step: int, state: TrainState, sh, group) -> None:
        whole = unshard_state(state, sh)
        if dist.get_rank(group) == 0:
            self.ckpt.save(step, whole, block=True)
        dist.barrier(group=group)

    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> Tuple[Optional[TrainState], List[dict]]:
        """Train to ``num_steps``.  Returns (this rank's slices of the
        final state, or None on a rank that left the mesh; one dict of
        float metrics per step this rank ran)."""
        shards = self.ecfg.data_shards
        mesh, sh, step_fn, group, member = self._build(shards)
        history: List[dict] = []
        state = None
        if member:
            gen = torch.Generator(device=self.model.device).manual_seed(
                self.seed)
            state = place_state(init_train_state(self.model, gen, self.tcfg),
                                sh)
            self._save(0, state, sh, group)
        step = 0
        while step < num_steps:
            if (step in self.failure_schedule
                    and self.failure_schedule[step] != shards):
                shards = self.failure_schedule[step]
                self.events.append(
                    f"step {step}: reconfigure to {shards} data shards")
                mesh, sh, step_fn, group, member = self._build(shards)
                if not member:
                    self.events.append(
                        f"rank {dist.get_rank()}: outside the {shards}-shard "
                        "mesh, waiting for the run's end")
                    state = None
                    # the next reconfiguration may take this rank back:
                    # every rank builds each mesh (a collective)
                    later = sorted(s for s in self.failure_schedule
                                   if s > step)
                    if not later:
                        break
                    step = later[0]
                    continue
                latest = self.ckpt.latest_step()
                state = self.ckpt.restore(latest, state, shardings=sh,
                                          device=self.model.device)
                step = latest
                self.events.append(f"restored step {latest} onto new mesh")
                continue
            state, metrics = step_fn(state, self.data.batch_at(step))
            history.append({k: float(v) for k, v in metrics.items()})
            step += 1
            if step % self.ecfg.checkpoint_every == 0:
                self._save(step, state, sh, group)
        dist.barrier()                   # every rank: the run's end
        return state, history
