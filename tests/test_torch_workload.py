"""The port's workload generators vs ``repro.data.workload``: for seeds 0,
1 and 2, every generator yields the same stream (ids, descriptors, prompts,
requests, events) in both packages, element for element."""
import dataclasses

import numpy as np
import pytest

from repro.data import workload as J
from repro_torch.data import workload as T

SEEDS = (0, 1, 2)


class _Membership:
    """Records what a ``ChaosSchedule`` replays onto a membership plane."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **kw: self.calls.append((name, a, sorted(kw.items())))


def _equal(a, b):
    """Deep equality of nested tuples / lists / arrays / dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        return _equal(dataclasses.astuple(a), dataclasses.astuple(b))
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
        return
    assert a == b, (a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_zipf_workload(seed):
    kw = dict(num_nodes=3, pool_size=40, dim=16, seed=seed)
    j, t = J.ZipfWorkload(**kw), T.ZipfWorkload(**kw)
    _equal(t.scenes, j.scenes)
    _equal(t.payloads, j.payloads)
    _equal(list(t.stream(4, 3, seed=seed + 1)),
           list(j.stream(4, 3, seed=seed + 1)))
    _equal(list(t.stream_ids(4, 3, seed=seed)),
           list(j.stream_ids(4, 3, seed=seed)))
    _equal(t.token_prompts(100, 12), j.token_prompts(100, 12))


@pytest.mark.parametrize("seed", SEEDS)
def test_roaming_workload(seed):
    kw = dict(num_clusters=3, nodes_per_cluster=2, users_per_node=3,
              pool_size=40, dim=16, mobility=0.3, seed=seed)
    j, t = J.RoamingWorkload(**kw), T.RoamingWorkload(**kw)
    _equal(list(t.stream(5, seed=seed + 7)), list(j.stream(5, seed=seed + 7)))
    _equal(t.current, j.current)


@pytest.mark.parametrize("seed", SEEDS)
def test_shared_prefix_workload(seed):
    kw = dict(num_sessions=4, prefix_len=24, suffix_min=3, suffix_max=9,
              vocab_size=500, seed=seed)
    j, t = J.SharedPrefixWorkload(**kw), T.SharedPrefixWorkload(**kw)
    _equal(t.prefixes, j.prefixes)
    _equal(list(t.stream(12, seed=seed)), list(j.stream(12, seed=seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_paced_workload(seed):
    kw = dict(num_clusters=2, nodes_per_cluster=2, frame_users_per_node=3,
              bulk_users_per_node=2, pool_size=40, dim=16, mobility=0.2,
              step_ms=7.0, seed=seed)
    j, t = J.FramePacedWorkload(**kw), T.FramePacedWorkload(**kw)
    _equal(list(t.stream(6, seed=seed + 3)), list(j.stream(6, seed=seed + 3)))
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    _equal(t.descriptor(rt, 5), j.descriptor(rj, 5))
    _equal(t.token_prompts(300, 8, 40), j.token_prompts(300, 8, 40))


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_schedule(seed):
    kw = dict(num_clusters=4, nodes_per_cluster=3, every=3, steps=60,
              node_prob=0.5, announce=False, seed=seed)
    j, t = J.ChaosSchedule(**kw), T.ChaosSchedule(**kw)
    _equal(t.events, j.events)
    assert t.touched_clusters == j.touched_clusters
    mj, mt = _Membership(), _Membership()
    for step in range(61):
        _equal(t.apply(mt, step), j.apply(mj, step))
    assert mt.calls == mj.calls and mt.calls
    assert all(isinstance(e, T.ChaosEvent) for e in t.events)
