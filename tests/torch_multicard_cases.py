"""Multi-rank cases of the port's multi-card slice, run on CPU ``gloo``
ranks spawned by ``torch.multiprocessing`` (``run_world``), with a
``file://`` store in a temporary directory: no network.  Each rank runs
every case of its world once and returns its results; the test modules
(``test_torch_multicard*.py``) hold them against the JAX package in the
parent process.  This module imports torch and ``repro_torch`` only, so
the spawned ranks never load JAX."""
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, init, out_dir, case_fn, args):
    torch.set_num_threads(1)             # the ranks share the host's cores
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        result = case_fn(rank, *args)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:                    # reported to the parent, not lost
        result = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


WORLD_TIMEOUT_S = 300


def run_world(case_fn, world: int, tmp_dir: str, *args) -> list:
    """``case_fn(rank, *args)`` on ``world`` spawned gloo ranks; returns
    every rank's result (a rank's exception is raised here).  A world
    still running after ``WORLD_TIMEOUT_S`` is killed and fails."""
    init = "file://" + os.path.join(tmp_dir, "store")
    ctx = mp.start_processes(_entry, args=(world, init, tmp_dir, case_fn,
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError(f"{case_fn.__name__}: ranks still "
                                     f"running after {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        if isinstance(res, dict) and "error" in res:
            raise AssertionError(f"rank {r} failed:\n{res['error']}")
        out.append(res)
    return out


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


# ---------------------------------------------------------------------------
# the cache axis
# ---------------------------------------------------------------------------

TOPK = dict(n=4, c=32, q=6, d=16, k=5)


def topk_inputs():
    """The inputs of the reference's ``test_shard_map_lookup_bitexact``."""
    n, c, q, d = TOPK["n"], TOPK["c"], TOPK["q"], TOPK["d"]
    rng = np.random.default_rng(2)
    keys = rng.standard_normal((n, c, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=-1, keepdims=True)
    valid = rng.random((n, c)) > 0.3
    return qs, keys, valid


CLUSTER = dict(N=4, C=8, D=32, P=4, B=4)


def cluster_stream(seed=0, steps=10):
    """(pool, payloads, [(ids, queries, mask) per step]) of the seeded
    grouped-lookup stream of ``test_torch_cluster.py``."""
    N, D, P, B = (CLUSTER[k] for k in ("N", "D", "P", "B"))
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((24, D)).astype(np.float32)
    pool /= np.linalg.norm(pool, axis=1, keepdims=True)
    pay = np.arange(24 * P, dtype=np.float32).reshape(24, P)
    out = []
    for _ in range(steps):
        ids = rng.integers(0, 24, size=(N, B))
        q = pool[ids] + 0.01 * rng.standard_normal((N, B, D)).astype(
            np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        out.append((ids, q, rng.random((N, B)) < 0.8))
    return pool, pay, out


def drive_cluster(cl, stream, admission):
    """Run the stream through a cluster (kill node 1 at step 4, revive at
    6, wipe at 8, as ``test_torch_cluster.py``); returns each lookup's
    (hit, tier, owner, score, value) and the final stats."""
    pool, pay, steps = stream
    out = []
    for step, (ids, q, mask) in enumerate(steps):
        if step == 4:
            cl.kill_node(1)
        if step == 6:
            cl.revive_node(1)
        if step == 8:
            cl.wipe()
        r = cl.lookup_grouped(q, mask)
        out.append(tuple(np.asarray(getattr(r, f)) for f in
                         ("hit", "tier", "owner", "score", "value")))
        for g in range(CLUSTER["N"]):
            miss = mask[g] & ~r.hit[g]
            if miss.any():
                cl.insert(g, q[g][miss], pay[ids[g][miss]])
    r = cl.lookup(2, pool[:3])
    out.append(tuple(np.asarray(getattr(r, f)) for f in
                     ("hit", "tier", "owner", "score", "value")))
    return out, cl.stats()


def cache_cases(rank):
    from repro_torch.core.cluster import ClusterConfig, CooperativeEdgeCluster
    from repro_torch.core.policies import EvictionPolicy
    from repro_torch.launch.mesh import CacheMeshConfig, make_cache_mesh
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.parallel.sharding import (sharded_topk_lookup,
                                               surviving_topk_lookup)

    res = {}
    qs, keys, valid = (torch.from_numpy(np.asarray(a))
                       for a in topk_inputs())
    cm = CacheMeshConfig(device="cpu")
    res["topk"] = tuple(_np(t) for t in cm.lookup(qs, keys, valid,
                                                  TOPK["k"]))
    mesh4 = cm.mesh
    alive = np.array([True, False, True, True])
    # survivors 3 != 4 ranks: the pooled probe
    res["surviving_pooled"] = tuple(_np(t) for t in surviving_topk_lookup(
        qs, keys, valid, alive, TOPK["k"], mesh4))
    # a 3-rank cache mesh (rank 3 builds it and stays out): the collective
    mesh3 = make_cache_mesh(3, device="cpu")
    if rank < 3:
        res["surviving_mesh3"] = tuple(_np(t) for t in surviving_topk_lookup(
            qs, keys, valid, alive, TOPK["k"], mesh3))
    res["all_alive"] = tuple(_np(t) for t in cm.surviving_lookup(
        qs, keys, valid, np.ones(4, bool), TOPK["k"]))
    res["direct"] = tuple(_np(t) for t in sharded_topk_lookup(
        qs, keys, valid, TOPK["k"], mesh4))
    # the cooperative cluster on the cache mesh, and without it
    runs = {}
    for admission in ("always", "second_hit"):
        kw = dict(num_nodes=CLUSTER["N"], node_capacity=CLUSTER["C"],
                  key_dim=CLUSTER["D"], payload_dim=CLUSTER["P"],
                  threshold=0.9, admission=admission,
                  policy=EvictionPolicy("lru"))
        reset_launches()
        mesh_run = drive_cluster(
            CooperativeEdgeCluster(ClusterConfig(**kw), mesh=mesh4,
                                   device="cpu"), cluster_stream(), admission)
        plain_run = drive_cluster(
            CooperativeEdgeCluster(ClusterConfig(**kw), device="cpu"),
            cluster_stream(), admission)
        runs[admission] = (mesh_run, plain_run)
    res["cluster"] = runs
    res["launches"] = dict(LAUNCHES)
    return res


LAYOUT_BATCH = dict(rows=8, cols=5)


def layout_cases(rank, ckpt_dir, leaves):
    """``shard_batch``, ``restore(shardings=...)`` and the activation hook,
    on (data 2, model 2).  ``leaves``: {name: (axes, full
    array)} saved by rank 0 and restored by every rank with the rules'
    shardings."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.collectives import unshard
    from repro_torch.parallel.sharding import (RULES_TRAIN, constrain,
                                               model_sharder,
                                               set_activation_sharder)

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {"coord": (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))}
    rows, cols = LAYOUT_BATCH["rows"], LAYOUT_BATCH["cols"]
    batch = {"tokens": np.arange(rows * cols, dtype=np.int32).reshape(
        rows, cols), "odd": np.arange(3 * 2, dtype=np.float32).reshape(3, 2)}
    res["batch"] = {k: _np(v) for k, v in
                    shard_batch(batch, mesh, RULES_TRAIN, "cpu").items()}
    ck = Checkpointer(ckpt_dir, async_save=False)
    whole = {k: torch.from_numpy(v) for k, (_, v) in leaves.items()}
    if rank == 0:
        ck.save(7, whole)
    dist.barrier()
    sh = {k: RULES_TRAIN.sharding_for(axes, v.shape, mesh)
          for k, (axes, v) in leaves.items()}
    got = ck.restore(7, whole, shardings=sh, device="cpu")
    res["restored"] = {k: _np(v) for k, v in got.items()}
    res["specs"] = {k: v.spec for k, v in sh.items()}
    res["roundtrip"] = all(
        torch.equal(unshard(got[k], mesh, sh[k].placements), whole[k])
        for k in whole)
    one = RULES_TRAIN.sharding_for((), (), mesh)    # one for every leaf
    res["one_sharding"] = all(
        torch.equal(v, whole[k]) for k, v in ck.restore(
            7, whole, shardings=one, device="cpu").items())
    x = torch.as_tensor(res["batch"]["tokens"])     # this rank's rows
    with set_activation_sharder(mesh, ("data",)) as sh:
        res["constrain"] = (constrain(x, ("batch", None)) is x,
                            model_sharder() is sh, sh.rows)
    return res


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = dict(seq_len=32, global_batch=8)
KEPT_STEPS = (0, 2)         # the weights kept after the first and last step


def _model(cfg_kw, params):
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    cfg = dataclasses.replace(reduced_config(get_config("llama3.2-1b")),
                              **cfg_kw)
    model = build_model(cfg, device="cpu")
    params_from_jax(params, model)
    return cfg, model


def _tcfg(**kw):
    from repro_torch.train.trainer import TrainerConfig
    return TrainerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10, **kw)


def _state(model, tcfg):
    from repro_torch.models.convert import master_params
    from repro_torch.train.trainer import TrainState, make_optimizer
    p = master_params(model)
    return TrainState(params=p, opt=make_optimizer(tcfg).init(p),
                      step=torch.zeros((), dtype=torch.int32))


def _data(cfg):
    from repro_torch.data.pipeline import SyntheticLMData
    return SyntheticLMData(vocab_size=cfg.vocab_size, **TRAIN)


def train_cases(rank, params):
    """The sharded step on (data 2, model 2), fp32 and bf16, beside the
    one-rank step on rank 0."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainer import (make_train_step, place_state,
                                           state_shardings, unshard_state)

    res = {}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for dtype in ("float32", "bfloat16"):
        cfg, model = _model(dict(dtype="float32"), params)
        tcfg = _tcfg(compute_dtype=dtype)
        data = _data(cfg)
        sh = state_shardings(model, mesh)
        state = place_state(_state(model, tcfg), sh)
        step = make_train_step(model, tcfg, mesh, sh)
        losses, norms, kept = [], [], []
        for i in range(3):
            state, m = step(state, data.batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i in KEPT_STEPS:          # the whole weights (a collective)
                whole = unshard_state(state, sh).params
                kept.append({k: _np(v) for k, v in whole.items()}
                            if rank == 0 else None)
        res[dtype] = {"loss": losses, "grad_norm": norms, "params": kept}
        if rank == 0:                    # the one-rank step, same inputs
            one = make_train_step(model, tcfg)
            s1 = _state(model, tcfg)
            row = {"loss": [], "lr": [], "params": [], "mu": []}
            for i in range(3):
                s1, m = one(s1, data.batch_at(i))
                row["loss"].append(float(m["loss"]))
                if i in KEPT_STEPS:
                    row["lr"].append(float(m["lr"]))
                    row["params"].append(
                        {k: _np(v) for k, v in s1.params.items()})
                    row["mu"].append(
                        {k: _np(v) for k, v in s1.opt.mu.items()})
            res[dtype]["one_rank"] = row

    return res


def pod_cases(rank, params, ckpt_dir):
    """The compressed cross-pod mean and step on (pod 2, data 1, model 2),
    then the elastic run."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.grad_compress import (CompressionState,
                                                 compressed_cross_pod_mean)
    from repro_torch.train.trainer import (init_compression_errors,
                                           make_train_step,
                                           make_train_step_compressed)

    res = {}
    # compressed cross-pod mean on a pod axis of 2
    pmesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    pod = pmesh.get_local_rank("pod")
    g = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    err = np.random.default_rng(1).standard_normal((2, 64)).astype(
        np.float32) * 0.01
    mean, st = compressed_cross_pod_mean(
        {"w": torch.from_numpy(g[pod])},
        CompressionState(error={"w": torch.from_numpy(err[pod])}),
        pmesh.get_group("pod"))
    res["compress"] = {"pod": pod, "mean": _np(mean["w"]),
                       "err": _np(st.error["w"])}

    # the compressed step against the exact one
    cfg, model = _model(dict(dtype="float32"), params)
    tcfg = _tcfg(compute_dtype="float32")
    tcfg = type(tcfg)(**{**tcfg.__dict__, "total_steps": 20})
    data = _data(cfg)
    state_c = _state(model, tcfg)
    errs = init_compression_errors(model, pmesh, 2, device="cpu")
    step_c = make_train_step_compressed(model, tcfg, pmesh)
    exact = make_train_step(model, tcfg)
    state_r = _state(model, tcfg)
    lc, lr = [], []
    for i in range(6):
        batch = data.batch_at(i)
        state_c, errs, mc = step_c(state_c, errs, batch)
        state_r, mr = exact(state_r, batch)
        lc.append(float(mc["loss"]))
        lr.append(float(mr["loss"]))
    res["compressed_step"] = {"loss": lc, "exact": lr}
    res["elastic"] = elastic_case(rank, params, ckpt_dir)
    return res


def elastic_case(rank, params, ckpt_dir):
    from repro_torch.train.elastic import ElasticConfig, ElasticTrainer

    cfg, model = _model(dict(dtype="float32"), params)
    tcfg = _tcfg(compute_dtype="float32")
    tcfg = type(tcfg)(**{**tcfg.__dict__, "total_steps": 20})
    et = ElasticTrainer(model, tcfg,
                        ElasticConfig(data_shards=4, model_shards=1,
                                      checkpoint_every=5,
                                      checkpoint_dir=ckpt_dir),
                        _data(cfg), failure_schedule={7: 2}, device="cpu")
    state, history = et.run(12)
    return {"events": et.events,
            "step": None if state is None else int(state.step),
            "loss": [h["loss"] for h in history]}


FAMILIES = {
    # name: (config, moe_impl, data kwargs)
    "moe-dense": ("granite-moe-3b-a800m", "dense", {}),
    "moe-dropless": ("granite-moe-3b-a800m", "dropless", {}),
    "moe-ep": ("granite-moe-3b-a800m", "ep", {}),
    "mla": ("deepseek-v2-lite-16b", None, {}),
    "hybrid": ("jamba-v0.1-52b", None, {}),
    "mqa-gelu": ("granite-20b", None, {}),
    "qkv-bias": ("qwen2-72b", None, {}),
    "vlm": ("llava-next-34b", None, dict(image_patches=4)),
    "encdec": ("whisper-small", None, dict(encdec=True, dec_len=8)),
}


def family_cases(rank, names):
    """The sharded step of each family's reduced config (fp32, random
    weights from seed 0) on (data 2, model 2), 2 steps of 4 rows, and on
    rank 0 the one-rank step on the same batches."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.trainer import (make_train_step, place_state,
                                           state_shardings)

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    for name in names:
        config, impl, kw = FAMILIES[name]
        cfg = dataclasses.replace(reduced_config(get_config(config)),
                                  dtype="float32")
        model = build_model(cfg, device="cpu", moe_impl=impl,
                            generator=torch.Generator().manual_seed(0))
        tcfg = _tcfg(compute_dtype="float32")
        data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16,
                               global_batch=4, d_model=cfg.d_model, **kw)
        sh = state_shardings(model, mesh)
        step = make_train_step(model, tcfg, mesh, sh)
        state = place_state(_state(model, tcfg), sh)
        row = {"loss": [], "aux": []}
        for i in range(2):
            state, m = step(state, data.batch_at(i))
            row["loss"].append(float(m["loss"]))
            row["aux"].append(float(m["aux_loss"]))
        if rank == 0:
            one, s1 = make_train_step(model, tcfg), _state(model, tcfg)
            row["one_rank"], row["one_aux"] = [], []
            for i in range(2):
                s1, m = one(s1, data.batch_at(i))
                row["one_rank"].append(float(m["loss"]))
                row["one_aux"].append(float(m["aux_loss"]))
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------


def moe_inputs(E):
    """The weights and input of the reference's
    ``test_ep_moe_matches_dense``."""
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((32, E)) * 0.1,
         "we_gate": rng.standard_normal((E, 32, 64)) * 0.1,
         "we_up": rng.standard_normal((E, 32, 64)) * 0.1,
         "we_down": rng.standard_normal((E, 64, 32)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, rng.standard_normal((4, 16, 32)).astype(np.float32)


def moe_cfg(E):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    return ModelConfig(name="t", family="moe", num_layers=2, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                       moe=MoEConfig(num_experts=E, top_k=2, d_ff_expert=64))


def ep_cases(rank, shape):
    import types

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import set_activation_sharder

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    for E in (8, 6):
        cfg = moe_cfg(E)
        p, x = moe_inputs(E)
        w = types.SimpleNamespace(**{k: torch.from_numpy(v).requires_grad_()
                                     for k, v in p.items()})
        with set_activation_sharder(mesh):
            y, aux = L.moe_apply_dropless_ep(cfg, w, torch.from_numpy(x),
                                             capacity_factor=4.0)
        grads = torch.autograd.grad(y.sum(), [w.router, w.we_gate, w.we_up,
                                              w.we_down])
        out[E] = {"y": _np(y), "aux": float(aux),
                  "grads": [_np(g) for g in grads]}
    return out


def _fake_entry(rank, out_dir):
    """Both production meshes on a 512-rank fake process group (one
    process, no communication)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh, mesh_shape
    from repro_torch.parallel.sharding import RULES_TRAIN

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    single = make_production_mesh(device="cpu")
    multi = make_production_mesh(multi_pod=True, device="cpu")
    sh = RULES_TRAIN.sharding_for(("batch", "embed"), (512, 128), multi)
    out = {"single": mesh_shape(single), "multi": mesh_shape(multi),
           "spec_single": RULES_TRAIN.spec_for(("batch", "embed"),
                                               (512, 128), single),
           "spec_multi": sh.spec, "placements": [str(p) for p in
                                                 sh.placements],
           "local_multi": tuple(sh.place(torch.zeros(512, 128)).shape)}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, "fake.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_fake_mesh(tmp_dir: str) -> dict:
    mp.start_processes(_fake_entry, args=(tmp_dir,), nprocs=1, join=True,
                       start_method="spawn")
    with open(os.path.join(tmp_dir, "fake.pkl"), "rb") as f:
        return pickle.load(f)
