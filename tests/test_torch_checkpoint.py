"""The port's ``Checkpointer`` against the reference's on-disk format (CPU).

Round trip, asynchronous save, retention, no ``.tmp`` left, a missing
leaf raising, and the multi-card ``shardings`` refused; then a
``TrainState`` of the reduced ``llama3.2-1b`` (the same weights in both
packages, one AdamW step taken) written by the port and restored by the
reference's ``Checkpointer`` into an equal reference ``TrainState``, and
the reverse, with the two manifests' leaf names, shapes and dtypes equal.
Values compare exactly; a restored state's next step gives the loss of
the uninterrupted run exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.train import trainer as JT
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.convert import master_params
from repro_torch.train import trainer as TT
from repro_torch.utils.tree import leaves_with_paths
from torch_twins import twin


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(rng.standard_normal((4, 4)),
                                         dtype=torch.float32),
                       "b": torch.tensor(rng.standard_normal(4),
                                         dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


def test_save_restore_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    state = _state()
    ckpt.save(7, state)
    restored = ckpt.restore(7, state, device="cpu")
    _equal(state, restored)
    assert restored["step"].shape == () and restored["step"].dtype == \
        torch.int32


def test_async_save_then_wait(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    state = _state()
    ckpt.save(1, state)
    ckpt.wait()
    assert ckpt.latest_step() == 1
    _equal(state, ckpt.restore(1, state, device="cpu"))


def test_retention_keeps_newest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _state())
    assert ckpt.steps() == [3, 4]


def test_no_tmp_dirs_left(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(5, _state())
    ckpt.wait()
    assert not list(tmp_path.glob("*.tmp"))
    assert ckpt.save_seconds and ckpt.steps() == [5]


def test_restore_missing_leaf_raises_and_shardings_place(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    state = _state()
    ckpt.save(3, state)
    bigger = dict(state, params=dict(state["params"], extra=torch.zeros(3)))
    with pytest.raises(KeyError):
        ckpt.restore(3, bigger, device="cpu")
    # each leaf goes through its sharding's ``place`` (here a stand-in
    # that keeps the first row; the mesh case runs in
    # test_torch_multicard.py)
    def cut(t):
        return t[:1] if t.dim() else t
    first = type("FirstRow", (), {"place": staticmethod(cut)})()
    got = ckpt.restore(3, state, shardings=first, device="cpu")
    for (p, a), (_, b) in zip(leaves_with_paths(got),
                              leaves_with_paths(state)):
        assert torch.equal(a, cut(b)), p
    with pytest.raises(TypeError):
        ckpt.save(4, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def _train_states():
    """One AdamW step of the reduced llama3.2-1b in both packages, from
    the same weights: (port state, reference state)."""
    cfg, jm, jp, tm = twin("llama3.2-1b", True)
    tcfg = TT.TrainerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                            compute_dtype="float32")
    jtcfg = JT.TrainerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                             compute_dtype="float32")
    batch = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=17,
                            global_batch=2).batch_at(0)
    p = master_params(tm)
    tstate = TT.TrainState(p, TT.make_optimizer(tcfg).init(p),
                           torch.zeros((), dtype=torch.int32))
    tstate, _ = TT.make_train_step(tm, tcfg)(tstate, batch)
    params = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    jstate = JT.TrainState(params, JT.make_optimizer(jtcfg).init(params),
                           jnp.zeros((), jnp.int32))
    jstate, _ = jax.jit(JT.make_train_step(jm, jtcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return tstate, jstate


def _manifest(root, step):
    d = next(root.glob(f"step_{step:08d}"))
    return json.loads((d / "manifest.json").read_text())


def test_checkpoints_cross_packages(tmp_path):
    tstate, jstate = _train_states()
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    ours = Checkpointer(str(tmp_path / "port"), async_save=True)
    ref = JCheckpointer(str(tmp_path / "ref"), async_save=False)
    ours.save(1, tstate)
    ours.wait()
    ref.save(1, jstate)
    # the same leaf names, shapes and dtypes on disk
    mo, mr = _manifest(tmp_path / "port", 1), _manifest(tmp_path / "ref", 1)
    assert mo == mr
    assert "params__SLASH__blocks__SLASH__0__SLASH__attn__SLASH__wq" in \
        mo["leaves"]
    assert {"opt__SLASH__count", "step"} <= set(mo["leaves"])
    # the port's checkpoint restores in the reference ...
    back = JCheckpointer(str(tmp_path / "port")).restore(1, jstate)
    assert type(back) is JT.TrainState
    _equal(back, tstate)
    # ... and the reference's in the port
    ours_back = Checkpointer(str(tmp_path / "ref")).restore(1, tstate,
                                                             device="cpu")
    assert type(ours_back) is TT.TrainState
    _equal(ours_back, jax.device_get(jstate))


def test_restored_state_reruns_the_same_step(tmp_path):
    """Save at step 2 through ``Trainer.fit``, restore into a fresh state,
    rerun step 3: the loss of the uninterrupted run, exactly."""
    cfg, _, _, tm = twin("llama3.2-1b", True)
    tcfg = TT.TrainerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10,
                            compute_dtype="float32")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=17,
                           global_batch=4)
    ckpt = Checkpointer(str(tmp_path), keep=1)
    state = TT.init_train_state(tm, torch.Generator().manual_seed(0), tcfg)
    trainer = TT.Trainer(tm, tcfg, checkpointer=ckpt, log_every=0)
    _, hist = trainer.fit(state, data.iterator(), 3, checkpoint_every=2)
    ckpt.wait()
    assert ckpt.steps() == [2]
    fresh = TT.init_train_state(tm, torch.Generator().manual_seed(1), tcfg)
    restored = ckpt.restore(2, fresh, device="cpu")
    assert int(restored.step) == 2
    _, again = TT.Trainer(tm, tcfg, log_every=0).fit(
        restored, data.iterator(start_step=2), 1)
    assert again[0]["loss"] == hist[2]["loss"]
