"""The sharded train step across the model families, on four CPU
``gloo`` ranks, (data 2, model 2): each family's reduced config (fp32,
random weights from seed 0), 2 steps of ``SyntheticLMData(seq_len=16,
global_batch=4)``, against the one-rank port step on the same batches
(held against the reference by ``test_torch_trainer.py``).

Every family's losses and MoE aux within 1e-5 relative of the one-rank
step: MoE dense and dropless (each rank's rows gathered for the routing,
whose capacity and aux are the whole batch's), MLA, the SSM hybrid,
granite-20b's multi-query GELU (its one KV head projected whole on every
rank), qwen2's QKV biases, llava with image patches and whisper's
encoder-decoder (every weight gathered: no tensor-parallel layer).  The
expert-parallel dispatch (``moe-ep``) gives each data rank its own
capacity buffers, so its drops, and its loss, differ from the global
dispatch's, as the reference documents: within 1e-3 relative.
"""
import numpy as np
import pytest

import torch_multicard_cases as C


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    res = C.run_world(C.family_cases, 4, str(tmp_path_factory.mktemp("fam")),
                      list(C.FAMILIES))
    return res


@pytest.mark.parametrize("name", list(C.FAMILIES))
def test_sharded_step_matches_one_rank(world, name):
    row = world[0][name]
    for r in world:
        assert r[name]["loss"] == row["loss"], name
    assert np.isfinite(row["loss"]).all()
    rtol = 1e-3 if name == "moe-ep" else 1e-5
    np.testing.assert_allclose(row["loss"], row["one_rank"], rtol=rtol,
                               atol=0)
    np.testing.assert_allclose(row["aux"], row["one_aux"], rtol=rtol,
                               atol=1e-7)
