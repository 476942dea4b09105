"""The control on the card, at the cell's own size and load (a short
window): the program reads at or under each of the configuration's limits,
and the fp8 control over the limit of ``descriptor_dist_max``, the number
that separates the two by twenty times (its widest served gap lies about
twice the program's highest: over its limit, but too close for a limit set
between the two).  Run on the card:

    python -m pytest -q --noconftest -m gpu perfbench/tests/test_perfbench_control.py
"""
import pytest

WORKLOADS = ("granite20b-unique",)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limit(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    from perfbench import control
    from perfbench import harness as H
    from repro_torch.kernels import build_all

    build_all()
    _, config, _ = H.cell_files(H.load_bench(), workload)
    lim = config["check"]
    [row] = control.readings(workload, [2 ** 31 + 5], seconds=5.0)
    assert row["served_tokens_checked"] > 0
    assert row["hit_token_mismatches"] == 0
    assert row["miss_sim_max"] <= config["coic"]["threshold"], row
    assert row["served_gap_max"] <= lim["served_gap_max"], row
    assert row["descriptor_dist_max"] <= lim["descriptor_dist_max"] \
        < row["control_descriptor_dist_max"], row
