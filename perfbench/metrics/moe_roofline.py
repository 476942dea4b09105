"""The least time of the window's routed-expert work over the device time
of the grouped GEMM kernels that run it.

The launches come from the benchmark's own record of the window's steps
(``harness.Req``): a descriptor launch in the step after requests were
sent (their prompt tokens, through the first ``k_layers`` layers); the
paged prefill chunks, each row advancing ``prefill_chunk`` tokens a step
and its last chunk in the step of its first token; one decode launch a
step over the rows that decode in it (both through every layer).  Each
MoE layer of each launch of n real tokens needs at least max(its FLOPs /
989e12, its bytes / 3.35e12) seconds (``moe_flops``, ``moe_bytes`` of the
configuration's reference module: 6 D Fe k FLOPs a token; min(E, n k)
experts' weights read once and each token read and written).  Pad rows
and pad tokens are not counted.  A configuration whose module has no
``moe_flops``, or a trace with no grouped GEMM kernel, reads None."""
from collections import Counter

from perfbench import family as F
from perfbench.work import PEAK_BYTES, PEAK_FLOPS

# the grouped GEMM's kernels, by a part of their name: torch._grouped_mm's
# CUTLASS GEMM (its problem shape type) and the kernel that prepares its
# per-group pointers
GROUPED = ("GroupProblemShape", "prepare_grouped_gemm_data")


def launches(w):
    """[(layers, tokens)] of the window's launches (steps s0 + 1 .. s1)."""
    lo, hi = w.s0, w.s1
    C = int(w.config["serving"]["prefill_chunk"])
    desc, chunk, dec = Counter(), Counter(), Counter()
    for r in w.reqs:
        if lo < r.submit_step + 1 <= hi:
            desc[r.submit_step + 1] += r.prompt_len
        if r.tokens is None or r.source != "cloud":
            continue
        p, S = r.first_step, r.prompt_len
        n = -(-S // C)
        for j in range(n):
            if lo < p - n + 1 + j <= hi:
                chunk[p - n + 1 + j] += min(C, S - j * C)
        for j in range(max(0, lo + 1 - p), min(len(r.tokens) - 1,
                                                hi - p + 1)):
            dec[p + j] += 1
    L = w.spec["num_layers"]
    return ([(min(w.k_layers, L), n) for n in desc.values()]
            + [(L, n) for c in (chunk, dec) for n in c.values()])


def least_s(w, ref) -> float:
    total = 0.0
    for layers, n in launches(w):
        for i in range(layers):
            total += max(ref.moe_flops(w.spec, i, n) / PEAK_FLOPS,
                         ref.moe_bytes(w.spec, i, n) / PEAK_BYTES)
    return total


def read(w):
    ref = F.of(w.spec)
    if w.device_events is None or not hasattr(ref, "moe_flops"):
        return None
    t = sum(b - a for n, a, b in w.device_events
            if any(g in n for g in GROUPED))
    if t <= 0:
        return None
    return least_s(w, ref) / t * 100.0
