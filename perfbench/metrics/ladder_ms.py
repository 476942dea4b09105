"""Mean, over the window's steps that had arrivals, of the CoIC ladder's
host time in that step: the engine's ``descriptor`` span (the first
k_layers, ending in a device sync) plus its ``lookup`` span."""
import bisect


def read(w):
    if w.spans is None:
        return None
    per_step = {}
    for path, a, b in w.spans.closed:
        if path.rsplit("/", 1)[-1] in ("descriptor", "lookup") \
                and w.T0 <= a and b <= w.T1:
            k = bisect.bisect_left(w.step_end, b)
            per_step[k] = per_step.get(k, 0.0) + (b - a)
    if not per_step:
        return None
    return sum(per_step.values()) / len(per_step) * 1e3
