"""Mean host time to issue the batched decode: the engine's ``forward``
span inside ``decode`` (the model call returns once its kernels are
queued; the wait for them is ``decode_wait_ms``)."""
from perfbench.phases import span_mean_ms


def read(w):
    return span_mean_ms(w, lambda path: path == "step/decode/forward")
