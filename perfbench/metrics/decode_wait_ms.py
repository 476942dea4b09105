"""Mean host time the batched decode waits for the device: the engine's
``sample`` span inside ``decode`` (the argmax and the copies to the
host)."""
from perfbench.phases import span_mean_ms


def read(w):
    return span_mean_ms(w, lambda path: path == "step/decode/sample")
