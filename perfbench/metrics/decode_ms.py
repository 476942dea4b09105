"""Mean host time of the engine's batched decode call over the window
(``engine/decode_ms``: its sum over its count)."""


def read(w):
    n, s = w.hist("engine/decode_ms")
    return s / n if n > 0 else None
