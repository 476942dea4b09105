"""Mean host time of a chunked-prefill launch: the engine's
``prefill_chunk`` spans, which end after the chunk's token is copied to
the host, so its device time is inside."""
from perfbench.phases import span_mean_ms


def read(w):
    return span_mean_ms(
        w, lambda path: path.rsplit("/", 1)[-1] == "prefill_chunk")
