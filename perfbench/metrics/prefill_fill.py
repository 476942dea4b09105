"""The prompt tokens of the window's prefill launches (chunked or whole)
over the slots of the padded shapes they ran (rows x width), in percent:
``engine/fill/prefill/*``."""
from perfbench.phases import fill_share


def read(w):
    return fill_share(w, "prefill")
