"""The rows decoding a live request over the rows each batched decode
launched (the whole batch), in percent: ``engine/fill/decode/*``."""
from perfbench.phases import fill_share


def read(w):
    return fill_share(w, "decode")
