"""The prompt tokens of the window's descriptor launches over the slots of
their padded batches (pow2 rows x the longest prompt's pow2 bucket), in
percent: ``engine/fill/descriptor/*``."""
from perfbench.phases import fill_share


def read(w):
    return fill_share(w, "descriptor")
